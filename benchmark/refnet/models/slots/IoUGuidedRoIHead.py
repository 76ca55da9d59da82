"""The ``ROI_HEAD`` slot ``IoUGuidedRoIHead``, on the decoder's point
features and the BEV backbone's map."""
from ..backbones_2d.base_bev_backbone import out_channels
from ..roi_heads.iouguided_roi_head import IoUGuidedRoIHead


def build(det):
    cfg, meta = det.model_cfg, det.dataset_meta
    roi = cfg.ROI_HEAD
    roi_classes = 1 if roi.get('CLASS_AGNOSTIC', True) else det.num_class
    return IoUGuidedRoIHead(roi, roi_classes, tuple(meta['point_cloud_range']),
                            tuple(meta['voxel_size']),
                            int(cfg.POST_PFE.OUT_BLOCK.OUT_CHANNELS),
                            out_channels(cfg.BACKBONE_2D), det.compute_dtype)
