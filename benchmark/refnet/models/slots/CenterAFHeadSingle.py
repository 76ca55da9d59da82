"""The ``DENSE_HEAD`` slot ``CenterAFHeadSingle``."""
from ..backbones_2d.base_bev_backbone import out_channels
from ..dense_heads.center_af_head import CenterAFHeadSingle


def build(det):
    cfg, meta = det.model_cfg.DENSE_HEAD, det.dataset_meta
    return CenterAFHeadSingle(cfg, out_channels(det.model_cfg.BACKBONE_2D), det.num_class,
                              meta['voxel_size'], meta['point_cloud_range'],
                              det.compute_dtype)
