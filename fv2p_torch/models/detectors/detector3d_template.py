"""Config-driven detector assembly (counterpart of
``fv2p_tpu/models/detectors/detector3d_template.py``), restricted to what
FV2P builds.

The 9-slot module topology's order is kept: the forward runs the slots
FV2P builds in that order on one batch dict of tensors, then post-processes
into fixed-shape (B, post_max) outputs."""
import torch
from torch import nn

from ...utils import iou3d
from ..backbones_2d.base_bev_backbone import BaseBEVBackbone
from ..backbones_2d.map_to_bev.height_compression import HeightCompression
from ..backbones_3d.pfe.residual_v2p_decoder import ResidualVoxelToPointDecoder
from ..backbones_3d.spconv_backbone import VoxelResBackBone8x
from ..backbones_3d.vfe.mean_vfe import MeanVFE
from ..dense_heads.anchor_head import AnchorHeadSingle
from ..dense_heads.point_head_simple import PointHeadSimple
from ..roi_heads.iouguided_roi_head import IoUGuidedRoIHead

MODULE_TOPOLOGY = ['vfe', 'backbone_3d', 'map_to_bev_module', 'pfe',
                   'backbone_2d', 'dense_head', 'post_pfe', 'point_head',
                   'roi_head']

# what the port builds so far, per slot; anything else is later work
_PORTED = {'VFE': ('MeanVFE',), 'BACKBONE_3D': ('VoxelResBackBone8x',),
           'MAP_TO_BEV': ('HeightCompression',),
           'BACKBONE_2D': ('BaseBEVBackbone',),
           'DENSE_HEAD': ('AnchorHeadSingle',),
           'POST_PFE': ('ResidualVoxelToPointDecoder',),
           'POINT_HEAD': ('PointHeadSimple',),
           'ROI_HEAD': ('IoUGuidedRoIHead',)}


def _not_ported(what):
    return NotImplementedError(
        f'{what} is not in fv2p_torch yet (ROADMAP.md, queue A: '
        'MGAF-3DSSD inference, training, the rest of the model zoo)')


class FromVoxelToPoint(nn.Module):
    """Two-stage IoU-guided detector: anchor RPN -> voxel-to-point decoder
    -> point segmentation head -> IoU-guided RoI head with two-pass
    alignment -> IoU-score-ranked NMS."""

    def __init__(self, model_cfg, num_class, class_names, dataset_meta,
                 compute_dtype=None):
        super().__init__()
        cfg = model_cfg
        for key, names in _PORTED.items():
            if key in cfg and cfg[key].NAME not in names:
                raise _not_ported(f'{key} {cfg[key].NAME}')
        if 'PFE' in cfg:
            raise _not_ported(f'PFE {cfg.PFE.NAME}')
        self.model_cfg = cfg
        meta = dataset_meta
        pc_range = tuple(meta['point_cloud_range'])
        voxel_size = tuple(meta['voxel_size'])
        cd = compute_dtype

        self.vfe = MeanVFE()
        self.backbone_3d = VoxelResBackBone8x(meta['num_point_features'],
                                              meta['grid_size'], cd)
        self.map_to_bev_module = HeightCompression()
        num_bev = int(cfg.MAP_TO_BEV.NUM_BEV_FEATURES)
        self.backbone_2d = BaseBEVBackbone(cfg.BACKBONE_2D, num_bev, cd)
        bev_cfg = cfg.BACKBONE_2D
        bev_out = int(sum(bev_cfg.get('NUM_UPSAMPLE_FILTERS',
                                      [bev_cfg['NUM_FILTERS'][-1]])))
        self.dense_head = AnchorHeadSingle(
            cfg.DENSE_HEAD, bev_out, num_class, meta['grid_size'], pc_range)
        self.post_pfe = ResidualVoxelToPointDecoder(cfg.POST_PFE, voxel_size,
                                                    pc_range, cd)
        point_ch = int(cfg.POST_PFE.OUT_BLOCK.OUT_CHANNELS)
        self.point_head = PointHeadSimple(cfg.POINT_HEAD, point_ch, num_class, cd)
        roi_classes = 1 if cfg.ROI_HEAD.get('CLASS_AGNOSTIC', True) else num_class
        self.roi_head = IoUGuidedRoIHead(cfg.ROI_HEAD, roi_classes, pc_range,
                                         voxel_size, point_ch, bev_out, cd)

    def module_list(self):
        return [getattr(self, slot) for slot in MODULE_TOPOLOGY
                if hasattr(self, slot)]

    @torch.no_grad()
    def forward(self, batch_dict):
        if self.training:
            raise _not_ported('training')
        for module in self.module_list():
            batch_dict = module(batch_dict)
        batch_dict.update(self.post_processing_withfgscores(batch_dict))
        return batch_dict

    def post_processing_withfgscores(self, batch_dict):
        """IoU-score-ranked NMS with foreground-score filtering; fixed-shape
        (B, post_max) boxes / scores / labels / valid."""
        pp = self.model_cfg.POST_PROCESSING
        nms_cfg = pp.NMS_CONFIG
        box_preds = batch_dict['batch_box_preds']              # (B, K, 7)
        cls_preds = batch_dict['batch_cls_preds']              # (B, K, C)
        iouscore = batch_dict['batch_iouscore_preds'][..., 0]  # (B, K)
        cls_probs = cls_preds if batch_dict.get('cls_preds_normalized', False) \
            else torch.sigmoid(cls_preds)
        fg_scores = cls_probs.amax(dim=-1)
        if batch_dict.get('has_class_labels', False) and 'roi_labels' in batch_dict:
            labels = batch_dict['roi_labels']
        else:
            labels = torch.argmax(cls_probs, dim=-1) + 1

        nms_scores = torch.where(fg_scores >= float(pp.SCORE_THRESH), iouscore,
                                 float('-inf'))
        pre = int(min(nms_cfg.NMS_PRE_MAXSIZE, box_preds.shape[1]))
        post = int(nms_cfg.NMS_POST_MAXSIZE)
        keep = [iou3d.nms_rotated(bx, sc, float(nms_cfg.NMS_THRESH),
                                  pre_max=pre, post_max=post)
                for bx, sc in zip(box_preds, nms_scores)]
        keep_idx = torch.stack([k[0] for k in keep])
        keep_valid = torch.stack([k[1] for k in keep])

        final_boxes = torch.gather(
            box_preds, 1, keep_idx[..., None].expand(-1, -1, box_preds.shape[-1]))
        final_scores = torch.gather(iouscore, 1, keep_idx)
        final_labels = torch.gather(labels, 1, keep_idx)
        return {
            'pred_boxes': final_boxes,
            'pred_scores': torch.where(keep_valid, final_scores, 0.0),
            'pred_labels': final_labels,
            'pred_valid': keep_valid,
        }


DETECTOR_REGISTRY = {'FromVoxelToPoint': FromVoxelToPoint}


def build_detector(model_cfg, num_class, class_names, dataset_meta,
                   compute_dtype=None):
    cls = DETECTOR_REGISTRY.get(model_cfg.NAME)
    if cls is None:
        raise _not_ported(f'detector {model_cfg.NAME}')
    return cls(model_cfg, num_class, class_names, dataset_meta, compute_dtype)
