"""Config-driven detector assembly (counterpart of
``fv2p_tpu/models/detectors/detector3d_template.py``), restricted to the
detectors and modules ported so far: FV2P and MGAF-3DSSD, inference and
training.

Each of the 9 slots of the module topology is built iff its config key
exists, and the forward runs the built slots in that order on one batch
dict of tensors. In eval mode it then post-processes into fixed-shape
(B, post_max) outputs; in train mode it skips post-processing, keeps
autograd on, and each head leaves its targets and predictions for
``compute_training_loss``. A slot or detector that is not ported raises
NotImplementedError naming the ROADMAP queue."""
import torch
from torch import nn

from ...utils import iou3d
from ..backbones_2d.base_bev_backbone import BaseBEVBackbone, DCNBEVBackbone
from ..backbones_2d.map_to_bev.height_compression import HeightCompression
from ..backbones_3d.pfe.residual_v2p_decoder import ResidualVoxelToPointDecoder
from ..backbones_3d.spconv_backbone import VoxelResBackBone8x
from ..backbones_3d.vfe.mean_vfe import MeanVFE
from ..dense_heads.anchor_head import AnchorHeadSingle, anchor_head_loss
from ..dense_heads.center_af_head import CenterAFHeadSingle, center_af_head_loss
from ..dense_heads.point_head_simple import PointHeadSimple, point_head_loss
from ..roi_heads.iouguided_roi_head import IoUGuidedRoIHead, roi_head_loss

MODULE_TOPOLOGY = ['vfe', 'backbone_3d', 'map_to_bev_module', 'pfe',
                   'backbone_2d', 'dense_head', 'post_pfe', 'point_head',
                   'roi_head']

# each slot's config key and the ported modules it may name
_SLOT_KEYS = {'vfe': 'VFE', 'backbone_3d': 'BACKBONE_3D',
              'map_to_bev_module': 'MAP_TO_BEV', 'pfe': 'PFE',
              'backbone_2d': 'BACKBONE_2D', 'dense_head': 'DENSE_HEAD',
              'post_pfe': 'POST_PFE', 'point_head': 'POINT_HEAD',
              'roi_head': 'ROI_HEAD'}
_PORTED = {'VFE': ('MeanVFE',), 'BACKBONE_3D': ('VoxelResBackBone8x',),
           'MAP_TO_BEV': ('HeightCompression',), 'PFE': (),
           'BACKBONE_2D': ('BaseBEVBackbone', 'DCNBEVBackbone'),
           'DENSE_HEAD': ('AnchorHeadSingle', 'CenterAFHeadSingle'),
           'POST_PFE': ('ResidualVoxelToPointDecoder',),
           'POINT_HEAD': ('PointHeadSimple',),
           'ROI_HEAD': ('IoUGuidedRoIHead',)}


def _not_ported(what):
    return NotImplementedError(
        f'{what} is not in fv2p_torch yet (ROADMAP.md, queue A: training, '
        'the runner, multi-GPU, the rest of the model zoo)')


class Detector3DTemplate(nn.Module):
    """Builds the slots its config names; eval-mode forward through them,
    then IoU-score-ranked NMS (``post_processing_withfgscores``), the
    post-processing of both ported detectors."""

    def __init__(self, model_cfg, num_class, class_names, dataset_meta,
                 compute_dtype=None):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_class = num_class
        self.dataset_meta = dataset_meta
        self.compute_dtype = compute_dtype
        for slot in MODULE_TOPOLOGY:
            key = _SLOT_KEYS[slot]
            if key not in model_cfg:
                continue
            if model_cfg[key].NAME not in _PORTED[key]:
                raise _not_ported(f'{key} {model_cfg[key].NAME}')
            setattr(self, slot, getattr(self, f'_build_{slot}')())

    def _bev_out_channels(self):
        bev_cfg = self.model_cfg.BACKBONE_2D
        return int(sum(bev_cfg.get('NUM_UPSAMPLE_FILTERS',
                                   [bev_cfg['NUM_FILTERS'][-1]])))

    def _build_vfe(self):
        return MeanVFE()

    def _build_backbone_3d(self):
        meta = self.dataset_meta
        return VoxelResBackBone8x(meta['num_point_features'], meta['grid_size'],
                                  self.compute_dtype)

    def _build_map_to_bev_module(self):
        return HeightCompression()

    def _build_backbone_2d(self):
        cfg = self.model_cfg
        cls = {'BaseBEVBackbone': BaseBEVBackbone,
               'DCNBEVBackbone': DCNBEVBackbone}[cfg.BACKBONE_2D.NAME]
        return cls(cfg.BACKBONE_2D, int(cfg.MAP_TO_BEV.NUM_BEV_FEATURES),
                   self.compute_dtype)

    def _build_dense_head(self):
        cfg, meta = self.model_cfg.DENSE_HEAD, self.dataset_meta
        if cfg.NAME == 'AnchorHeadSingle':
            return AnchorHeadSingle(cfg, self._bev_out_channels(), self.num_class,
                                    meta['grid_size'], meta['point_cloud_range'])
        return CenterAFHeadSingle(cfg, self._bev_out_channels(), self.num_class,
                                  meta['voxel_size'], meta['point_cloud_range'],
                                  self.compute_dtype)

    def _build_post_pfe(self):
        meta = self.dataset_meta
        return ResidualVoxelToPointDecoder(
            self.model_cfg.POST_PFE, tuple(meta['voxel_size']),
            tuple(meta['point_cloud_range']), self.compute_dtype)

    def _point_channels(self):
        return int(self.model_cfg.POST_PFE.OUT_BLOCK.OUT_CHANNELS)

    def _build_point_head(self):
        return PointHeadSimple(self.model_cfg.POINT_HEAD, self._point_channels(),
                               self.num_class, self.compute_dtype)

    def _build_roi_head(self):
        cfg, meta = self.model_cfg.ROI_HEAD, self.dataset_meta
        roi_classes = 1 if cfg.get('CLASS_AGNOSTIC', True) else self.num_class
        return IoUGuidedRoIHead(cfg, roi_classes, tuple(meta['point_cloud_range']),
                                tuple(meta['voxel_size']), self._point_channels(),
                                self._bev_out_channels(), self.compute_dtype)

    def module_list(self):
        return [getattr(self, slot) for slot in MODULE_TOPOLOGY
                if hasattr(self, slot)]

    def forward(self, batch_dict):
        if self.training:
            return self.train_forward(batch_dict)
        with torch.no_grad():
            for module in self.module_list():
                batch_dict = module(batch_dict)
            batch_dict.update(self.post_processing_withfgscores(batch_dict))
        return batch_dict

    def train_forward(self, batch_dict):
        """The slots in train mode, with autograd and without
        post-processing; ``batch_dict`` needs ``gt_boxes`` (B, M, 8) and may
        carry ``generators`` ({'sampling', 'dropout'}: torch.Generator)."""
        for module in self.module_list():
            batch_dict = module(batch_dict)
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


class FromVoxelToPoint(Detector3DTemplate):
    """Two-stage IoU-guided detector: anchor RPN -> voxel-to-point decoder
    -> point segmentation head -> IoU-guided RoI head with two-pass
    alignment -> IoU-score-ranked NMS."""


class MGAF3DSSD(Detector3DTemplate):
    """Single-stage anchor-free detector: sparse trunk -> DCN BEV backbone ->
    CenterAF head (max-pool NMS + top-K decode) -> IoU-score-ranked NMS."""


DETECTOR_REGISTRY = {'FromVoxelToPoint': FromVoxelToPoint,
                     'MGAF3DSSD': MGAF3DSSD}


def compute_training_loss(model, batch_dict):
    """The training loss of a train-mode forward's ``batch_dict``: for FV2P
    the RPN, point-head and RCNN losses summed, for MGAF-3DSSD the CenterAF
    head's eight terms. Returns (loss, terms), every term a 0-d tensor,
    ``terms['loss']`` the total."""
    cfg = model.model_cfg
    if isinstance(model, MGAF3DSSD):
        rpn_loss, tb = center_af_head_loss(cfg.DENSE_HEAD, batch_dict['head_ret'])
        tb['loss'] = rpn_loss
        return rpn_loss, tb
    head = model.dense_head
    rpn_loss, tb = anchor_head_loss(cfg.DENSE_HEAD, batch_dict['anchor_head_ret'],
                                    head.anchors_flat, model.num_class)
    point_loss, tb_p = point_head_loss(cfg.POINT_HEAD, batch_dict['point_head_ret'])
    rcnn_loss, tb_r = roi_head_loss(cfg.ROI_HEAD, batch_dict['roi_head_ret'])
    tb.update(tb_p)
    tb.update(tb_r)
    loss = rpn_loss + point_loss + rcnn_loss
    tb['loss'] = loss
    return loss, tb


def build_detector(model_cfg, num_class, class_names, dataset_meta,
                   compute_dtype=None):
    cls = DETECTOR_REGISTRY.get(model_cfg.NAME)
    if cls is None:
        raise _not_ported(f'detector {model_cfg.NAME}')
    return cls(model_cfg, num_class, class_names, dataset_meta, compute_dtype)
