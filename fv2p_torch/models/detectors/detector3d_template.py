"""Config-driven detector assembly (counterpart of
``fv2p_tpu/models/detectors/detector3d_template.py``), restricted to the
detectors and modules ported so far: FV2P, MGAF-3DSSD, SECOND and
PointPillar (with the single or the multihead anchor head), PV-RCNN,
Voxel R-CNN, PointRCNN and PartA2 (PartA2_free is PointRCNN's detector
over PartA2's modules), inference and training: every yaml under
``tools/cfgs/*_models/`` builds.

Each of the 9 slots of the module topology is built iff its config key
exists, and the forward runs the built slots in that order on one batch
dict of tensors. In eval mode it then post-processes into fixed-shape
(B, post_max) outputs; in train mode it skips post-processing, keeps
autograd on, and each head leaves its targets and predictions for
``compute_training_loss``. A slot module or detector that the port does
not have raises NotImplementedError naming it."""
import torch
from torch import nn

from ...utils import tracing
from ..model_utils import model_nms_utils
from ..backbones_2d.base_bev_backbone import (BaseBEVBackbone, DCNBEVBackbone,
                                              out_channels as bev_out_channels)
from ..backbones_2d.map_to_bev.height_compression import HeightCompression
from ..backbones_2d.map_to_bev.pointpillar_scatter import PointPillarScatter
from ..backbones_3d.pfe.residual_v2p_decoder import ResidualVoxelToPointDecoder
from ..backbones_3d.pfe.voxel_set_abstraction import VoxelSetAbstraction
from ..backbones_3d.pointnet2_backbone import PointNet2MSG
from ..backbones_3d.spconv_backbone import BACKBONES
from ..backbones_3d.spconv_unet import UNetV2
from ..backbones_3d.vfe.mean_vfe import MeanVFE
from ..backbones_3d.vfe.pillar_vfe import PillarVFE
from ..dense_heads.anchor_head import AnchorHeadSingle, anchor_head_loss
from ..dense_heads.anchor_head_multi import AnchorHeadMulti, anchor_head_multi_loss
from ..dense_heads.center_af_head import CenterAFHeadSingle, center_af_head_loss
from ..dense_heads.point_head_box import PointHeadBox, point_head_box_loss
from ..dense_heads.point_head_simple import PointHeadSimple, point_head_loss
from ..dense_heads.point_intra_part_head import (PointIntraPartOffsetHead,
                                                 point_intra_part_head_loss)
from ..roi_heads.iouguided_roi_head import IoUGuidedRoIHead, roi_head_loss
from ..roi_heads.partA2_head import PartA2FCHead, parta2_head_loss
from ..roi_heads.pointrcnn_head import PointRCNNHead, pointrcnn_head_loss
from ..roi_heads.pvrcnn_head import PVRCNNHead, pvrcnn_head_loss
from ..roi_heads.voxelrcnn_head import VoxelRCNNHead, voxelrcnn_head_loss

MODULE_TOPOLOGY = ['vfe', 'backbone_3d', 'map_to_bev_module', 'pfe',
                   'backbone_2d', 'dense_head', 'post_pfe', 'point_head',
                   'roi_head']
_SLOT_SPANS = tuple((slot, f'slot:{slot}') for slot in MODULE_TOPOLOGY)

# each slot's config key and the ported modules it may name
_SLOT_KEYS = {'vfe': 'VFE', 'backbone_3d': 'BACKBONE_3D',
              'map_to_bev_module': 'MAP_TO_BEV', 'pfe': 'PFE',
              'backbone_2d': 'BACKBONE_2D', 'dense_head': 'DENSE_HEAD',
              'post_pfe': 'POST_PFE', 'point_head': 'POINT_HEAD',
              'roi_head': 'ROI_HEAD'}
_PORTED = {'VFE': ('MeanVFE', 'PillarVFE'),
           'BACKBONE_3D': ('VoxelResBackBone8x', 'VoxelBackBone8x', 'PointNet2MSG', 'UNetV2'),
           'MAP_TO_BEV': ('HeightCompression', 'PointPillarScatter'),
           'PFE': ('VoxelSetAbstraction',),
           'BACKBONE_2D': ('BaseBEVBackbone', 'DCNBEVBackbone'),
           'DENSE_HEAD': ('AnchorHeadSingle', 'AnchorHeadMulti', 'CenterAFHeadSingle'),
           'POST_PFE': ('ResidualVoxelToPointDecoder',),
           'POINT_HEAD': ('PointHeadSimple', 'PointHeadBox', 'PointIntraPartOffsetHead'),
           'ROI_HEAD': ('IoUGuidedRoIHead', 'PVRCNNHead', 'VoxelRCNNHead', 'PointRCNNHead',
                        'PointRCNNIoUHead', 'PartA2FCHead')}


def _not_ported(what):
    return NotImplementedError(f'{what} is not in fv2p_torch (no yaml under tools/cfgs '
                               'names it)')


class Detector3DTemplate(nn.Module):
    """Builds the slots its config names; eval-mode forward through them,
    then ``final_predictions``: IoU-score-ranked NMS
    (``post_processing_withfgscores``) for FV2P and MGAF-3DSSD, cls-score
    NMS (``post_processing``) for SECOND, PointPillar, PV-RCNN, Voxel
    R-CNN, PointRCNN and PartA2."""

    def __init__(self, model_cfg, num_class, class_names, dataset_meta,
                 compute_dtype=None):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_class = num_class
        self.class_names = list(class_names)
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
        return bev_out_channels(self.model_cfg.BACKBONE_2D)

    def _build_vfe(self):
        cfg, meta = self.model_cfg.VFE, self.dataset_meta
        if cfg.NAME == 'PillarVFE':
            return PillarVFE(cfg, meta['num_point_features'], meta['voxel_size'],
                             meta['point_cloud_range'])
        return MeanVFE()

    def _build_backbone_3d(self):
        cfg, meta = self.model_cfg.BACKBONE_3D, self.dataset_meta
        if cfg.NAME == 'PointNet2MSG':
            return PointNet2MSG(cfg, meta['num_point_features'])
        if cfg.NAME == 'UNetV2':
            return UNetV2(cfg, meta['num_point_features'], meta['grid_size'],
                          meta['voxel_size'], meta['point_cloud_range'], self.compute_dtype)
        return BACKBONES[cfg.NAME](meta['num_point_features'], meta['grid_size'], self.compute_dtype,
                   level_caps=cfg.get('LEVEL_CAPACITIES'))

    def _build_map_to_bev_module(self):
        if self.model_cfg.MAP_TO_BEV.NAME == 'PointPillarScatter':
            return PointPillarScatter(self.dataset_meta['grid_size'])
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
        if cfg.NAME == 'AnchorHeadMulti':
            return AnchorHeadMulti(cfg, self._bev_out_channels(), self.num_class,
                                   self.class_names, meta['grid_size'],
                                   meta['point_cloud_range'], self.compute_dtype)
        return CenterAFHeadSingle(cfg, self._bev_out_channels(), self.num_class,
                                  meta['voxel_size'], meta['point_cloud_range'],
                                  self.compute_dtype)

    def _build_pfe(self):
        meta = self.dataset_meta
        return VoxelSetAbstraction(
            self.model_cfg.PFE, meta['voxel_size'], meta['point_cloud_range'],
            int(self.model_cfg.MAP_TO_BEV.NUM_BEV_FEATURES), meta['num_point_features'],
            self.backbone_3d.level_channels)

    def _build_post_pfe(self):
        meta = self.dataset_meta
        return ResidualVoxelToPointDecoder(
            self.model_cfg.POST_PFE, tuple(meta['voxel_size']),
            tuple(meta['point_cloud_range']), self.compute_dtype)

    def _point_channels(self, before_fusion=False):
        """The width of ``point_features`` (or of the PFE's
        ``point_features_before_fusion``)."""
        if 'POST_PFE' in self.model_cfg:
            return int(self.model_cfg.POST_PFE.OUT_BLOCK.OUT_CHANNELS)
        if before_fusion:
            return self.pfe.num_point_features_before_fusion
        return self.pfe.num_point_features

    def _build_point_head(self):
        cfg = self.model_cfg.POINT_HEAD
        if cfg.NAME == 'PointHeadBox':
            return PointHeadBox(cfg, self.backbone_3d.num_point_features, self.num_class)
        if cfg.NAME == 'PointIntraPartOffsetHead':
            return PointIntraPartOffsetHead(cfg, self.backbone_3d.num_point_features,
                                            self.num_class)
        before = cfg.get('USE_POINT_FEATURES_BEFORE_FUSION', False)
        return PointHeadSimple(cfg, self._point_channels(before), self.num_class,
                               self.compute_dtype)

    def _build_roi_head(self):
        cfg, meta = self.model_cfg.ROI_HEAD, self.dataset_meta
        roi_classes = 1 if cfg.get('CLASS_AGNOSTIC', True) else self.num_class
        if cfg.NAME == 'PVRCNNHead':
            return PVRCNNHead(cfg, roi_classes, self._point_channels())
        if cfg.NAME in ('PointRCNNHead', 'PointRCNNIoUHead'):
            # one module for both: TARGET_CONFIG.CLS_SCORE_TYPE selects the
            # rcnn_iou labels
            return PointRCNNHead(cfg, roi_classes, self.backbone_3d.num_point_features)
        if cfg.NAME == 'PartA2FCHead':
            return PartA2FCHead(cfg, roi_classes, self.backbone_3d.num_point_features)
        if cfg.NAME == 'VoxelRCNNHead':
            return VoxelRCNNHead(cfg, roi_classes, meta['point_cloud_range'],
                                 meta['voxel_size'], self.backbone_3d.level_channels)
        return IoUGuidedRoIHead(cfg, roi_classes, tuple(meta['point_cloud_range']),
                                tuple(meta['voxel_size']), self._point_channels(),
                                self._bev_out_channels(), self.compute_dtype)

    def _run_slots(self, batch_dict):
        for slot, span_name in _SLOT_SPANS:
            if hasattr(self, slot):
                with tracing.span(span_name):
                    batch_dict = getattr(self, slot)(batch_dict)
        return batch_dict

    def forward(self, batch_dict):
        """Opens a step of ``utils/tracing`` (each slot is a span of it)."""
        tracing.open_step()
        if self.training:
            return self.train_forward(batch_dict)
        with torch.no_grad():
            batch_dict = self._run_slots(batch_dict)
            with tracing.span('slot:post_processing'):
                batch_dict.update(self.final_predictions(batch_dict))
        return batch_dict

    def final_predictions(self, batch_dict):
        return self.post_processing_withfgscores(batch_dict)

    def train_forward(self, batch_dict):
        """The slots in train mode, with autograd and without
        post-processing; ``batch_dict`` needs ``gt_boxes`` (B, M, 8) and may
        carry ``generators`` ({'sampling', 'dropout'}: torch.Generator)."""
        return self._run_slots(batch_dict)

    def post_processing(self, batch_dict):
        """Cls-score NMS: each anchor's best class probability above
        SCORE_THRESH, one NMS a scan; with ``MULTI_CLASSES_NMS`` one NMS a
        scan and class, the classes' kept rows concatenated. Fixed-shape
        (B, post_max), or (B, C * post_max), boxes / scores / labels /
        valid; the boxes keep every column (nuScenes' velocities), the NMS
        reads the first 7."""
        pp = self.model_cfg.POST_PROCESSING
        nms_cfg = pp.NMS_CONFIG
        box_preds = batch_dict['batch_box_preds']              # (B, K, 7 + C)
        cls_preds = batch_dict['batch_cls_preds']              # (B, K, C)
        cls_probs = cls_preds if batch_dict.get('cls_preds_normalized', False) \
            else torch.sigmoid(cls_preds)
        score_thresh = float(pp.SCORE_THRESH)
        if nms_cfg.get('MULTI_CLASSES_NMS', False):
            per_scan = [model_nms_utils.multi_classes_nms(probs, boxes, nms_cfg,
                                                          score_thresh)
                        for probs, boxes in zip(cls_probs, box_preds)]
            boxes, scores, labels, valid = (torch.stack(x) for x in zip(*per_scan))
            return {'pred_boxes': boxes, 'pred_scores': scores,
                    'pred_labels': labels.long(), 'pred_valid': valid}
        scores, labels = cls_probs.max(dim=-1)
        keep = [model_nms_utils.class_agnostic_nms(sc, bx, nms_cfg, score_thresh)
                for sc, bx in zip(scores, box_preds)]
        keep_idx, final_scores, keep_valid = (torch.stack(x) for x in zip(*keep))
        return {
            'pred_boxes': torch.gather(
                box_preds, 1, keep_idx[..., None].expand(-1, -1, box_preds.shape[-1])),
            'pred_scores': final_scores,
            'pred_labels': torch.gather(labels + 1, 1, keep_idx),
            'pred_valid': keep_valid,
        }

    def post_processing_withfgscores(self, batch_dict):
        """IoU-score-ranked NMS with foreground-score filtering; fixed-shape
        (B, post_max) boxes / scores / labels / valid."""
        pp = self.model_cfg.POST_PROCESSING
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

        keep = [model_nms_utils.class_agnostic_nms_withfgscore(
                    fg, loc, bx, pp.NMS_CONFIG, float(pp.SCORE_THRESH))
                for fg, loc, bx in zip(fg_scores, iouscore, box_preds)]
        keep_idx, final_scores, keep_valid = (torch.stack(x) for x in zip(*keep))
        return {
            'pred_boxes': torch.gather(
                box_preds, 1, keep_idx[..., None].expand(-1, -1, box_preds.shape[-1])),
            'pred_scores': final_scores,
            'pred_labels': torch.gather(labels, 1, keep_idx),
            'pred_valid': keep_valid,
        }


class FromVoxelToPoint(Detector3DTemplate):
    """Two-stage IoU-guided detector: anchor RPN -> voxel-to-point decoder
    -> point segmentation head -> IoU-guided RoI head with two-pass
    alignment -> IoU-score-ranked NMS."""


class MGAF3DSSD(Detector3DTemplate):
    """Single-stage anchor-free detector: sparse trunk -> DCN BEV backbone ->
    CenterAF head (max-pool NMS + top-K decode) -> IoU-score-ranked NMS."""


class SECONDNet(Detector3DTemplate):
    """Single-stage anchor-based detector: mean VFE -> plain sparse backbone
    (device rulebooks) -> BEV backbone -> anchor head -> cls-score NMS."""

    def final_predictions(self, batch_dict):
        return self.post_processing(batch_dict)


class PointPillar(SECONDNet):
    """SECOND over pillars: PillarVFE -> scatter onto the BEV canvas -> BEV
    backbone -> anchor head -> cls-score NMS."""


class PVRCNN(Detector3DTemplate):
    """Point-voxel two-stage detector: sparse trunk (device rulebooks) ->
    BEV backbone -> anchor head (proposals) -> voxel set abstraction of FPS
    keypoints -> keypoint segmentation head -> RoI-grid pooling of the
    score-weighted keypoint features -> cls-score NMS."""

    def final_predictions(self, batch_dict):
        return self.post_processing(batch_dict)


class VoxelRCNN(Detector3DTemplate):
    """Voxel two-stage detector: sparse trunk (device rulebooks) -> BEV
    backbone -> anchor head (proposals) -> RoI-grid pooling straight from
    the sparse levels -> cls-score NMS."""

    def final_predictions(self, batch_dict):
        return self.post_processing(batch_dict)


class PointRCNN(Detector3DTemplate):
    """Point-based two-stage detector: PointNet++ MSG backbone on the raw
    points -> point-wise box head (a proposal at every point) -> RoI point
    pooling and an SA encoder over the pooled points -> cls-score NMS."""

    def final_predictions(self, batch_dict):
        return self.post_processing(batch_dict)


class PartA2Net(Detector3DTemplate):
    """Part-aware and part-aggregation two-stage detector: sparse UNet ->
    BEV backbone -> anchor head (proposals) -> intra-object part head ->
    RoI-aware pooling of the part and point features, dense masked 3D
    convs -> cls-score NMS."""

    def final_predictions(self, batch_dict):
        return self.post_processing(batch_dict)


DETECTOR_REGISTRY = {'FromVoxelToPoint': FromVoxelToPoint,
                     'MGAF3DSSD': MGAF3DSSD, 'SECONDNet': SECONDNet,
                     'PointPillar': PointPillar, 'PVRCNN': PVRCNN,
                     'VoxelRCNN': VoxelRCNN, 'PointRCNN': PointRCNN, 'PartA2Net': PartA2Net}


def compute_training_loss(model, batch_dict):
    """The training loss of a train-mode forward's ``batch_dict``: for FV2P
    and PV-RCNN the RPN, point-head and RCNN losses summed, for Voxel
    R-CNN the RPN and RCNN losses, for MGAF-3DSSD the CenterAF head's eight
    terms, for SECOND and PointPillar the RPN loss alone (the multihead's
    own loss with ``AnchorHeadMulti``), for PointRCNN the point head's (the
    box head's, or PartA2_free's part head's) and the RCNN losses, for
    PartA2 the RPN, part-head and RCNN losses.
    Returns (loss, terms), every term a 0-d tensor, ``terms['loss']`` the
    total."""
    cfg = model.model_cfg
    if isinstance(model, MGAF3DSSD):
        rpn_loss, tb = center_af_head_loss(cfg.DENSE_HEAD, batch_dict['head_ret'])
        tb['loss'] = rpn_loss
        return rpn_loss, tb
    if isinstance(model, PointRCNN):
        point_loss_fn = point_intra_part_head_loss \
            if cfg.POINT_HEAD.NAME == 'PointIntraPartOffsetHead' else point_head_box_loss
        point_loss, tb = point_loss_fn(cfg.POINT_HEAD, batch_dict['point_head_ret'])
        rcnn_loss, tb_r = pointrcnn_head_loss(cfg.ROI_HEAD, batch_dict['roi_head_ret'])
        tb.update(tb_r)
        loss = point_loss + rcnn_loss
        tb['loss'] = loss
        return loss, tb
    head = model.dense_head
    if isinstance(head, AnchorHeadMulti):
        rpn_loss, tb = anchor_head_multi_loss(cfg.DENSE_HEAD, batch_dict['anchor_head_ret'],
                                              head.anchors_flat, model.num_class)
        tb['loss'] = rpn_loss
        return rpn_loss, tb
    rpn_loss, tb = anchor_head_loss(cfg.DENSE_HEAD, batch_dict['anchor_head_ret'],
                                    head.anchors_flat, model.num_class)
    if isinstance(model, VoxelRCNN):
        rcnn_loss, tb_r = voxelrcnn_head_loss(cfg.ROI_HEAD, batch_dict['roi_head_ret'])
        tb.update(tb_r)
        loss = rpn_loss + rcnn_loss
        tb['loss'] = loss
        return loss, tb
    if isinstance(model, SECONDNet):
        tb['loss'] = rpn_loss
        return rpn_loss, tb
    if isinstance(model, PartA2Net):
        point_loss, tb_p = point_intra_part_head_loss(cfg.POINT_HEAD,
                                                      batch_dict['point_head_ret'])
        rcnn_fn = parta2_head_loss
    else:
        point_loss, tb_p = point_head_loss(cfg.POINT_HEAD, batch_dict['point_head_ret'])
        rcnn_fn = pvrcnn_head_loss if isinstance(model, PVRCNN) else roi_head_loss
    rcnn_loss, tb_r = rcnn_fn(cfg.ROI_HEAD, batch_dict['roi_head_ret'])
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
