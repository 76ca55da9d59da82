"""PartA2's part-aggregation RoI head (counterpart of
``fv2p_tpu/models/roi_heads/partA2_head.py``).

The proposals, targets, FC layers, heads and decode are ``RoIFCHead``'s
(``pvrcnn_head.py``: B1 in the proposal NMS and the 3D IoU). Each RoI pools
the points into its local POOL_SIZE^3 grid twice (``roiaware_pool3d``):
'avg' of the part features [part offsets where the segmentation score
reaches SEG_MASK_SCORE_THRESH else 0, the score] (with DISABLE_PART the
points' coordinates stand for the offsets; the score is detached), and
'max' of the point features. The grids stay dense, as in JAX: a cell is
occupied where its pooled part features are not all 0, and each conv block
is a 3x3x3 conv without bias, a BatchNorm over the occupied cells, a ReLU
and the output zeroed off the occupancy (submanifold semantics on a dense
grid). The two streams are concatenated [rpn, part] and flattened
channels-last, as JAX's ``reshape`` of its (S, S, S, C) grid, into the
shared FC layers. Every layer computes in f32, as flax does with f32
parameters and no dtype. ``parta2_head_loss`` is ``pvrcnn_head_loss``, as
in JAX."""
import torch
from torch import nn

from ...ops.roiaware_pool import roiaware_pool3d_batch
from ...ops.sparse.conv import MaskedBatchNorm
from ..layers import Conv3d
from .pvrcnn_head import RoIFCHead, pvrcnn_head_loss

parta2_head_loss = pvrcnn_head_loss


class _MaskedConvBlock(nn.Module):
    """(N, S, S, S, Cin) channels-last grid and (N, S, S, S) occupancy ->
    (N, S, S, S, Cout): conv, masked BatchNorm, ReLU, zero off the mask."""

    def __init__(self, cin, cout):
        super().__init__()
        self.conv = Conv3d(cin, cout, 3, padding=1, bias=False)
        self.bn = MaskedBatchNorm(cout)

    def forward(self, x, mask):
        y = self.conv(x.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
        flat = self.bn(y.reshape(-1, y.shape[-1]), mask.reshape(-1))
        return torch.relu(flat).reshape(y.shape) * mask[..., None]


class PartA2FCHead(RoIFCHead):
    """``point_channels``: the width of ``point_features``."""

    def __init__(self, model_cfg, num_class, point_channels):
        s = int(model_cfg.ROI_AWARE_POOL.POOL_SIZE)
        c0 = int(model_cfg.ROI_AWARE_POOL.NUM_FEATURES) // 2
        super().__init__(model_cfg, num_class, s ** 3 * 2 * c0)
        self.pool_size = s
        self.part_conv1 = _MaskedConvBlock(4, 64)
        self.part_conv2 = _MaskedConvBlock(64, c0)
        self.rpn_conv1 = _MaskedConvBlock(int(point_channels), 64)
        self.rpn_conv2 = _MaskedConvBlock(64, c0)

    def pooled_grids(self, batch_dict):
        """The RoIs' pooled part and point-feature grids, (B * R, S, S, S,
        4) 'avg' and (B * R, S, S, S, C) 'max'."""
        cfg = self.model_cfg
        rois = batch_dict['rois']
        points = batch_dict['point_coords']                        # (B, K, 3)
        point_valid = batch_dict.get('point_valid')
        if point_valid is None:
            point_valid = torch.ones(points.shape[:2], dtype=torch.bool, device=points.device)
        scores = batch_dict['point_cls_scores'].detach()[..., None]
        offsets = points if cfg.get('DISABLE_PART', False) else batch_dict['point_part_offset']
        keep = scores >= float(cfg.SEG_MASK_SCORE_THRESH)
        part_feats = torch.cat([torch.where(keep, offsets, torch.zeros_like(offsets)), scores],
                               dim=-1)
        s = self.pool_size
        n = rois.shape[0] * rois.shape[1]
        pooled_part = roiaware_pool3d_batch(points, part_feats, point_valid, rois[..., :7],
                                            s, 'avg')
        pooled_rpn = roiaware_pool3d_batch(points, batch_dict['point_features'], point_valid,
                                           rois[..., :7], s, 'max')
        return pooled_part.reshape(n, s, s, s, -1), pooled_rpn.reshape(n, s, s, s, -1)

    def roi_features(self, batch_dict):
        pooled_part, pooled_rpn = self.pooled_grids(batch_dict)
        occ = pooled_part.abs().sum(-1) > 0                        # (B * R, S, S, S)
        x_part = self.part_conv2(self.part_conv1(pooled_part, occ), occ)
        x_rpn = self.rpn_conv2(self.rpn_conv1(pooled_rpn, occ), occ)
        return torch.cat([x_rpn, x_part], dim=-1).reshape(occ.shape[0], -1)  # channels-last
