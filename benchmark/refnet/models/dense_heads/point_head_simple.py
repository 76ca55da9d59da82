# Frozen at commit c8e3fcd from fv2p_torch/models/dense_heads/point_head_simple.py, unchanged.
"""Per-keypoint foreground head (counterpart of
``fv2p_tpu/models/dense_heads/point_head_simple.py``): the segmentation
scores, and in training the point targets and the focal loss."""
import torch
from torch import nn

from ...ops import pointops
from ...utils import common_utils, loss_utils
from ..layers import BatchNorm, Dense


def assign_point_targets(point_coords, gt_boxes_with_cls, extra_width,
                         num_class):
    """point_coords (B, K, 3); gt (B, M, 8) -> labels (B, K) int32: a point
    inside a gt box is foreground (its class, or 1 class-agnostic), one
    inside only the box enlarged by ``extra_width`` is ignored (-1), the
    rest background."""
    out = []
    for points, gt in zip(point_coords, gt_boxes_with_cls):
        boxes = gt[:, :7]
        cls = gt[:, 7].to(torch.int32)
        valid = cls > 0
        idx = pointops.points_in_boxes_index(points, boxes, valid)
        extra = common_utils.device_constant(extra_width, boxes.dtype, boxes.device)
        enlarged = torch.cat([boxes[:, :3], boxes[:, 3:6] + extra, boxes[:, 6:]], dim=-1)
        idx_ext = pointops.points_in_boxes_index(points, enlarged, valid)
        fg = idx >= 0
        ignore = ~fg & (idx_ext >= 0)
        if num_class == 1:
            labels = fg.to(torch.int32)
        else:
            labels = torch.where(fg, cls[idx.clamp(min=0)], 0)
        out.append(torch.where(ignore, -1, labels).to(torch.int32))
    return torch.stack(out)


def point_head_loss(model_cfg, ret):
    """Focal classification loss over all keypoints, normalised by the
    positives. Returns (loss, terms)."""
    logits = ret['point_cls_preds']               # (B, K, C)
    labels = ret['point_cls_labels']              # (B, K)
    n_cls = logits.shape[-1]
    flat_logits = logits.reshape(-1, n_cls)
    flat_labels = labels.reshape(-1)
    positives = flat_labels > 0
    negatives = flat_labels == 0
    cls_weights = negatives.to(torch.float32) + positives.to(torch.float32)
    cls_weights = cls_weights / torch.clamp(positives.sum().to(torch.float32), min=1.0)
    one_hot = torch.nn.functional.one_hot(flat_labels.clamp(min=0).long(),
                                          n_cls + 1)[..., 1:]
    loss = loss_utils.sigmoid_focal_loss(flat_logits, one_hot.to(flat_logits.dtype),
                                         cls_weights)
    w = float(model_cfg.LOSS_CONFIG.LOSS_WEIGHTS['point_cls_weight'])
    point_loss = loss.sum() * w
    return point_loss, {'point_loss_cls': point_loss}


class PointHeadSimple(nn.Module):
    def __init__(self, model_cfg, input_channels, num_class,
                 compute_dtype=None):
        super().__init__()
        self.model_cfg = model_cfg
        self.n_fc = len(model_cfg.CLS_FC)
        ch = input_channels
        for i, out in enumerate(model_cfg.CLS_FC):
            setattr(self, f'cls_fc{i}', Dense(ch, out, False, compute_dtype))
            setattr(self, f'cls_bn{i}', BatchNorm(out))
            ch = out
        self.n_out = 1 if model_cfg.get('CLASS_AGNOSTIC', True) else num_class
        self.cls_out = Dense(ch, self.n_out)

    def forward(self, batch_dict):
        if self.model_cfg.get('USE_POINT_FEATURES_BEFORE_FUSION', False):
            feats = batch_dict['point_features_before_fusion']
        else:
            feats = batch_dict['point_features']            # (B, K, C)
        b, k, c = feats.shape
        x = feats.reshape(-1, c)
        for i in range(self.n_fc):
            x = torch.relu(getattr(self, f'cls_bn{i}')(
                getattr(self, f'cls_fc{i}')(x)))
        logits = self.cls_out(x).reshape(b, k, -1)
        scores = torch.sigmoid(logits)
        batch_dict['point_cls_scores'] = scores.amax(dim=-1)
        if self.training:
            batch_dict['point_head_ret'] = {
                'point_cls_preds': logits,
                'point_cls_labels': assign_point_targets(
                    batch_dict['point_coords'], batch_dict['gt_boxes'],
                    tuple(self.model_cfg.TARGET_CONFIG.GT_EXTRA_WIDTH), self.n_out)}
        else:
            batch_dict['batch_pointseg_preds'] = torch.cat(
                [batch_dict['point_coords'], scores], dim=-1)
        return batch_dict
