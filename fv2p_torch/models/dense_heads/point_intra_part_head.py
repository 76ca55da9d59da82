"""PartA2's intra-object part head (counterpart of
``fv2p_tpu/models/dense_heads/point_intra_part_head.py``).

Every point gets a foreground score and a sigmoid regression of where it
lies inside its gt box, each coordinate in [0, 1] of the box's extent (the
point rotated into the box frame, divided by the box's size, plus 0.5).
With a ``BOX_CODER`` (PartA2_free) a third branch codes a box at every
point, decoded into the proposals ``batch_box_preds``. Padding rows
(``point_valid`` False) are ignored (label -1). In f32, as flax with f32
parameters and no dtype.
"""
import torch
from torch import nn

from ...ops import pointops
from ...utils import box_coder_utils, common_utils, loss_utils
from ..layers import BatchNorm, Dense
from .point_head_box import assign_point_box_targets
from .point_head_simple import assign_point_targets, point_head_loss


def assign_part_targets(point_coords, gt_boxes_with_cls):
    """point_coords (B, K, 3), gt (B, M, 8) -> (B, K, 3) part locations in
    [0, 1] of each foreground point's first box, 0 off the foreground."""
    out = []
    for points, gt in zip(point_coords, gt_boxes_with_cls):
        boxes = gt[:, :7]
        idx = pointops.points_in_boxes_index(points, boxes, gt[:, 7] > 0)
        box = boxes[idx.clamp(min=0)]                               # (K, 7)
        local = common_utils.rotate_points_along_z(
            (points - box[:, 0:3])[:, None, :], -box[:, 6])[:, 0, :]
        part = local / box[:, 3:6].clamp(min=1e-4) + 0.5
        out.append(torch.where((idx >= 0)[:, None], part, torch.zeros_like(part)))
    return torch.stack(out)


def point_intra_part_head_loss(model_cfg, ret):
    """The focal segmentation loss, the part BCE over the foreground points
    (normalised by 3 x their count), and with the box branch the weighted
    smooth-l1 (beta 1/9) box loss. Returns (loss, terms)."""
    w = model_cfg.LOSS_CONFIG.LOSS_WEIGHTS
    pos = ret['point_cls_labels'] > 0
    normalizer = pos.sum().to(torch.float32).clamp(min=1.0)
    loss_cls, _ = point_head_loss(model_cfg, ret)

    p = torch.sigmoid(ret['point_part_preds'])
    labels = ret['point_part_labels']
    eps = 1e-7
    bce = -(labels * torch.log(p.clamp(eps, 1.0))
            + (1 - labels) * torch.log((1 - p).clamp(eps, 1.0)))
    loss_part = (bce.sum(dim=-1) * pos.to(torch.float32)).sum()
    loss_part = loss_part / (3.0 * normalizer) * float(w['point_part_weight'])

    total = loss_cls + loss_part
    terms = {'point_loss_cls': loss_cls, 'point_loss_part': loss_part}
    if 'point_box_preds' in ret:
        code_size = ret['point_box_preds'].shape[-1]
        box_preds = ret['point_box_preds'].reshape(-1, code_size)
        box_labels = ret['point_box_labels'].reshape(-1, code_size)
        fg = pos.reshape(-1).to(torch.float32)
        l1 = loss_utils.smooth_l1(box_preds - box_labels, beta=1.0 / 9.0)
        if 'code_weights' in w:
            l1 = l1 * common_utils.device_constant(w['code_weights'], torch.float32,
                                                   box_preds.device)
        loss_box = (l1 * (fg / normalizer)[:, None]).sum() * float(w.get('point_box_weight', 1.0))
        total = total + loss_box
        terms['point_loss_box'] = loss_box
    return total, terms


class PointIntraPartOffsetHead(nn.Module):
    def __init__(self, model_cfg, input_channels, num_class):
        super().__init__()
        self.model_cfg = model_cfg
        self.n_cls = 1 if model_cfg.get('CLASS_AGNOSTIC', True) else num_class
        tc = model_cfg.TARGET_CONFIG
        self.coder = None
        branches = [('cls', model_cfg.CLS_FC, self.n_cls), ('part', model_cfg.PART_FC, 3)]
        if tc.get('BOX_CODER', None) is not None:
            self.coder = getattr(box_coder_utils, tc.BOX_CODER)(
                **dict(tc.get('BOX_CODER_CONFIG', {})))
            branches.append(('box', model_cfg.REG_FC, self.coder.code_size))
        self.n_fc = {}
        for name, fc_list, out_ch in branches:
            ch = input_channels
            for i, out in enumerate(fc_list):
                setattr(self, f'{name}_fc{i}', Dense(ch, int(out), False))
                setattr(self, f'{name}_bn{i}', BatchNorm(int(out)))
                ch = int(out)
            setattr(self, f'{name}_out', Dense(ch, out_ch))
            self.n_fc[name] = len(fc_list)

    def _head(self, x, name):
        for i in range(self.n_fc[name]):
            x = torch.relu(getattr(self, f'{name}_bn{i}')(getattr(self, f'{name}_fc{i}')(x)))
        return getattr(self, f'{name}_out')(x)

    def forward(self, batch_dict):
        cfg = self.model_cfg
        feats = batch_dict['point_features']
        b, k, c = feats.shape
        x = feats.reshape(-1, c).float()
        cls_logits = self._head(x, 'cls').reshape(b, k, -1)
        part_preds = self._head(x, 'part').reshape(b, k, 3)
        box_preds = None if self.coder is None else self._head(x, 'box').reshape(b, k, -1)
        batch_dict['point_cls_scores'] = torch.sigmoid(cls_logits).amax(dim=-1)
        batch_dict['point_part_offset'] = torch.sigmoid(part_preds)

        if self.training:
            coords, gt = batch_dict['point_coords'], batch_dict['gt_boxes']
            extra = tuple(cfg.TARGET_CONFIG.GT_EXTRA_WIDTH)
            labels = assign_point_targets(coords, gt, extra, self.n_cls)
            if 'point_valid' in batch_dict:
                labels = torch.where(batch_dict['point_valid'], labels, -1)
            ret = {'point_cls_preds': cls_logits, 'point_cls_labels': labels,
                   'point_part_preds': part_preds,
                   'point_part_labels': assign_part_targets(coords, gt)}
            if self.coder is not None:
                _, box_labels = assign_point_box_targets(coords, gt, extra, self.coder)
                ret.update(point_box_preds=box_preds, point_box_labels=box_labels)
            batch_dict['point_head_ret'] = ret
        if self.coder is not None:
            pred_classes = torch.argmax(cls_logits, dim=-1) + 1
            batch_dict['batch_cls_preds'] = cls_logits
            batch_dict['batch_box_preds'] = self.coder.decode(
                box_preds, batch_dict['point_coords'], pred_classes)
            batch_dict['cls_preds_normalized'] = False
        return batch_dict
