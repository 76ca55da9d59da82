"""Point-wise box head of PointRCNN (counterpart of
``fv2p_tpu/models/dense_heads/point_head_box.py``): a classification and a
box-regression MLP on every point's features, the boxes coded by
``PointResidualCoder`` against the point, and a proposal box decoded at
every point for the RoI head's proposal NMS (kernel B1).

``assign_point_box_targets`` labels each point with the class of the first
gt box that contains it (0 outside every box, -1 for ignore: inside a box
enlarged by GT_EXTRA_WIDTH but in none) and codes that box at foreground
points; ``point_head_box_loss`` is the focal classification loss and the
smooth-l1 box loss, both normalised by the number of foreground points."""
import torch
from torch import nn

from ...ops import pointops
from ...utils import box_coder_utils, common_utils, loss_utils
from ..layers import BatchNorm, Dense


def assign_point_box_targets(point_coords, gt_boxes_with_cls, extra_width, coder):
    """point_coords (B, K, 3), gt (B, M, 8) -> cls labels (B, K) int32 (-1
    ignore) and box labels (B, K, code_size), zero off the foreground."""
    labels_all, box_all = [], []
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
        gt_of_pts = gt[idx.clamp(min=0)]
        labels = torch.where(fg, cls[idx.clamp(min=0)], 0)
        labels_all.append(torch.where(ignore, -1, labels).to(torch.int32))
        box_labels = coder.encode(gt_of_pts[:, :7], points, gt_of_pts[:, 7].to(torch.int32))
        box_all.append(torch.where(fg[:, None], box_labels, 0.0))
    return torch.stack(labels_all), torch.stack(box_all)


def point_head_box_loss(model_cfg, ret):
    """Focal classification over every point (the weights and the box loss
    normalised by the foreground count) and weighted smooth-l1 (beta 1/9)
    box regression at the foreground points. Returns (loss, terms)."""
    lw = model_cfg.LOSS_CONFIG.LOSS_WEIGHTS
    logits = ret['point_cls_preds']
    n_cls = logits.shape[-1]
    flat_logits = logits.reshape(-1, n_cls)
    flat_labels = ret['point_cls_labels'].reshape(-1)
    positives = flat_labels > 0
    negatives = flat_labels == 0
    pos_norm = torch.clamp(positives.sum().to(torch.float32), min=1.0)
    cls_weights = (negatives.to(torch.float32) + positives.to(torch.float32)) / pos_norm
    one_hot = torch.nn.functional.one_hot(flat_labels.clamp(min=0).long(),
                                          n_cls + 1)[..., 1:].to(flat_logits.dtype)
    cls_loss = loss_utils.sigmoid_focal_loss(flat_logits, one_hot, cls_weights).sum() \
        * lw['point_cls_weight']

    code_size = ret['point_box_preds'].shape[-1]
    box_preds = ret['point_box_preds'].reshape(-1, code_size)
    box_labels = ret['point_box_labels'].reshape(-1, code_size)
    code_w = common_utils.device_constant(lw['code_weights'], torch.float32, box_preds.device)
    l1 = loss_utils.smooth_l1(box_preds - box_labels, beta=1.0 / 9.0) * code_w
    fg = positives.to(torch.float32)
    box_loss = (l1 * (fg / pos_norm)[:, None]).sum() * lw['point_box_weight']
    total = cls_loss + box_loss
    return total, {'point_loss_cls': cls_loss, 'point_loss_box': box_loss,
                   'point_loss': total}


class PointHeadBox(nn.Module):
    """``point_features`` (B, K, C) -> ``point_cls_scores`` (B, K) and the
    proposals ``batch_cls_preds`` (B, K, num_class) logits and
    ``batch_box_preds`` (B, K, 7) decoded at each point with the mean size
    of its best class. In f32, as flax with f32 parameters and no dtype."""

    def __init__(self, model_cfg, input_channels, num_class):
        super().__init__()
        self.model_cfg = model_cfg
        tc = model_cfg.TARGET_CONFIG
        self.coder = getattr(box_coder_utils, tc.BOX_CODER)(**dict(tc.get('BOX_CODER_CONFIG', {})))
        self.n_fc = {}
        for name, fc_list, out_ch in (('cls', model_cfg.CLS_FC, num_class),
                                      ('box', model_cfg.REG_FC, self.coder.code_size)):
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
        feats = batch_dict['point_features']
        b, k, c = feats.shape
        x = feats.reshape(-1, c).float()
        cls_preds = self._head(x, 'cls').reshape(b, k, -1)
        box_preds = self._head(x, 'box').reshape(b, k, -1)
        batch_dict['point_cls_scores'] = torch.sigmoid(cls_preds).amax(dim=-1)
        if self.training:
            labels, box_labels = assign_point_box_targets(
                batch_dict['point_coords'], batch_dict['gt_boxes'],
                tuple(self.model_cfg.TARGET_CONFIG.GT_EXTRA_WIDTH), self.coder)
            batch_dict['point_head_ret'] = {
                'point_cls_preds': cls_preds, 'point_box_preds': box_preds,
                'point_cls_labels': labels, 'point_box_labels': box_labels}
        pred_classes = torch.argmax(cls_preds, dim=-1) + 1
        batch_dict['batch_cls_preds'] = cls_preds
        batch_dict['batch_box_preds'] = self.coder.decode(box_preds, batch_dict['point_coords'],
                                                          pred_classes)
        batch_dict['cls_preds_normalized'] = False
        return batch_dict
