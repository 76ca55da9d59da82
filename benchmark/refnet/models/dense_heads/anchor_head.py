# Frozen at commit c8e3fcd from fv2p_torch/models/dense_heads/anchor_head.py, unchanged.
"""Anchor-based RPN head (counterpart of
``fv2p_tpu/models/dense_heads/anchor_head.py``): anchors, the
``AnchorHeadSingle`` forward and the box decode, and for training the
target assignment (axis-aligned, or ATSS) and the RPN loss."""
import math

import numpy as np
import torch
from torch import nn

from ...utils import box_coder_utils, common_utils, iou3d, loss_utils
from ..layers import Dense

ASSIGNERS = ('AxisAlignedTargetAssigner', 'ATSSTargetAssigner')


def generate_anchors(anchor_generator_cfg, grid_size, point_cloud_range):
    """Static numpy anchors: (ny, nx, A, 7) with A = num_cls * num_rot
    (align_center=False layout)."""
    pr = point_cloud_range
    per_class = []
    for cfg in anchor_generator_cfg:
        stride = int(cfg.get('feature_map_stride', 8))
        fm_nx, fm_ny = grid_size[0] // stride, grid_size[1] // stride
        x_stride = (pr[3] - pr[0]) / (fm_nx - 1)
        y_stride = (pr[4] - pr[1]) / (fm_ny - 1)
        xs = pr[0] + np.arange(fm_nx) * x_stride
        ys = pr[1] + np.arange(fm_ny) * y_stride
        sizes = np.array(cfg['anchor_sizes'], np.float32)       # (S, 3)
        rots = np.array(cfg['anchor_rotations'], np.float32)    # (R,)
        heights = np.array(cfg['anchor_bottom_heights'], np.float32)
        s, r, h = len(sizes), len(rots), len(heights)
        anchors = np.zeros((fm_ny, fm_nx, h, s, r, 7), np.float32)
        anchors[..., 0] = xs[None, :, None, None, None]
        anchors[..., 1] = ys[:, None, None, None, None]
        anchors[..., 2] = heights[None, None, :, None, None]
        anchors[..., 3:6] = sizes[None, None, None, :, None, :]
        anchors[..., 6] = rots[None, None, None, None, :]
        anchors[..., 2] += anchors[..., 5] / 2  # bottom -> center
        per_class.append(anchors.reshape(fm_ny, fm_nx, h * s * r, 7))
    return np.concatenate(per_class, axis=2)


def boxes_nearest_bev_iou(boxes_a, boxes_b):
    """Axis-aligned IoU (N, M) of the boxes' nearest axis-aligned BEV
    rectangles: dx and dy swap where |heading|, limited to [-pi/2, pi/2),
    exceeds pi/4."""

    def aligned(b):
        rot = common_utils.limit_period(b[:, 6], 0.5, math.pi).abs()
        swap = rot > math.pi / 4
        dx = torch.where(swap, b[:, 4], b[:, 3])
        dy = torch.where(swap, b[:, 3], b[:, 4])
        return torch.stack([b[:, 0] - dx / 2, b[:, 1] - dy / 2,
                            b[:, 0] + dx / 2, b[:, 1] + dy / 2], dim=1)

    a = aligned(boxes_a)
    b = aligned(boxes_b)
    iw = (torch.minimum(a[:, None, 2], b[None, :, 2])
          - torch.maximum(a[:, None, 0], b[None, :, 0]))
    ih = (torch.minimum(a[:, None, 3], b[None, :, 3])
          - torch.maximum(a[:, None, 1], b[None, :, 1]))
    inter = iw.clamp(min=0) * ih.clamp(min=0)
    area_a = ((a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1]))[:, None]
    area_b = ((b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]))[None, :]
    return inter / torch.clamp(area_a + area_b - inter, min=1e-6)


def assign_targets_single(anchors_flat, anchor_cls, gt_boxes, gt_classes,
                          matched_t, unmatched_t, box_coder):
    """One sample's axis-aligned assignment over all classes at once.

    anchors_flat (Na, 7); anchor_cls (Na,) 1..C; gt_boxes (M, 7);
    gt_classes (M,) (0 = padding); matched_t / unmatched_t (Na,). Returns
    labels (Na,) int32 (-1 ignore, 0 background, else the class),
    reg_targets (Na, 7) and reg_weights (Na,). A gt whose best overlap is
    <= 0 is not force-matched."""
    gt_valid = gt_classes > 0
    overlap = boxes_nearest_bev_iou(anchors_flat, gt_boxes)        # (Na, M)
    class_match = anchor_cls[:, None] == gt_classes[None, :]
    overlap = torch.where(class_match & gt_valid[None, :], overlap, -1.0)

    a2g_max = overlap.amax(dim=1)
    a2g_arg = torch.argmax(overlap, dim=1)            # the first maximum
    g2a_max = overlap.amax(dim=0)
    g2a_max = torch.where(g2a_max <= 0, -1.0, g2a_max)
    force = ((overlap == g2a_max[None, :]) & (g2a_max[None, :] > 0)
             & gt_valid[None, :] & class_match).any(dim=1)

    pos = a2g_max >= matched_t
    bg = a2g_max < unmatched_t
    labels = torch.full_like(anchor_cls, -1)
    labels = torch.where(bg, 0, labels)
    labels = torch.where(pos | force, gt_classes[a2g_arg], labels)

    fg = labels > 0
    targets = box_coder.encode(gt_boxes[a2g_arg], anchors_flat)
    reg_targets = torch.where(fg[:, None], targets, 0.0)
    return labels, reg_targets, fg.to(torch.float32)


def add_sin_difference(boxes1, boxes2, dim=6):
    """sin(a - b) = sin a cos b - cos a sin b, split over the two sides."""
    rad_pred = torch.sin(boxes1[..., dim:dim + 1]) * torch.cos(boxes2[..., dim:dim + 1])
    rad_tg = torch.cos(boxes1[..., dim:dim + 1]) * torch.sin(boxes2[..., dim:dim + 1])
    boxes1 = torch.cat([boxes1[..., :dim], rad_pred, boxes1[..., dim + 1:]], dim=-1)
    boxes2 = torch.cat([boxes2[..., :dim], rad_tg, boxes2[..., dim + 1:]], dim=-1)
    return boxes1, boxes2


def anchor_head_loss(model_cfg, ret, anchors_flat, num_class):
    """RPN loss: focal classification + sin-difference smooth-l1 box
    regression + direction cross-entropy, each per positive anchor and per
    sample. Returns (loss, terms)."""
    lw = model_cfg.LOSS_CONFIG.LOSS_WEIGHTS
    tb = {}
    labels = ret['box_cls_labels']            # (B, Na)
    cls_preds = ret['cls_preds']              # (B, Na, C)
    b = labels.shape[0]
    cared = labels >= 0
    positives = labels > 0
    negatives = labels == 0

    cls_weights = negatives.to(torch.float32) + positives.to(torch.float32)
    reg_weights = positives.to(torch.float32)
    pos_normalizer = torch.clamp(positives.sum(dim=1, keepdim=True).to(torch.float32),
                                 min=1.0)
    cls_weights = cls_weights / pos_normalizer
    reg_weights = reg_weights / pos_normalizer

    cls_targets = torch.where(cared, labels, 0).long()
    one_hot = torch.nn.functional.one_hot(cls_targets, num_class + 1)[..., 1:]
    cls_loss = loss_utils.sigmoid_focal_loss(cls_preds, one_hot.to(cls_preds.dtype),
                                             cls_weights)
    cls_loss = cls_loss.sum() / b * lw['cls_weight']
    tb['rpn_loss_cls'] = cls_loss

    reg_targets = ret['box_reg_targets']
    pred_sin, tg_sin = add_sin_difference(ret['box_preds'], reg_targets)
    code_w = common_utils.device_constant(lw['code_weights'], torch.float32,
                                          cls_preds.device)
    l1 = loss_utils.smooth_l1(pred_sin - tg_sin, beta=1.0 / 9.0) * code_w
    loc_loss = (l1 * reg_weights[..., None]).sum() / b * lw['loc_weight']
    tb['rpn_loss_loc'] = loc_loss
    rpn_loss = cls_loss + loc_loss

    if 'dir_cls_preds' in ret and model_cfg.get('USE_DIRECTION_CLASSIFIER', False):
        dir_offset = float(model_cfg.DIR_OFFSET)
        num_bins = int(model_cfg.NUM_DIR_BINS)
        # the gt heading at each anchor: anchor + the target's angle residual
        gt_rot = reg_targets[..., 6] + anchors_flat[None, :, 6]
        offset_rot = common_utils.limit_period(gt_rot - dir_offset, 0, 2 * math.pi)
        dir_targets = torch.clamp(
            torch.floor(offset_rot / (2 * math.pi / num_bins)).long(), 0, num_bins - 1)
        logp = torch.log_softmax(ret['dir_cls_preds'], dim=-1)
        ce = -torch.gather(logp, -1, dir_targets[..., None])[..., 0]
        weights = positives.to(torch.float32)
        weights = weights / torch.clamp(weights.sum(dim=1, keepdim=True), min=1.0)
        dir_loss = (ce * weights).sum() / b * lw['dir_weight']
        rpn_loss = rpn_loss + dir_loss
        tb['rpn_loss_dir'] = dir_loss

    tb['rpn_loss'] = rpn_loss
    return rpn_loss, tb


def atss_assign_targets_single(anchors_flat, gt_boxes, gt_classes, topk,
                               box_coder, match_height=False):
    """One sample's Adaptive Training Sample Selection
    (https://arxiv.org/abs/1912.02424) over all anchors at once: each valid
    gt takes its ``topk`` anchors of nearest centre as candidates, keeps
    those whose IoU reaches mean + std (ddof 1) + 1e-6 of the candidates'
    and whose centre lies in its BEV box; each anchor then takes its
    highest-IoU gt among those that kept it, and each valid gt its best-IoU
    anchor whatever the rest (the force match).

    anchors_flat (Na, 7); gt_boxes (M, 7); gt_classes (M,) (0 = padding).
    The IoU is rotated BEV (kernel B1 on the card), or 3-D with
    ``match_height``. Ties keep JAX's order: among anchors at one distance
    the lower index is the nearer (a stable sort; ``lax.top_k``), the
    maximum over a row is its first, and where two gt rows force-match one
    anchor the later row wins, as JAX's scatter on the CPU leaves it. Returns
    labels (Na,) int32 (0 background, else the class), reg_targets (Na, 7)
    and reg_weights (Na,)."""
    na, m = anchors_flat.shape[0], gt_boxes.shape[0]
    gt_valid = gt_classes > 0
    iou_fn = iou3d.boxes_iou3d if match_height else iou3d.boxes_iou_bev
    ious = torch.where(gt_valid[None, :],
                       iou_fn(anchors_flat[:, :7], gt_boxes[:, :7]), -1.0)   # (Na, M)

    diff = anchors_flat[:, None, 0:3] - gt_boxes[None, :, 0:3]
    dist = torch.where(gt_valid[None, :], (diff * diff).sum(-1).sqrt(), math.inf)
    topk_idxs = torch.sort(dist.T, dim=1, stable=True)[1][:, :topk]      # (M, K)

    cand_ious = torch.gather(ious.T, 1, topk_idxs)
    thresh = cand_ious.mean(dim=1) + cand_ious.std(dim=1, correction=1) + 1e-6
    is_pos = cand_ious >= thresh[:, None]

    # the candidate's centre inside the gt's BEV box
    cand = anchors_flat[topk_idxs.reshape(-1)]                            # (M*K, 7)
    gt_rep = torch.repeat_interleave(gt_boxes, topk, dim=0)
    local = common_utils.rotate_points_along_z(
        (cand[:, 0:3] - gt_rep[:, 0:3])[:, None, :], -gt_rep[:, 6])[:, 0, :2]
    half = gt_rep[:, 3:5] / 2
    in_gt = ((local <= half) & (local >= -half)).all(dim=-1).reshape(m, topk)
    is_pos = is_pos & in_gt & gt_valid[:, None]

    # eligible (anchor, gt) pairs: the kept candidates
    elig = torch.zeros(na * m, dtype=torch.bool, device=anchors_flat.device)
    elig[(topk_idxs * m + torch.arange(m, device=topk_idxs.device)[:, None])[is_pos]] = True
    ious_elig = torch.where(elig.reshape(na, m), ious, -1e9)
    a2g_val, a2g_idx = ious_elig.max(dim=1)           # the first maximum

    # the force match, the later gt row winning an anchor two rows share
    g2a_max, best_anchor = ious.max(dim=0)
    rows = torch.arange(m, device=gt_boxes.device)
    winner = torch.full((na,), -1, dtype=torch.long, device=gt_boxes.device)
    winner.scatter_reduce_(0, best_anchor[gt_valid], rows[gt_valid], 'amax')
    forced = winner >= 0
    a2g_idx = torch.where(forced, winner, a2g_idx)
    a2g_val = torch.where(forced, g2a_max[winner.clamp(min=0)], a2g_val)

    labels = torch.where(a2g_val > -1e9 / 2, gt_classes[a2g_idx], 0).to(torch.int32)
    fg = labels > 0
    targets = box_coder.encode(gt_boxes[a2g_idx], anchors_flat)
    reg_targets = torch.where(fg[:, None], targets, 0.0)
    return labels, reg_targets, fg.to(torch.float32)


class AnchorHeadSingle(nn.Module):
    """1x1 cls / box / direction convs over the BEV map, then the decode of
    every anchor's box (the RoI head consumes all of them, in training
    too). In training it also assigns each anchor its target
    (``anchor_head_ret``, read by ``anchor_head_loss``)."""

    def __init__(self, model_cfg, input_channels, num_class, grid_size,
                 point_cloud_range):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_class = num_class
        anchors = generate_anchors(model_cfg.ANCHOR_GENERATOR_CONFIG,
                                   tuple(grid_size), tuple(point_cloud_range))
        self.anchor_shape = anchors.shape
        self.register_buffer('anchors_flat',
                             torch.from_numpy(anchors.reshape(-1, 7)),
                             persistent=False)
        a = anchors.shape[2]
        self.num_dir_bins = int(model_cfg.NUM_DIR_BINS)
        # 1x1 convolutions over a channels-last map are Dense layers
        self.conv_cls = Dense(input_channels, a * num_class, conv1x1=True)
        self.conv_box = Dense(input_channels, a * 7, conv1x1=True)
        self.conv_dir_cls = Dense(input_channels, a * self.num_dir_bins, conv1x1=True)
        ta_cfg = model_cfg.TARGET_ASSIGNER_CONFIG
        self.box_coder = getattr(box_coder_utils, ta_cfg.BOX_CODER)()
        self.assigner = ta_cfg.get('NAME', ASSIGNERS[0])
        if self.assigner not in ASSIGNERS:
            raise NotImplementedError(f'target assigner {self.assigner}: AnchorHeadSingle '
                                      f'knows {ASSIGNERS}')
        self.atss_topk = int(ta_cfg.get('TOPK', 9))
        self.atss_match_height = bool(ta_cfg.get('MATCH_HEIGHT', False))
        # per anchor of one location: class id and match thresholds
        cls_ids, matched, unmatched = [], [], []
        for ci, acfg in enumerate(model_cfg.ANCHOR_GENERATOR_CONFIG):
            n = (len(acfg['anchor_sizes']) * len(acfg['anchor_rotations'])
                 * len(acfg['anchor_bottom_heights']))
            cls_ids += [ci + 1] * n
            matched += [acfg['matched_threshold']] * n
            unmatched += [acfg['unmatched_threshold']] * n
        locations = anchors.shape[0] * anchors.shape[1]
        for name, vals, dt in (('anchor_cls', cls_ids, torch.int32),
                               ('matched_t', matched, torch.float32),
                               ('unmatched_t', unmatched, torch.float32)):
            self.register_buffer(name, torch.tensor(vals, dtype=dt).repeat(locations),
                                 persistent=False)

    def forward(self, batch_dict):
        x = batch_dict['spatial_features_2d']               # (B, H, W, C)
        batch_dict['spatial_features_before_head'] = x
        b = x.shape[0]
        ny, nx, a, _ = self.anchor_shape
        n = ny * nx * a
        cls_preds = self.conv_cls(x).reshape(b, n, self.num_class).float()
        box_preds = self.conv_box(x).reshape(b, n, 7).float()
        dir_preds = self.conv_dir_cls(x).reshape(b, n, self.num_dir_bins).float()
        if self.training:
            ret = {'cls_preds': cls_preds, 'box_preds': box_preds,
                   'dir_cls_preds': dir_preds}
            ret.update(self.assign_targets(batch_dict['gt_boxes']))
            batch_dict['anchor_head_ret'] = ret
        batch_dict['batch_cls_preds'] = cls_preds
        batch_dict['batch_box_preds'] = self._decode_preds(box_preds, dir_preds)
        batch_dict['cls_preds_normalized'] = False
        return batch_dict

    def assign_targets(self, gt_boxes_with_cls):
        """gt (B, M, 8) -> box_cls_labels (B, Na), box_reg_targets
        (B, Na, 7), reg_weights (B, Na), by the config's assigner, one scan
        at a time."""
        def single(gt):
            if self.assigner == 'ATSSTargetAssigner':
                return atss_assign_targets_single(
                    self.anchors_flat, gt[:, :7], gt[:, 7].to(torch.int32), self.atss_topk,
                    self.box_coder, match_height=self.atss_match_height)
            return assign_targets_single(
                self.anchors_flat, self.anchor_cls, gt[:, :7], gt[:, 7].to(torch.int32),
                self.matched_t, self.unmatched_t, self.box_coder)
        outs = [single(gt) for gt in gt_boxes_with_cls]
        labels, reg_targets, reg_weights = (torch.stack(x) for x in zip(*outs))
        return {'box_cls_labels': labels, 'box_reg_targets': reg_targets,
                'reg_weights': reg_weights}

    def _decode_preds(self, box_preds, dir_preds):
        cfg = self.model_cfg
        decoded = self.box_coder.decode(box_preds, self.anchors_flat[None])
        if cfg.get('USE_DIRECTION_CLASSIFIER', False):
            dir_offset = float(cfg.DIR_OFFSET)
            dir_limit_offset = float(cfg.DIR_LIMIT_OFFSET)
            period = 2 * math.pi / self.num_dir_bins
            dir_labels = torch.argmax(dir_preds, dim=-1)
            val = common_utils.limit_period(decoded[..., 6] - dir_offset,
                                            dir_limit_offset, period)
            rot = val + dir_offset + period * dir_labels.to(decoded.dtype)
            decoded = torch.cat([decoded[..., :6], rot[..., None],
                                 decoded[..., 7:]], dim=-1)
        return decoded
