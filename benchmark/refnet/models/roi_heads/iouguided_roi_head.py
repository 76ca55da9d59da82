# Frozen at commit c8e3fcd from fv2p_torch/models/roi_heads/iouguided_roi_head.py, unchanged.
"""IoU-guided RoI head (counterpart of
``fv2p_tpu/models/roi_heads/iouguided_roi_head.py``).

Three streams per RoI -- pooled keypoints through an xyz-up MLP and a
multi-scale-grouping SA module at 6x6x6 grid points (kernel B4 at bf16
inference), bilinear BEV pooling at the global grid points, corner-geometry
encoding -- fused into cls + (iou, 7-dim reg) predictions. Inference runs
them twice for the two-pass IoU alignment. Training samples ROI_PER_IMAGE
RoIs a scan from the proposals (``sample_rois_single``, its random draws
passed in), gives each its canonical target (``assign_targets``), runs the
streams once with dropout, and ``roi_head_loss`` scores them."""
import math

import numpy as np
import torch
from torch import nn

from ...ops import pointops
from ...ops.cuda.sa_group import sa_group_pool_fused
from ...utils import box_coder_utils, box_utils, common_utils, iou3d, loss_utils
from ..layers import BN_EPS, BatchNorm, Dense, Dropout


def proposal_layer(batch_box_preds, batch_cls_preds, nms_cfg):
    """NMS the dense predictions into fixed (B, POST) RoIs."""
    batch_box_preds = batch_box_preds.detach()
    batch_cls_preds = batch_cls_preds.detach()
    pre = int(min(nms_cfg.NMS_PRE_MAXSIZE, batch_box_preds.shape[1]))
    post = int(nms_cfg.NMS_POST_MAXSIZE)
    thresh = float(nms_cfg.NMS_THRESH)

    roi_scores_all, roi_labels_all = batch_cls_preds.max(dim=-1)
    roi_labels_all = roi_labels_all + 1
    keep = [iou3d.nms_rotated(bx, sc, thresh, pre_max=pre, post_max=post)
            for bx, sc in zip(batch_box_preds, roi_scores_all)]
    keep_idx = torch.stack([k[0] for k in keep])
    keep_valid = torch.stack([k[1] for k in keep])

    rois = torch.gather(batch_box_preds, 1,
                        keep_idx[..., None].expand(-1, -1, 7))
    roi_scores = torch.gather(roi_scores_all, 1, keep_idx)
    roi_labels = torch.gather(roi_labels_all, 1, keep_idx)
    rois = torch.where(keep_valid[..., None], rois, 0.0)
    roi_scores = torch.where(keep_valid, roi_scores, 0.0)
    roi_labels = torch.where(keep_valid, roi_labels, 0)
    return rois, roi_scores, roi_labels, keep_valid


def decode_in_roi_frame(coder, reg, rois):
    """(B, R, code) refinements of RoIs (B, R, 7) -> boxes (B, R, 7 + C):
    decoded against the RoI moved to the origin, rotated by its heading,
    shifted to its center."""
    b, r = rois.shape[:2]
    local = torch.cat([torch.zeros_like(rois[..., 0:3]), rois[..., 3:]], dim=-1)
    dec = coder.decode(reg, local)
    dec = common_utils.rotate_points_along_z(dec.reshape(b * r, 1, -1),
                                             rois[..., 6].reshape(-1)).reshape(b, r, -1)
    return torch.cat([dec[..., 0:3] + rois[..., 0:3], dec[..., 3:]], dim=-1)


# ------------------------------------------------- proposal target layer

def _max_iou_with_same_class(rois, roi_labels, gt_boxes, gt_labels, gt_valid):
    ious = iou3d.boxes_iou3d(rois, gt_boxes)                      # (R, M)
    same = (roi_labels[:, None] == gt_labels[None, :]) & gt_valid[None, :]
    ious = torch.where(same, ious, 0.0)
    return ious.amax(dim=1), torch.argmax(ious, dim=1)


def _sorted_candidates(mask):
    """Indices of the True entries first, in their order, then the rest
    (a stable argsort of ~mask); and how many are True."""
    order = torch.argsort((~mask).to(torch.int32), stable=True)
    return order, mask.sum()


def draw_roi_sampling(batch_size, num_rois, n_sample, generator, device):
    """The random draws of ``sample_rois_single`` for each scan: ``rand``
    (B, R) uniform in [0, 1) ranks the foreground RoIs, ``hr``, ``er``,
    ``fr`` (B, n_sample) integers in [0, 2^30) pick hard background, easy
    background and (without any background) foreground refills."""
    def ints():
        return torch.randint(0, 2 ** 30, (batch_size, n_sample),
                             generator=generator, device=device)
    rand = torch.rand((batch_size, num_rois), generator=generator, device=device)
    return {'rand': rand, 'hr': ints(), 'er': ints(), 'fr': ints()}


def sample_rois_single(rois, roi_scores, roi_labels, roi_valid, gt, cfg,
                       rand, hr, er, fr):
    """Subsample ROI_PER_IMAGE of one scan's RoIs: up to FG_RATIO of them
    foreground (IoU >= min(REG_FG_THRESH, CLS_FG_THRESH)) in the order of
    ``rand``, the rest background, HARD_BG_RATIO of it hard (IoU in
    [CLS_BG_THRESH_LO, fg)) where both kinds exist, drawn with replacement
    by ``hr`` / ``er``; without any background the foreground refills by
    ``fr``. Fixed shapes, no host wait."""
    n_sample = int(cfg.ROI_PER_IMAGE)
    fg_per_image = int(np.round(cfg.FG_RATIO * n_sample))
    fg_thresh = min(float(cfg.REG_FG_THRESH), float(cfg.CLS_FG_THRESH))
    bg_lo = float(cfg.CLS_BG_THRESH_LO)
    hard_ratio = float(cfg.HARD_BG_RATIO)

    gt_boxes = gt[:, :7]
    gt_labels = gt[:, 7].to(torch.int32)
    max_overlaps, gt_assignment = _max_iou_with_same_class(
        rois, roi_labels.to(torch.int32), gt_boxes, gt_labels, gt_labels > 0)
    max_overlaps = torch.where(roi_valid, max_overlaps, 0.0)

    fg_mask = (max_overlaps >= fg_thresh) & roi_valid
    easy_mask = (max_overlaps < bg_lo) & roi_valid
    hard_mask = (max_overlaps >= bg_lo) & (max_overlaps < fg_thresh) & roi_valid

    # foreground: the fg_per_image largest draws (ties: the lower index)
    fg_rank = torch.where(fg_mask, rand, float('-inf'))
    fg_pick = torch.sort(fg_rank, descending=True, stable=True).indices[:fg_per_image]
    nf = fg_mask.sum()
    fg_take = torch.clamp(nf, max=fg_per_image)

    hard_list, n_hard = _sorted_candidates(hard_mask)
    easy_list, n_easy = _sorted_candidates(easy_mask)
    bg_num = n_sample - fg_take
    hard_num = torch.where(
        (n_hard > 0) & (n_easy > 0),
        torch.minimum((bg_num.to(torch.float32) * hard_ratio).to(n_hard.dtype), n_hard),
        torch.where(n_hard > 0, bg_num, 0))

    j = torch.arange(n_sample, device=rois.device)
    hard_pick = hard_list[hr % n_hard.clamp(min=1)]
    easy_pick = easy_list[er % n_easy.clamp(min=1)]
    bg_pick = torch.where(j < hard_num, hard_pick, easy_pick)
    fg_list, _ = _sorted_candidates(fg_mask)
    fg_fill = fg_list[fr % nf.clamp(min=1)]
    bg_pick = torch.where(n_hard + n_easy > 0, bg_pick, fg_fill)

    # slots [0, fg_take) take fg_pick, the rest bg_pick
    fg_slot_idx = fg_pick[j.clamp(max=fg_per_image - 1)]
    bg_slot_idx = bg_pick[(j - fg_take).clamp(0, n_sample - 1)]
    sampled = torch.where(j < fg_take, fg_slot_idx, bg_slot_idx)
    return {
        'rois': rois[sampled],
        'roi_labels': roi_labels[sampled],
        'roi_scores': roi_scores[sampled],
        'gt_iou_of_rois': max_overlaps[sampled],
        'gt_of_rois': gt[gt_assignment[sampled]],
    }


def assign_targets(batch_dict, target_cfg, draws):
    """Sample each scan's RoIs (``draws`` as ``draw_roi_sampling`` gives
    them) and express each sampled RoI's gt in the RoI's canonical frame:
    centred, rotated by -heading, the heading difference folded into
    [-pi/2, pi/2] (a box and its reverse are one target). Also the soft
    classification labels and the regression mask."""
    outs = [sample_rois_single(*args, target_cfg, *(draws[k][i] for k in
                                                   ('rand', 'hr', 'er', 'fr')))
            for i, args in enumerate(zip(
                batch_dict['rois'], batch_dict['roi_scores'],
                batch_dict['roi_labels'], batch_dict['roi_valid'],
                batch_dict['gt_boxes']))]
    out = {k: torch.stack([o[k] for o in outs]) for k in outs[0]}

    rois = out['rois']
    gt_of_rois = out['gt_of_rois']                       # (B, N, 8)
    out['gt_of_rois_src'] = gt_of_rois
    two_pi = 2 * math.pi
    roi_ry = torch.remainder(rois[..., 6], two_pi)
    ct = torch.cat([gt_of_rois[..., 0:3] - rois[..., 0:3], gt_of_rois[..., 3:6],
                    gt_of_rois[..., 6:7] - roi_ry[..., None], gt_of_rois[..., 7:]],
                   dim=-1)
    ct = common_utils.rotate_points_along_z(
        ct.reshape(-1, 1, ct.shape[-1]), -roi_ry.reshape(-1)).reshape(gt_of_rois.shape)
    heading = torch.remainder(ct[..., 6], two_pi)
    opposite = (heading > math.pi * 0.5) & (heading < math.pi * 1.5)
    heading = torch.where(opposite, torch.remainder(heading + math.pi, two_pi), heading)
    heading = torch.where(heading > math.pi, heading - two_pi, heading)
    heading = torch.clamp(heading, -math.pi / 2, math.pi / 2)
    out['gt_of_rois'] = torch.cat([ct[..., :6], heading[..., None], ct[..., 7:]], dim=-1)

    iou_fg, iou_bg = float(target_cfg.CLS_FG_THRESH), float(target_cfg.CLS_BG_THRESH)
    ious = out['gt_iou_of_rois']
    fg = ious > iou_fg
    bg = ious < iou_bg
    if target_cfg.get('CLS_SCORE_TYPE', 'roi_iou') == 'cls':
        cls_labels = torch.where(fg, 1.0, torch.where(bg, 0.0, -1.0))
    else:
        soft = (ious - iou_bg) / (iou_fg - iou_bg)
        cls_labels = torch.where(fg, 1.0, torch.where(bg, 0.0, soft))
    out['rcnn_cls_labels'] = cls_labels
    out['reg_valid_mask'] = (ious > float(target_cfg.REG_FG_THRESH)).to(torch.int32)
    return out


def rcnn_box_loss_terms(model_cfg, ret):
    """The RCNN loss terms of every RoI-grid head: BCE of the
    classification against the soft IoU labels, smooth-l1 box regression
    on the canonical targets and the corner regularisation (both over
    foreground RoIs). Returns {'rcnn_loss_cls', 'rcnn_loss_reg',
    'rcnn_loss_corner'}."""
    lw = model_cfg.LOSS_CONFIG.LOSS_WEIGHTS
    coder = getattr(box_coder_utils, model_cfg.TARGET_CONFIG.BOX_CODER)()
    code_size = coder.code_size
    dev = ret['rcnn_cls'].device
    tb = {}

    rcnn_cls = ret['rcnn_cls'].reshape(-1)
    labels = ret['rcnn_cls_labels'].reshape(-1)
    p = torch.clamp(torch.sigmoid(rcnn_cls), 1e-7, 1 - 1e-7)
    bce = -(labels * torch.log(p) + (1 - labels) * torch.log(1 - p))
    valid = (labels >= 0).to(torch.float32)
    loss_cls = (bce * valid).sum() / torch.clamp(valid.sum(), min=1.0)
    loss_cls = loss_cls * lw['rcnn_cls_weight']
    tb['rcnn_loss_cls'] = loss_cls

    fg_mask = ret['reg_valid_mask'].reshape(-1).to(torch.float32)
    fg_sum = torch.clamp(fg_mask.sum(), min=1.0)
    gt_ct = ret['gt_of_rois'][..., :code_size].reshape(-1, code_size)
    rois = ret['rois_sampled'].reshape(-1, code_size)
    zeros3 = torch.zeros_like(rois[:, 0:3])
    rois_anchor = torch.cat([zeros3, rois[:, 3:6], torch.zeros_like(rois[:, 6:7])], dim=-1)
    reg_targets = coder.encode(gt_ct, rois_anchor)
    rcnn_reg = ret['rcnn_reg'].reshape(-1, code_size)
    code_w = common_utils.device_constant(lw['code_weights'], torch.float32, dev)
    l1 = loss_utils.smooth_l1(rcnn_reg - reg_targets, beta=1.0 / 9.0) * code_w
    loss_reg = (l1 * fg_mask[:, None]).sum() / fg_sum * lw['rcnn_reg_weight']
    tb['rcnn_loss_reg'] = loss_reg

    local_rois = torch.cat([zeros3, rois[:, 3:]], dim=-1)
    decoded = coder.decode(rcnn_reg, local_rois)
    decoded = common_utils.rotate_points_along_z(decoded[:, None, :], rois[:, 6])[:, 0]
    decoded = torch.cat([decoded[:, 0:3] + rois[:, 0:3], decoded[:, 3:]], dim=-1)
    gt_src = ret['gt_of_rois_src'][..., :code_size].reshape(-1, code_size)
    pc = box_utils.boxes_to_corners_3d(decoded[:, :7])
    gc = box_utils.boxes_to_corners_3d(gt_src[:, :7])
    gt_flip = torch.cat([gt_src[:, :6], gt_src[:, 6:7] + math.pi], dim=-1)
    gcf = box_utils.boxes_to_corners_3d(gt_flip)
    dist = torch.minimum(torch.linalg.norm(pc - gc, dim=2),
                         torch.linalg.norm(pc - gcf, dim=2))     # (N, 8)
    corner = loss_utils.smooth_l1(dist, beta=1.0).mean(dim=1)
    tb['rcnn_loss_corner'] = (corner * fg_mask).sum() / fg_sum * lw['rcnn_corner_weight']
    return tb


def roi_head_loss(model_cfg, ret):
    """RCNN losses: ``rcnn_box_loss_terms`` and smooth-l1 of the IoU score.
    Returns (loss, terms)."""
    lw = model_cfg.LOSS_CONFIG.LOSS_WEIGHTS
    tb = rcnn_box_loss_terms(model_cfg, ret)
    iou_labels = (ret['gt_iou_of_rois'].reshape(-1) - 0.5) * 2.0
    iou_pred = ret['rcnn_iouscore'].reshape(-1)
    rv = (iou_labels >= (float(model_cfg.TARGET_CONFIG.REG_FG_THRESH) - 0.5) * 2
          ).to(torch.float32)
    sl1 = loss_utils.smooth_l1(iou_pred - iou_labels, beta=1.0)
    loss_iou = (sl1 * rv).sum() / torch.clamp(rv.sum(), min=1.0)
    loss_iou = loss_iou * lw['rcnn_iouscore_weight']
    tb['rcnn_loss_iouscore'] = loss_iou

    rcnn_loss = tb['rcnn_loss_cls'] + tb['rcnn_loss_reg'] + tb['rcnn_loss_corner'] + loss_iou
    tb['rcnn_loss'] = rcnn_loss
    return rcnn_loss, tb


# ---------------------------------------------------------- feature modules

class _MLP1x1(nn.Module):
    """Stack of Dense (+ optional BN) + ReLU over the last axis."""

    def __init__(self, in_channels, channels, use_bn=False, compute_dtype=None):
        super().__init__()
        self.channels = tuple(int(c) for c in channels)
        self.use_bn = use_bn
        ch = in_channels
        for i, out in enumerate(self.channels):
            setattr(self, f'fc{i}', Dense(ch, out, not use_bn, compute_dtype))
            if use_bn:
                setattr(self, f'bn{i}', BatchNorm(out))
            ch = out

    def forward(self, x):
        for i in range(len(self.channels)):
            x = getattr(self, f'fc{i}')(x)
            if self.use_bn:
                x = getattr(self, f'bn{i}')(x)
            x = torch.relu(x)
        return x

    def folded_layers(self):
        """Per layer, the eval affine ``(W (in, out), b)`` with BatchNorm's
        running statistics folded in: ``y = relu(x @ W + b)``."""
        outs = []
        for i in range(len(self.channels)):
            w = getattr(self, f'fc{i}').weight.t()
            if self.use_bn:
                bn = getattr(self, f'bn{i}')
                a = bn.weight * torch.rsqrt(bn.running_var + BN_EPS)
                outs.append((w * a[None, :], bn.bias - bn.running_mean * a))
            else:
                outs.append((w, getattr(self, f'fc{i}').bias))
        return outs


class _SAModuleMSG(nn.Module):
    """Multi-scale-grouping set abstraction at given centers, over a batch of
    point sets. At bf16 with two radii and MLPs ((64, 64), (64, 64)) the
    whole group -> MLP -> max runs as kernel B4; otherwise (f32) it groups
    with ``pointops.ball_query_group`` and runs the MLPs on the gathered
    slots."""

    def __init__(self, radii, nsamples, mlps, in_channels, use_bn=False,
                 compute_dtype=None):
        super().__init__()
        self.radii = tuple(float(r) for r in radii)
        self.nsamples = tuple(int(n) for n in nsamples)
        self.mlps = tuple(tuple(int(c) for c in m) for m in mlps)
        self.compute_dtype = compute_dtype
        for i, m in enumerate(self.mlps):
            setattr(self, f'mlp{i}', _MLP1x1(3 + in_channels, m, use_bn,
                                             compute_dtype))

    def fused_ok(self):
        """Kernel B4 serves bf16 inference only: training groups with the
        differentiable gather path, as the JAX package does."""
        return (not self.training
                and len(self.radii) == 2
                and self.mlps == ((64, 64), (64, 64))
                and self.compute_dtype == torch.bfloat16)

    def forward(self, xyz, valid, feats, centers):
        """xyz (R, P, 3), valid (R, P), feats (R, P, C), centers (R, G, 3)
        -> (R, G, sum(mlp[-1]))."""
        if self.fused_ok():
            return self._fused(xyz, valid, feats, centers)
        d2 = ((centers[:, :, None, 0] - xyz[:, None, :, 0]) ** 2
              + (centers[:, :, None, 1] - xyz[:, None, :, 1]) ** 2
              + (centers[:, :, None, 2] - xyz[:, None, :, 2]) ** 2)
        outs = []
        for i, (r, ns) in enumerate(zip(self.radii, self.nsamples)):
            gx, gf, _ = pointops.ball_query_group(centers, xyz, valid, feats,
                                                  r, ns, d2)
            g = getattr(self, f'mlp{i}')(torch.cat([gx, gf], dim=-1))
            outs.append(g.amax(dim=2))
        return torch.cat(outs, dim=-1)

    def _fused(self, xyz, valid, feats, centers):
        feats = feats.to(self.compute_dtype)
        x32, c32 = xyz.float(), centers.float()
        z, cw, w2, b1, b2 = [], [], [], [], []
        for i in range(2):
            (w1, bias1), (w2_i, bias2) = getattr(self, f'mlp{i}').folded_layers()
            w1x = w1[:3].float()
            z.append((feats @ w1[3:].to(feats.dtype)).float() + x32 @ w1x)
            cw.append(c32 @ w1x - bias1.float())
            w2.append(w2_i)
            b1.append(bias1)
            b2.append(bias2)
        out = sa_group_pool_fused(
            centers, xyz, valid, torch.stack(z).to(torch.bfloat16),
            torch.stack(cw), torch.stack(w2).to(torch.bfloat16),
            torch.stack(b1).float(), torch.stack(b2).float(),
            self.radii, self.nsamples)
        return out.to(feats.dtype)


class _CGEModule(nn.Module):
    """Corner geometry encoding: per-corner 1x1 MLP, then an interaction
    layer over all 8 corners."""

    def __init__(self, up_filters, interact_filters, compute_dtype=None):
        super().__init__()
        self.n_up, self.n_inter = len(up_filters), len(interact_filters)
        ch = 3
        for i, out in enumerate(up_filters):
            setattr(self, f'up{i}', Dense(ch, out, False, compute_dtype))
            setattr(self, f'up_bn{i}', BatchNorm(out))
            ch = out
        ch *= 8
        for k, out in enumerate(interact_filters):
            setattr(self, f'inter{k}', Dense(ch, out, False, compute_dtype))
            setattr(self, f'inter_bn{k}', BatchNorm(out))
            ch = out

    def forward(self, corners):                          # (R, 8, 3)
        x = corners
        for i in range(self.n_up):
            x = torch.relu(getattr(self, f'up_bn{i}')(getattr(self, f'up{i}')(x)))
        x = x.reshape(x.shape[0], -1)
        for k in range(self.n_inter):
            x = torch.relu(getattr(self, f'inter_bn{k}')(
                getattr(self, f'inter{k}')(x)))
        return x


class _FCHead(nn.Module):
    """[Dense + BN + ReLU] per fc_list entry, with dropout after the first
    in training, then a final Dense."""

    def __init__(self, in_channels, fc_list, out_channels, dp_ratio=0.0,
                 compute_dtype=None):
        super().__init__()
        self.n = len(fc_list)
        ch = in_channels
        for k, out in enumerate(fc_list):
            setattr(self, f'fc{k}', Dense(ch, out, False, compute_dtype))
            setattr(self, f'bn{k}', BatchNorm(out))
            ch = out
        self.dropout = Dropout(dp_ratio)
        self.out = Dense(ch, out_channels)

    def forward(self, x, generator=None):
        for k in range(self.n):
            x = torch.relu(getattr(self, f'bn{k}')(getattr(self, f'fc{k}')(x)))
            if k == 0:
                x = self.dropout(x, generator)
        return self.out(x)


def _dense_grid_points(rois_flat, grid_size):
    """(BR, G^3, 3) local grid points."""
    g = grid_size
    idx = np.stack(np.meshgrid(np.arange(g), np.arange(g), np.arange(g),
                               indexing='ij'), axis=-1).reshape(-1, 3)
    idx = common_utils.device_constant(idx, torch.float32, rois_flat.device)
    sizes = rois_flat[:, None, 3:6]
    return (idx[None] + 0.5) / g * sizes - sizes / 2


def two_pass_final_score(cls0, iou1_raw):
    """The pass-2 iou score in [-1, 1] renormalized to [0, 1], clamped to
    [1e-3, 1], times the pass-1 sigmoid cls score."""
    iou1 = torch.clamp(iou1_raw * 0.5 + 0.5, 1e-3, 1.0)
    return torch.sigmoid(cls0) * iou1


class _RoIFeatureNet(nn.Module):
    """All three feature streams + heads for one set of RoIs; called twice
    at inference with shared weights."""

    def __init__(self, model_cfg, num_class, code_size, point_cloud_range,
                 voxel_size, point_channels, bev_channels, compute_dtype=None):
        super().__init__()
        cfg = model_cfg
        self.cfg = cfg
        self.point_cloud_range = tuple(point_cloud_range)
        self.voxel_size = tuple(voxel_size)
        cd = compute_dtype
        use_bn = bool(cfg.USE_BN)
        xyz_up = tuple(cfg.XYZ_UP_LAYER)
        self.xyz_up = _MLP1x1(5, xyz_up, use_bn, cd)
        self.merge_down = _MLP1x1(xyz_up[-1] + point_channels, (xyz_up[-1],),
                                  use_bn, cd)
        bev_cfg = cfg.BEV_GRID_POOL
        self.bev_compress_on = int(bev_cfg.IN_CHANNELS) != int(bev_cfg.OUT_CHANNELS)
        bev_out = bev_channels
        if self.bev_compress_on:
            bev_out = int(bev_cfg.OUT_CHANNELS)
            self.bev_compress = Dense(bev_channels, bev_out, False, cd)
            self.bev_compress_bn = BatchNorm(bev_out)
        sa_cfg = cfg.ROI_GRID_POOL.SA_CONFIG
        mlps = [tuple(m) for m in sa_cfg.MLPS[0]]
        self.sa_module = _SAModuleMSG(sa_cfg.RADIUS[0], sa_cfg.NSAMPLE[0], mlps,
                                      xyz_up[-1], use_bn, cd)
        n_grid = int(cfg.ROI_GRID_POOL.GRID_SIZE) ** 3
        ch = n_grid * (sum(m[-1] for m in mlps) + bev_out)
        self.n_inter = len(cfg.GRID_INTERACT.INTERACT_FILTERS)
        for k, out in enumerate(cfg.GRID_INTERACT.INTERACT_FILTERS):
            setattr(self, f'grid_inter{k}', Dense(ch, out, False, cd))
            setattr(self, f'grid_inter_bn{k}', BatchNorm(out))
            ch = out
        dp = float(cfg.DP_RATIO)
        self.grid_dropout = Dropout(dp)
        self.cge = _CGEModule(tuple(cfg.CGE_MODULE.UP_FILTERS),
                              tuple(cfg.CGE_MODULE.INTERACT_FILTERS), cd)
        ch += int(cfg.CGE_MODULE.INTERACT_FILTERS[-1])
        self.n_fuse = len(cfg.FUSE_FILTERS)
        for i, out in enumerate(cfg.FUSE_FILTERS):
            setattr(self, f'fuse{i}', Dense(ch, out, False, cd))
            setattr(self, f'fuse_bn{i}', BatchNorm(out))
            ch = out
        self.cls_head = _FCHead(ch, tuple(cfg.CLS_FC), num_class, dp, cd)
        self.reg_head = _FCHead(ch, tuple(cfg.REG_FC),
                                (1 + code_size) * num_class, dp, cd)

    def forward(self, batch_dict, batch_rois, generator=None):
        """``generator`` draws the dropout masks in training."""
        cfg = self.cfg
        b, r = batch_rois.shape[0], batch_rois.shape[1]
        num_sampled = int(cfg.ROI_POINT_POOL.NUM_SAMPLED_POINTS)
        grid_size = int(cfg.ROI_GRID_POOL.GRID_SIZE)

        # ---- point pooling
        point_coords = batch_dict['point_coords']          # (B, K, 3)
        point_feats = batch_dict['point_features']         # (B, K, C)
        point_scores = batch_dict['point_cls_scores'].detach()
        depth_norm = float(cfg.ROI_POINT_POOL.DEPTH_NORMALIZER)
        point_depths = torch.linalg.norm(point_coords, dim=-1) / depth_norm - 0.5
        feats_all = torch.cat([point_scores[..., None], point_depths[..., None],
                               point_feats.to(point_coords.dtype)], dim=-1)
        pooled, empty = pointops.roipoint_pool3d(
            point_coords, feats_all, batch_rois[..., :7], num_sampled,
            tuple(cfg.ROI_POINT_POOL.POOL_EXTRA_WIDTH))
        pooled = pooled.reshape(b * r, num_sampled, -1)
        empty = empty.reshape(b * r)
        rois_flat = batch_rois.reshape(b * r, -1)

        # canonical transform
        xyz = pooled[..., 0:3] - rois_flat[:, None, 0:3]
        xyz = common_utils.rotate_points_along_z(xyz, -rois_flat[:, 6])
        pooled = torch.cat([xyz, pooled[..., 3:]], dim=-1)
        # the pooled points are constants to the RoI head, as in JAX
        pooled = pooled.masked_fill(empty[:, None, None], 0.0).detach()

        # ---- xyz-up + merge
        xyz_feat = self.xyz_up(pooled[..., :5])
        merged = self.merge_down(torch.cat([xyz_feat, pooled[..., 5:]], dim=-1))

        # ---- grid points
        local_grid = _dense_grid_points(rois_flat, grid_size)      # (BR, G, 3)
        global_grid = common_utils.rotate_points_along_z(
            local_grid, rois_flat[:, 6]) + rois_flat[:, None, 0:3]

        # ---- BEV stream
        bev = batch_dict['spatial_features_before_head']          # (B, H, W, C)
        stride = batch_dict['spatial_features_stride']
        vx, vy = self.voxel_size[0], self.voxel_size[1]
        x0, y0 = self.point_cloud_range[0], self.point_cloud_range[1]
        gg = global_grid.reshape(b, -1, 3)
        xi = (gg[..., 0] - x0) / vx / stride
        yi = (gg[..., 1] - y0) / vy / stride
        bev_feats = torch.stack([pointops.bilinear_interpolate_bev(
            bev[i], xi[i], yi[i]) for i in range(b)])
        if self.bev_compress_on:
            sh = bev_feats.shape
            bf = self.bev_compress_bn(self.bev_compress(bev_feats.reshape(-1, sh[-1])))
            bev_feats = torch.relu(bf).reshape(sh[0], sh[1], -1)
        grid_bev = bev_feats.reshape(b * r, local_grid.shape[1], -1)

        # ---- point stream: SA module at the local grid points
        point_valid = (~empty)[:, None].expand(b * r, num_sampled)
        grid_point = self.sa_module(pooled[..., 0:3], point_valid, merged,
                                    local_grid)

        # ---- grid interaction
        inter = torch.cat([grid_point, grid_bev], dim=-1).reshape(b * r, -1)
        for k in range(self.n_inter):
            inter = torch.relu(getattr(self, f'grid_inter_bn{k}')(
                getattr(self, f'grid_inter{k}')(inter)))
            if k != self.n_inter - 1:
                inter = self.grid_dropout(inter, generator)

        # ---- CGE stream + fusion
        cge = self.cge(box_utils.boxes_to_CTcorners_3d(rois_flat[:, :7]))
        fused = torch.cat([inter, cge], dim=-1)
        for i in range(self.n_fuse):
            fused = torch.relu(getattr(self, f'fuse_bn{i}')(
                getattr(self, f'fuse{i}')(fused)))

        rcnn_cls = self.cls_head(fused, generator)
        regiou = self.reg_head(fused, generator)
        return rcnn_cls, regiou[:, 1:], regiou[:, :1]


class IoUGuidedRoIHead(nn.Module):
    def __init__(self, model_cfg, num_class, point_cloud_range, voxel_size,
                 point_channels, bev_channels, compute_dtype=None):
        super().__init__()
        self.model_cfg = model_cfg
        self.box_coder = getattr(box_coder_utils,
                                 model_cfg.TARGET_CONFIG.BOX_CODER)()
        self.feature_net = _RoIFeatureNet(
            model_cfg, num_class, self.box_coder.code_size, point_cloud_range,
            voxel_size, point_channels, bev_channels, compute_dtype)

    def forward(self, batch_dict):
        rois, roi_scores, roi_labels, roi_valid = proposal_layer(
            batch_dict['batch_box_preds'], batch_dict['batch_cls_preds'],
            self.model_cfg.NMS_CONFIG['TRAIN' if self.training else 'TEST'])
        batch_dict.update(rois=rois, roi_scores=roi_scores,
                          roi_labels=roi_labels, roi_valid=roi_valid)
        if self.training:
            return self._train_forward(batch_dict)

        cls0_raw, reg0, iou0_raw = self.feature_net(batch_dict, rois)
        cls0, box0, _ = self._generate_predicted_boxes(rois, cls0_raw, reg0,
                                                       iou0_raw)
        # two-pass IoU alignment: re-pool at the refined boxes
        cls1_raw, reg1, iou1_raw = self.feature_net(batch_dict, box0)
        _, _, iou1 = self._generate_predicted_boxes(box0, cls1_raw, reg1,
                                                    iou1_raw)
        batch_dict['batch_cls_preds'] = cls0
        batch_dict['batch_box_preds'] = box0
        batch_dict['batch_iouscore_preds'] = two_pass_final_score(cls0, iou1)
        batch_dict['has_class_labels'] = True
        batch_dict['cls_preds_normalized'] = False
        return batch_dict

    def _train_forward(self, batch_dict):
        """Sample the RoIs and their targets, one pass of the streams (no IoU
        alignment); everything the loss reads goes to ``roi_head_ret``. The
        draws come from ``batch_dict['generators']``: 'sampling' for the
        RoIs, 'dropout' for the masks."""
        gens = batch_dict.get('generators', {})
        tcfg = self.model_cfg.TARGET_CONFIG
        rois = batch_dict['rois']
        draws = draw_roi_sampling(rois.shape[0], rois.shape[1],
                                  int(tcfg.ROI_PER_IMAGE), gens.get('sampling'),
                                  rois.device)
        ret = assign_targets(batch_dict, tcfg, draws)
        batch_dict.update(rois=ret['rois'], roi_labels=ret['roi_labels'],
                          roi_scores=ret['roi_scores'])
        rcnn_cls, rcnn_reg, rcnn_iou = self.feature_net(
            batch_dict, ret['rois'], gens.get('dropout'))
        ret.update(rcnn_cls=rcnn_cls, rcnn_reg=rcnn_reg, rcnn_iouscore=rcnn_iou,
                   rois_sampled=ret['rois'])
        batch_dict['roi_head_ret'] = ret
        return batch_dict

    def _generate_predicted_boxes(self, rois, cls_preds, box_preds, iou_preds):
        b, r = rois.shape[0], rois.shape[1]
        cls_preds = cls_preds.reshape(b, r, -1).float()
        iou_preds = iou_preds.reshape(b, r, -1).float()
        box_preds = box_preds.reshape(b, r, self.box_coder.code_size).float()
        return cls_preds, decode_in_roi_frame(self.box_coder, box_preds, rois), iou_preds
