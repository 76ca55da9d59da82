"""Multi-group anchor head for the nuScenes CBGS models and KITTI's
SECOND-multihead (counterpart of
``fv2p_tpu/models/dense_heads/anchor_head_multi.py``).

Anchors are laid out in the multihead order, per class (A_c, ny, nx), so
each head's (B, A_h * H * W, code) predictions concatenate into the global
anchor order. Each head's class logits are packed into one dense
(B, N, num_class) f32 tensor with -1e9 for the classes outside the head:
their sigmoid is exactly 0, so the multi-class NMS and the focal loss see
one tensor, as JAX's do. Module names are the flax ones (``shared_conv``,
``h{i}_cls_c{j}``, ``h{i}_{reg}_out``, ``h{i}_dir_out``, ...), so
``weights.load_flax_variables`` maps each flax path to one submodule.
"""
import math

import numpy as np
import torch
from torch import nn

from ...utils import box_coder_utils, common_utils, loss_utils
from ..layers import BatchNorm, Conv2d
from .anchor_head import assign_targets_single

PAD_LOGIT = -1e9            # a class outside an anchor's head


def generate_anchors_multihead(anchor_generator_cfg, grid_size, point_cloud_range):
    """Flat anchors in multihead order: per class a block of (A_c, ny, nx, 7).
    Returns (anchors (N, 7), class id 1..C (N,), matched and unmatched
    thresholds (N,)), numpy."""
    pr = point_cloud_range
    blocks, cls_ids, m_t, u_t = [], [], [], []
    for ci, cfg in enumerate(anchor_generator_cfg):
        stride = int(cfg['feature_map_stride'])
        fm_nx, fm_ny = grid_size[0] // stride, grid_size[1] // stride
        xs = pr[0] + np.arange(fm_nx) * (pr[3] - pr[0]) / (fm_nx - 1)
        ys = pr[1] + np.arange(fm_ny) * (pr[4] - pr[1]) / (fm_ny - 1)
        sizes = np.array(cfg['anchor_sizes'], np.float32)
        rots = np.array(cfg['anchor_rotations'], np.float32)
        heights = np.array(cfg['anchor_bottom_heights'], np.float32)
        s, r, h = len(sizes), len(rots), len(heights)
        a = np.zeros((h, s, r, fm_ny, fm_nx, 7), np.float32)
        a[..., 0] = xs[None, None, None, None, :]
        a[..., 1] = ys[None, None, None, :, None]
        a[..., 2] = heights[:, None, None, None, None]
        a[..., 3:6] = sizes[None, :, None, None, None, :]
        a[..., 6] = rots[None, None, :, None, None]
        a[..., 2] += a[..., 5] / 2
        flat = a.reshape(-1, 7)
        blocks.append(flat)
        n = flat.shape[0]
        cls_ids += [ci + 1] * n
        m_t += [float(cfg['matched_threshold'])] * n
        u_t += [float(cfg['unmatched_threshold'])] * n
    return (np.concatenate(blocks), np.array(cls_ids, np.int32),
            np.array(m_t, np.float32), np.array(u_t, np.float32))


class AnchorHeadMulti(nn.Module):
    """A shared 3x3 conv + BN + ReLU, then per head of RPN_HEAD_CFGS either
    the SEPARATE_REG_CONFIG branches (middle 3x3 convs + BN + ReLU, a 3x3
    output conv per class logit group and per regression item) or 1x1 class
    and box convs, and a 1x1 direction conv; the packed predictions are
    decoded with the direction bins. In training each anchor is assigned
    its target (``anchor_head_ret``, read by ``anchor_head_multi_loss``)."""

    def __init__(self, model_cfg, input_channels, num_class, class_names, grid_size,
                 point_cloud_range, compute_dtype=None):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_class = num_class
        cd = compute_dtype
        tc = model_cfg.TARGET_ASSIGNER_CONFIG
        self.box_coder = getattr(box_coder_utils, tc.BOX_CODER)(
            **dict(tc.get('BOX_CODER_CONFIG', {})))
        code = self.box_coder.code_size
        self.num_dir_bins = int(model_cfg.NUM_DIR_BINS)
        self.use_dir = model_cfg.get('USE_DIRECTION_CLASSIFIER', None) is not None

        anchors, anchor_cls, m_t, u_t = generate_anchors_multihead(
            model_cfg.ANCHOR_GENERATOR_CONFIG, tuple(grid_size), tuple(point_cloud_range))
        # zero columns up to the boxes' width (nuScenes' velocities)
        box_ndim = code - 1 if self.box_coder.encode_angle_by_sincos else code
        anchors = np.pad(anchors, ((0, 0), (0, max(box_ndim - 7, 0))))
        for name, vals in (('anchors_flat', anchors), ('anchor_cls', anchor_cls),
                           ('matched_t', m_t), ('unmatched_t', u_t)):
            self.register_buffer(name, torch.from_numpy(vals), persistent=False)

        acfg = {c['class_name']: c for c in model_cfg.ANCHOR_GENERATOR_CONFIG}
        # per head: its 1-based class ids and anchors per location
        self.plan = []
        for head_cfg in model_cfg.RPN_HEAD_CFGS:
            names = list(head_cfg['HEAD_CLS_NAME'])
            a_per = sum(len(acfg[n]['anchor_sizes']) * len(acfg[n]['anchor_rotations'])
                        * len(acfg[n]['anchor_bottom_heights']) for n in names)
            self.plan.append(([list(class_names).index(n) + 1 for n in names], a_per))

        cin = input_channels
        self.shared = model_cfg.get('SHARED_CONV_NUM_FILTER', None) is not None
        if self.shared:
            cin = int(model_cfg.SHARED_CONV_NUM_FILTER)
            self.shared_conv = Conv2d(input_channels, cin, 3, padding=1, bias=False,
                                      compute_dtype=cd)
            self.shared_bn = BatchNorm(cin, axis=1)
        sep = model_cfg.get('SEPARATE_REG_CONFIG', None)
        self.sep = sep is not None
        self.reg_items = []
        if self.sep:
            self.n_mid, n_filt = int(sep.NUM_MIDDLE_CONV), int(sep.NUM_MIDDLE_FILTER)
            for item in sep.REG_LIST:
                rname, rch = item.split(':')
                self.reg_items.append((rname, int(rch)))
        for hi, (ids, a_per) in enumerate(self.plan):
            if self.sep:
                for branch in ['cls'] + [r for r, _ in self.reg_items]:
                    for j in range(self.n_mid):
                        setattr(self, f'h{hi}_{branch}_c{j}', Conv2d(
                            cin if j == 0 else n_filt, n_filt, 3, padding=1, bias=False,
                            compute_dtype=cd))
                        setattr(self, f'h{hi}_{branch}_bn{j}', BatchNorm(n_filt, axis=1))
                mid = n_filt if self.n_mid else cin
                setattr(self, f'h{hi}_cls_out', Conv2d(mid, a_per * len(ids), 3, padding=1,
                                                       compute_dtype=cd))
                for rname, rch in self.reg_items:
                    setattr(self, f'h{hi}_{rname}_out', Conv2d(mid, a_per * rch, 3, padding=1,
                                                               compute_dtype=cd))
            else:
                setattr(self, f'h{hi}_cls_out', Conv2d(cin, a_per * len(ids), 1,
                                                       compute_dtype=cd))
                setattr(self, f'h{hi}_box_out', Conv2d(cin, a_per * code, 1,
                                                       compute_dtype=cd))
            if self.use_dir:
                setattr(self, f'h{hi}_dir_out', Conv2d(cin, a_per * self.num_dir_bins, 1,
                                                       compute_dtype=cd))

    def _middle(self, x, name):
        for j in range(self.n_mid):
            x = getattr(self, f'{name}_c{j}')(x)
            x = torch.relu(getattr(self, f'{name}_bn{j}')(x))
        return x

    @staticmethod
    def _anchor_major(y, a_per, ch):
        """(B, a_per * ch, H, W) -> (B, a_per * H * W, ch), anchor-major."""
        b, _, h, w = y.shape
        return y.reshape(b, a_per, ch, h, w).permute(0, 1, 3, 4, 2).reshape(
            b, a_per * h * w, ch)

    def forward(self, batch_dict):
        x = batch_dict['spatial_features_2d'].permute(0, 3, 1, 2)    # NCHW
        if self.shared:
            x = torch.relu(self.shared_bn(self.shared_conv(x)))
        code = self.box_coder.code_size
        cls_list, box_list, dir_list = [], [], []
        for hi, (ids, a_per) in enumerate(self.plan):
            if self.sep:
                cls = getattr(self, f'h{hi}_cls_out')(self._middle(x, f'h{hi}_cls'))
                regs = [getattr(self, f'h{hi}_{rname}_out')(self._middle(x, f'h{hi}_{rname}'))
                        for rname, _ in self.reg_items]
                b, _, h, w = x.shape
                box = torch.cat([r.reshape(b, a_per, rch, h, w)
                                 for r, (_, rch) in zip(regs, self.reg_items)], dim=2)
                box = box.reshape(b, a_per * code, h, w)
            else:
                cls = getattr(self, f'h{hi}_cls_out')(x)
                box = getattr(self, f'h{hi}_box_out')(x)
            cls = self._anchor_major(cls, a_per, len(ids)).float()
            # the head's logits at its classes' columns, PAD_LOGIT elsewhere
            pad = cls.new_full(cls.shape[:2], PAD_LOGIT)
            cols = [cls[..., ids.index(c + 1)] if c + 1 in ids else pad
                    for c in range(self.num_class)]
            cls_list.append(torch.stack(cols, dim=-1))
            box_list.append(self._anchor_major(box, a_per, code))
            if self.use_dir:
                d = getattr(self, f'h{hi}_dir_out')(x)
                dir_list.append(self._anchor_major(d, a_per, self.num_dir_bins))
        cls_preds = torch.cat(cls_list, dim=1)
        box_preds = torch.cat(box_list, dim=1).float()
        dir_preds = torch.cat(dir_list, dim=1).float() if dir_list else None

        ret = {'cls_preds': cls_preds, 'box_preds': box_preds}
        if dir_preds is not None:
            ret['dir_cls_preds'] = dir_preds
        if self.training:
            ret.update(self.assign_targets(batch_dict['gt_boxes']))
        batch_dict['batch_cls_preds'] = cls_preds
        batch_dict['batch_box_preds'] = self._decode_preds(box_preds, dir_preds)
        batch_dict['cls_preds_normalized'] = False
        batch_dict['anchor_head_ret'] = ret
        return batch_dict

    def assign_targets(self, gt_boxes_with_cls):
        """gt (B, M, box_ndim + 1 or wider; the class in the last column) ->
        box_cls_labels (B, Na), box_reg_targets (B, Na, code), reg_weights
        (B, Na)."""
        ndim = self.anchors_flat.shape[-1]
        outs = [assign_targets_single(
            self.anchors_flat, self.anchor_cls, gt[:, :ndim], gt[:, -1].to(torch.int32),
            self.matched_t, self.unmatched_t, self.box_coder)
            for gt in gt_boxes_with_cls]
        labels, reg_targets, reg_weights = (torch.stack(x) for x in zip(*outs))
        return {'box_cls_labels': labels, 'box_reg_targets': reg_targets,
                'reg_weights': reg_weights}

    def _decode_preds(self, box_preds, dir_preds):
        cfg = self.model_cfg
        decoded = self.box_coder.decode(box_preds, self.anchors_flat[None])
        if self.use_dir:
            dir_offset = float(cfg.DIR_OFFSET)
            period = 2 * math.pi / self.num_dir_bins
            dir_labels = torch.argmax(dir_preds, dim=-1)
            val = common_utils.limit_period(decoded[..., 6] - dir_offset,
                                            float(cfg.DIR_LIMIT_OFFSET), period)
            rot = val + dir_offset + period * dir_labels.to(decoded.dtype)
            decoded = torch.cat([decoded[..., :6], rot[..., None], decoded[..., 7:]], dim=-1)
        return decoded


def anchor_head_multi_loss(model_cfg, ret, anchors_flat, num_class):
    """The CBGS multihead loss: focal classification with pos/neg weights,
    L1 (WeightedL1Loss) or smooth-L1 box regression with code weights and
    no sin-difference, direction cross-entropy from the heading the targets
    encode (sincos or plain). Returns (loss, terms)."""
    lw = model_cfg.LOSS_CONFIG.LOSS_WEIGHTS
    tb = {}
    labels = ret['box_cls_labels']
    cls_preds = ret['cls_preds']
    b = labels.shape[0]
    positives = labels > 0
    negatives = labels == 0

    pos_w = float(lw.get('pos_cls_weight', 1.0))
    neg_w = float(lw.get('neg_cls_weight', 1.0))
    cls_weights = negatives.to(torch.float32) * neg_w + positives.to(torch.float32) * pos_w
    reg_weights = positives.to(torch.float32)
    pos_normalizer = torch.clamp(positives.sum(dim=1, keepdim=True).to(torch.float32),
                                 min=1.0)
    cls_weights = cls_weights / pos_normalizer
    reg_weights = reg_weights / pos_normalizer

    cls_targets = torch.where(labels >= 0, labels, 0).long()
    one_hot = torch.nn.functional.one_hot(cls_targets, num_class + 1)[..., 1:]
    cls_loss = loss_utils.sigmoid_focal_loss(cls_preds, one_hot.to(cls_preds.dtype),
                                             cls_weights)
    cls_loss = cls_loss.sum() / b * lw['cls_weight']
    tb['rpn_loss_cls'] = cls_loss

    reg_targets = ret['box_reg_targets']
    diff = ret['box_preds'] - reg_targets
    code_w = common_utils.device_constant(lw['code_weights'], torch.float32,
                                          cls_preds.device)
    if model_cfg.LOSS_CONFIG.get('REG_LOSS_TYPE', 'WeightedSmoothL1Loss') == 'WeightedL1Loss':
        l1 = diff.abs() * code_w
    else:
        l1 = loss_utils.smooth_l1(diff, beta=1.0 / 9.0) * code_w
    loc_loss = (l1 * reg_weights[..., None]).sum() / b * lw['loc_weight']
    tb['rpn_loss_loc'] = loc_loss
    rpn_loss = cls_loss + loc_loss

    if 'dir_cls_preds' in ret:
        dir_offset = float(model_cfg.DIR_OFFSET)
        num_bins = int(model_cfg.NUM_DIR_BINS)
        sincos = reg_targets.shape[-1] > 7 and model_cfg.TARGET_ASSIGNER_CONFIG.get(
            'BOX_CODER_CONFIG', {}).get('encode_angle_by_sincos', False)
        ra = anchors_flat[None, :, 6]
        if sincos:      # the target carries (cos - cos ra, sin - sin ra)
            gt_rot = torch.atan2(reg_targets[..., 7] + torch.sin(ra),
                                 reg_targets[..., 6] + torch.cos(ra))
        else:
            gt_rot = reg_targets[..., 6] + ra
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
