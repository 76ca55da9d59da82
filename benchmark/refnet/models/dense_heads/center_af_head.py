# Frozen at commit c8e3fcd from fv2p_torch/models/dense_heads/center_af_head.py, unchanged.
"""Center-based anchor-free head with mask-guided attention (counterpart of
``fv2p_tpu/models/dense_heads/center_af_head.py``: ``_FCHead``,
``CenterAFHeadSingle`` and ``center_af_head_loss``).

The convolutions run on NCHW views of the channels-last BEV map; the
predictions and the decoded boxes are f32 and channels-last, as in JAX.
Module names follow the flax names, so the weight loader maps them one to
one. In training the head adds the CenterNet targets, the top
``NUM_IOUSCORE_TRAINING_SAMPLES`` decoded boxes and the boxes decoded at
the gt centers to its outputs; ``center_af_head_loss`` turns them into the
eight loss terms, the iou-score targets through kernel B1 (3D IoU of the
decoded boxes against the gt, one call per scan)."""
import torch
from torch import nn

# a module reference, not a name: ops.dcn imports models.layers, and so this
# module may be reached while ops.dcn is still initialising
from ...ops import dcn
from ...utils import box_utils, center_utils, iou3d, loss_utils
from ..layers import BatchNorm, Conv2d
from .center_target_assigner import CenterTargetAssigner


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


class _FCHead(nn.Module):
    """conv3x3 -> BN -> ReLU -> conv (final_kernel, with bias); f32 out."""

    def __init__(self, cin, head_conv, out_channel, final_kernel=1,
                 compute_dtype=None):
        super().__init__()
        self.Conv_0 = Conv2d(cin, head_conv, 3, padding=1, bias=False,
                             compute_dtype=compute_dtype)
        self.BatchNorm_0 = BatchNorm(head_conv, axis=1)
        self.Conv_1 = Conv2d(head_conv, out_channel, final_kernel,
                             padding=(final_kernel - 1) // 2,
                             compute_dtype=compute_dtype)

    def forward(self, x):
        x = torch.relu(self.BatchNorm_0(self.Conv_0(x)))
        return self.Conv_1(x).float()


class CenterAFHeadSingle(nn.Module):
    """Shared conv + BN (eps 1e-5) -> MDCN feature adaptation (4 deformable
    groups) -> segm head and the attention x + sigmoid(segm) * x (no
    gradient through sigmoid(segm)) -> one fused 3x3 conv for the other
    heads, sliced per head into its output conv. In eval mode: max-pool NMS
    and top-K decode (K = NUM_INFERENCE_SAMPLES) into the batch dict. In
    training: the targets of ``batch_dict['gt_boxes']``, the top-K decode
    (K = NUM_IOUSCORE_TRAINING_SAMPLES) and the decode at the gt centers,
    all in ``head_ret``."""

    def __init__(self, model_cfg, input_channels, num_class, voxel_size,
                 point_cloud_range, compute_dtype=None):
        super().__init__()
        cfg = model_cfg
        self.model_cfg = cfg
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        self.assigner = CenterTargetAssigner(cfg, num_class, voxel_size,
                                             point_cloud_range)
        cd = compute_dtype
        cin = input_channels
        self.n_shared = len(cfg.SHARED_FC)
        for i, ch in enumerate(cfg.SHARED_FC):
            ks = int(cfg.SHARED_KS[i])
            setattr(self, f'shared_conv{i}', Conv2d(
                cin, ch, ks, padding=(ks - 1) // 2, bias=False, compute_dtype=cd))
            # torch-default eps here, unlike the heads' BatchNorms
            setattr(self, f'shared_bn{i}', BatchNorm(ch, axis=1, eps=1e-5))
            cin = ch
        self.use_dcn = cfg.get('USE_DCN', False) in ('DCN', 'MDCN')
        if self.use_dcn:
            self.feature_adapt = dcn.FeatureAdaption(cin, cin, 3,
                                                     deformable_groups=4,
                                                     compute_dtype=cd)
        heads = {h['name']: h for h in cfg.HEADS_CONFIG}
        segm = heads['segm']
        self.segm = _FCHead(cin, int(segm['head_conv']), int(segm['out_channel']),
                            int(segm['final_kernel']), cd)
        self.others = [(name, h) for name, h in heads.items() if name != 'segm']
        widths = [int(h['head_conv']) for _, h in self.others]
        self.heads_fused_conv = Conv2d(cin, sum(widths), 3, padding=1,
                                       bias=False, compute_dtype=cd)
        self.heads_fused_bn = BatchNorm(sum(widths), axis=1)
        for (name, h), width in zip(self.others, widths):
            out_ch = num_class if name == 'hm' else int(h['out_channel'])
            fk = int(h['final_kernel'])
            setattr(self, f'{name}_out', Conv2d(width, out_ch, fk,
                                                padding=(fk - 1) // 2,
                                                compute_dtype=cd))
        self.widths = widths

    def forward(self, batch_dict):
        x = _nchw(batch_dict['spatial_features_2d'])
        for i in range(self.n_shared):
            x = getattr(self, f'shared_conv{i}')(x)
            x = torch.relu(getattr(self, f'shared_bn{i}')(x))
        if self.use_dcn:
            x = _nchw(self.feature_adapt(_nhwc(x)))

        segm_pred = self.segm(x)
        att = x + torch.sigmoid(segm_pred.detach()) * x
        batch_dict['spatial_features_before_head'] = _nhwc(att)
        ret = {'segm_pred': _nhwc(segm_pred)}

        mid = torch.relu(self.heads_fused_bn(self.heads_fused_conv(att)))
        offset = 0
        for (name, _), width in zip(self.others, self.widths):
            sl = mid[:, offset:offset + width]
            ret[f'{name}_pred'] = _nhwc(getattr(self, f'{name}_out')(sl).float())
            offset += width

        cfg = self.model_cfg
        stride = int(cfg.TARGET_ASSIGNER_CONFIG.FEATURE_MAP_STRIDE)
        if self.training:
            ret.update(self.assigner.assign_targets(batch_dict['gt_boxes']))
            ret.update(self.decode_predhm_ssd(
                ret, int(cfg.NUM_IOUSCORE_TRAINING_SAMPLES), stride))
            ret.update(self.decode_gthm(ret, stride))
        else:
            batch_dict.update(self.decode_predhm_ssd(
                ret, int(cfg.NUM_INFERENCE_SAMPLES), stride))
            batch_dict['cls_preds_normalized'] = False
        batch_dict['head_ret'] = ret
        return batch_dict

    def _decode_common(self, ret, inds, xs, ys, stride):
        b, k = inds.shape
        offset = center_utils.gather_feat_nhwc(ret['offset_pred'], inds)
        xs = xs[..., None] + offset[:, :, 0:1]
        ys = ys[..., None] + offset[:, :, 1:2]
        height = center_utils.gather_feat_nhwc(ret['height_pred'], inds)
        dim = center_utils.gather_feat_nhwc(ret['dim_pred'], inds)
        rot_feat = center_utils.gather_feat_nhwc(ret['rot_pred'], inds)
        num_bins = rot_feat.shape[-1] // 2
        rot = box_utils.decode_rot_binres(
            rot_feat.reshape(b * k, -1), num_head_bin=num_bins).reshape(b, k, 1)
        vx, vy = self.voxel_size[0], self.voxel_size[1]
        x0, y0 = self.point_cloud_range[0], self.point_cloud_range[1]
        xs = xs * stride * vx + x0
        ys = ys * stride * vy + y0
        # the dims stay as the head predicts them (no exp): a box may come out
        # with a negative or zero extent
        return torch.cat([xs, ys, height, dim, rot], dim=2)

    def decode_predhm_ssd(self, ret, k, stride):
        """Max-pool NMS + top-k decode: batch_box_preds (B, K, 7),
        batch_cls_preds (B, K, C) raw suppressed heat logits,
        batch_iouscore_preds (B, K, 1)."""
        heat = center_utils.heatmap_maxpool_nms(ret['hm_pred'])
        _, inds, _, ys, xs = center_utils.topk_heatmap(heat, k)
        return {
            'batch_box_preds': self._decode_common(ret, inds, xs, ys, stride),
            'batch_cls_preds': center_utils.gather_feat_nhwc(heat, inds),
            'batch_iouscore_preds': center_utils.gather_feat_nhwc(
                ret['iouscore_pred'], inds),
        }

    def decode_gthm(self, ret, stride):
        """The boxes decoded at the gt centers (``ind_target``,
        ``xsys_target``), for the corner loss: gthm_box_preds (B, MAX_OBJS, 7)."""
        xsys = ret['xsys_target']
        return {'gthm_box_preds': self._decode_common(
            ret, ret['ind_target'], xsys[:, :, 0], xsys[:, :, 1], stride)}


def center_af_head_loss(model_cfg, ret):
    """The eight loss terms of the head's train outputs ``ret``, each times
    its weight, and their sum: (rpn_loss, terms)."""
    cfg = model_cfg.LOSS_CONFIG
    tb = {}
    tb['rpn_hm_loss'] = loss_utils.centernet_focal_loss(
        ret['hm_pred'], ret['hm_target']) * cfg.HM_LOSS_CONFIG['weight']
    mask, ind, anno = ret['mask_target'], ret['ind_target'], ret['anno_box_target']
    for name, key, sl in (('offset', 'OFFSET', slice(0, 2)),
                          ('height', 'HEIGHT', slice(2, 3)),
                          ('dim', 'DIM', slice(3, 6))):
        lcfg = cfg[f'{key}_LOSS_CONFIG']
        tb[f'rpn_{name}_loss'] = loss_utils.centernet_res_loss(
            ret[f'{name}_pred'], mask, ind, anno[:, :, sl],
            lcfg.get('res_func', 'l1')) * lcfg['weight']
    rot_pred = center_utils.gather_feat_nhwc(ret['rot_pred'], ind)
    tb['rpn_rot_loss'] = loss_utils.rot_binres_loss(
        rot_pred, anno[:, :, 6], mask,
        num_head_bin=int(cfg.ROT_LOSS_CONFIG['num_bins'])) * cfg.ROT_LOSS_CONFIG['weight']
    tb['rpn_segm_loss'] = _segm_loss(ret) * cfg.SEGM_LOSS_CONFIG['weight']
    tb['rpn_corner_loss'] = _corner_loss(ret) * cfg.CORNER_LOSS_CONFIG['weight'] / 3.0
    tb['rpn_iouscore_loss'] = _iouscore_loss(ret, cfg.IOUSCORE_LOSS_CONFIG) \
        * cfg.IOUSCORE_LOSS_CONFIG['weight']
    rpn_loss = sum(tb[f'rpn_{n}_loss'] for n in (
        'hm', 'offset', 'height', 'dim', 'rot', 'segm', 'corner', 'iouscore'))
    tb['rpn_loss'] = rpn_loss
    return rpn_loss, tb


def _segm_loss(ret):
    """Sigmoid focal loss of the segmentation map, each scan's cells
    weighted by 1 / its number of foreground cells (at least 1), summed and
    divided by the batch size."""
    pred, target = ret['segm_pred'], ret['segm_target']
    b = pred.shape[0]
    pred_flat = pred.reshape(b, -1, pred.shape[-1])
    target_flat = target.reshape(b, -1, target.shape[-1])
    positives = target_flat > 0
    cls_weights = (positives | (target_flat == 0)).to(torch.float32)
    pos_norm = torch.clamp(positives.to(torch.float32).sum(1, keepdim=True), min=1.0)
    loss = loss_utils.sigmoid_focal_loss(pred_flat, target_flat.to(torch.float32),
                                         (cls_weights / pos_norm)[..., 0])
    return loss.sum() / b


def _corner_loss(ret):
    return loss_utils.corner_loss_mse(ret['gthm_box_preds'].reshape(-1, 7),
                                      ret['src_box_target'].reshape(-1, 7),
                                      ret['mask_target'].reshape(-1))


def iouscore_targets(ret):
    """The iou-score head's targets (B, K): for each decoded box, its best
    3D IoU with a valid gt box of its class (0 without one). The boxes are
    detached (B1 has no backward); one B1 call per scan."""
    box_pred = ret['batch_box_preds'].detach()
    cls_pred = torch.argmax(ret['batch_cls_preds'], dim=-1) + 1
    gt = ret['batch_gtboxes_src']
    gt_boxes, gt_cls = gt[..., 0:7], gt[..., 7].to(torch.int64)
    gt_valid = gt_boxes.abs().sum(-1) > 0
    best = []
    for bp, bc, gb, gc, gv in zip(box_pred, cls_pred, gt_boxes, gt_cls, gt_valid):
        ious = iou3d.boxes_iou3d(bp, gb)                         # (K, M)
        same = (bc[:, None] == gc[None, :]) & gv[None, :]
        best.append(torch.where(same, ious, 0.0).amax(dim=1))
    return torch.stack(best)


def _iouscore_loss(ret, cfg):
    roi_iou = iouscore_targets(ret)
    iou_pred = ret['batch_iouscore_preds'][..., 0]
    return loss_utils.iouscore_loss_bce(
        iou_pred.reshape(-1), roi_iou.reshape(-1),
        torch.ones_like(roi_iou, dtype=torch.bool).reshape(-1),
        iou_fg_thresh=float(cfg['iou_fg_thresh']),
        iou_bg_thresh=float(cfg['iou_bg_thresh']))
