"""Loss functions with explicit validity masks (counterpart of
``fv2p_tpu/utils/loss_utils.py``: the ones FV2P's and MGAF-3DSSD's losses
use)."""
import torch

from . import box_utils, center_utils


def sigmoid_ce_with_logits(logits, labels):
    """max(x, 0) - x * z + log1p(exp(-|x|))."""
    return (torch.clamp(logits, min=0.0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))


def sigmoid_focal_loss(logits, targets, weights, gamma=2.0, alpha=0.25):
    """Per-element sigmoid focal loss times the anchor weights (which may
    lack the class axis)."""
    p = torch.sigmoid(logits)
    alpha_w = targets * alpha + (1 - targets) * (1 - alpha)
    pt = targets * (1.0 - p) + (1.0 - targets) * p
    focal_w = alpha_w * torch.pow(pt, gamma)
    loss = focal_w * sigmoid_ce_with_logits(logits, targets)
    if weights.dim() == loss.dim() - 1:
        weights = weights[..., None]
    return loss * weights


def smooth_l1(diff, beta=1.0):
    n = diff.abs()
    if beta < 1e-5:
        return n
    return torch.where(n < beta, 0.5 * n * n / beta, n - 0.5 * beta)


def centernet_focal_loss(pred_logits, gt_hm, gamma=4.0, alpha=2.0):
    """CornerNet's focal loss on heat maps (B, H, W, C): positives where the
    target is exactly 1, normalised by their number (the negative part
    alone when there is none)."""
    y = torch.clamp(torch.sigmoid(pred_logits), 1e-4, 1 - 1e-4)
    pos = (gt_hm == 1.0).to(y.dtype)
    neg = (gt_hm < 1.0).to(y.dtype)
    neg_weights = torch.pow(1 - gt_hm, gamma)
    pos_loss = (torch.log(y) * torch.pow(1 - y, alpha) * pos).sum()
    neg_loss = (torch.log(1 - y) * torch.pow(y, alpha) * neg_weights * neg).sum()
    num_pos = pos.sum()
    return torch.where(num_pos == 0, -neg_loss,
                       -(pos_loss + neg_loss) / torch.clamp(num_pos, min=1.0))


def centernet_res_loss(output, mask, ind, target, res_func='l1'):
    """Residual loss of the map output (B, H, W, C) gathered at ind (B, K)
    against target (B, K, C): sum(loss * mask) / max(sum(mask), 1), the
    mask summed over (B, K) only."""
    pred = center_utils.gather_feat_nhwc(output, ind)
    if res_func == 'l1':
        loss = (pred - target).abs()
    elif res_func == 'smooth-l1':
        loss = smooth_l1(pred - target)
    else:
        raise NotImplementedError(res_func)
    m = mask.to(loss.dtype)[..., None]
    return (loss * m).sum() / torch.clamp(m.sum(), min=1.0)


def rot_binres_loss(pred, ry_label, mask, num_head_bin=12):
    """Bin + residual heading loss: cross entropy over the bins plus smooth
    l1 on the gt bin's residual, a masked mean over the objects."""
    bin_label, res_norm_label = box_utils.encode_rot_binres(ry_label, num_head_bin)
    bins = pred[..., :num_head_bin]
    res = pred[..., num_head_bin:2 * num_head_bin]
    logp = torch.log_softmax(bins, dim=-1)
    ce = -torch.gather(logp, -1, bin_label[..., None])[..., 0]
    res_pred = torch.gather(res, -1, bin_label[..., None])[..., 0]
    sl1 = smooth_l1(res_pred - res_norm_label)
    m = mask.to(pred.dtype)
    return ((ce + sl1) * m).sum() / torch.clamp(m.sum(), min=1.0)


def corner_loss_mse(pred_boxes, gt_boxes, mask):
    """Masked corner MSE of (N, 7) boxes: per axis the mean over the valid
    boxes' 8 corners, summed over x, y, z."""
    pc = box_utils.boxes_to_corners_3d(pred_boxes)
    gc = box_utils.boxes_to_corners_3d(gt_boxes)
    m = mask.to(pc.dtype)[:, None]
    denom = torch.clamp(m.sum() * 8.0, min=1.0)
    per_axis = ((pc - gc) ** 2 * m[..., None]).sum(dim=(0, 1)) / denom
    return per_axis.sum()


def iouscore_loss_bce(iou_preds, iou_gts, valid_mask, iou_fg_thresh=0.75,
                      iou_bg_thresh=0.25):
    """BCE of sigmoid(iou_preds) against soft labels: 1 above the
    foreground threshold, 0 below the background one, linear between; a
    masked mean."""
    fg = iou_gts > iou_fg_thresh
    bg = iou_gts < iou_bg_thresh
    labels = torch.where(~fg & ~bg,
                         (iou_gts - iou_bg_thresh) / (iou_fg_thresh - iou_bg_thresh),
                         fg.to(iou_preds.dtype))
    p = torch.clamp(torch.sigmoid(iou_preds), 1e-7, 1 - 1e-7)
    bce = -(labels * torch.log(p) + (1 - labels) * torch.log(1 - p))
    m = valid_mask.to(iou_preds.dtype)
    return (bce * m).sum() / torch.clamp(m.sum(), min=1.0)
