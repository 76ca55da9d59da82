"""Loss functions with explicit validity masks (counterpart of
``fv2p_tpu/utils/loss_utils.py``, the three the FV2P losses use)."""
import torch


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
