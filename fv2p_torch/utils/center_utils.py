"""CenterNet-style decode utilities (counterpart of the inference half of
``fv2p_tpu/utils/center_utils.py``). Feature maps are channels-last,
(B, H, W, C) with H == sizey and W == sizex. The Gaussian and polygon
target drawing belongs to training and is not ported yet."""
import torch
import torch.nn.functional as F


def gather_feat_nhwc(feat, ind):
    """feat (B, H, W, C), ind (B, K) flat indices y * W + x -> (B, K, C)."""
    b, h, w, c = feat.shape
    return torch.gather(feat.reshape(b, h * w, c), 1,
                        ind[..., None].expand(-1, -1, c))


def heatmap_maxpool_nms(heat, kernel=3):
    """Keep only local maxima of heat (B, H, W, C) over a kernel x kernel
    window (borders padded with -inf); every other cell becomes 0.0. Ties
    keep all equal-max cells."""
    pad = (kernel - 1) // 2
    hmax = F.max_pool2d(heat.permute(0, 3, 1, 2), kernel, stride=1,
                        padding=pad).permute(0, 2, 3, 1)
    return torch.where(hmax == heat, heat, 0.0)


def _top_k(x, k):
    """(values, indices) of the k largest entries of the last axis, equal
    values in index order (as ``jax.lax.top_k``; torch.topk promises no
    order among ties)."""
    values, order = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], order[..., :k]


def topk_heatmap(scores, k):
    """Per-class top-k, then the global top-k of those.

    scores (B, H, W, C) -> (score (B, K), flat index y * W + x (B, K),
    class (B, K), y (B, K), x (B, K)); class, y and x as float32."""
    b, h, w, c = scores.shape
    flat = scores.permute(0, 3, 1, 2).reshape(b, c, h * w)
    cls_scores, cls_inds = _top_k(flat, k)                   # (B, C, K)
    glob_scores, glob_ind = _top_k(cls_scores.reshape(b, c * k), k)
    topk_classes = (glob_ind // k).to(torch.float32)
    topk_inds = torch.gather(cls_inds.reshape(b, c * k), 1, glob_ind)
    topk_ys = (topk_inds // w).to(torch.float32)
    topk_xs = (topk_inds % w).to(torch.float32)
    return glob_scores, topk_inds, topk_classes, topk_ys, topk_xs
