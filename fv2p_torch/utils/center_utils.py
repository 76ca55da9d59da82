"""CenterNet-style utilities (counterpart of ``fv2p_tpu/utils/center_utils.py``):
the decode (gather, max-pool NMS, top-K) and the target drawing (Gaussian
radius, Gaussian splats, convex-quad rasters). Feature maps are
channels-last, (B, H, W, C) with H == sizey and W == sizex."""
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


def gaussian_radius(height, width, min_overlap=0.5):
    """CornerNet's radius heuristic, elementwise: the least of the three
    roots."""
    a1 = 1.0
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    sq1 = torch.sqrt(torch.clamp(b1 ** 2 - 4 * a1 * c1, min=0.0))
    r1 = (b1 - sq1) / (2 * a1)

    a2 = 4.0
    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    sq2 = torch.sqrt(torch.clamp(b2 ** 2 - 4 * a2 * c2, min=0.0))
    r2 = (b2 - sq2) / (2 * a2)

    a3 = 4.0 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    sq3 = torch.sqrt(torch.clamp(b3 ** 2 - 4 * a3 * c3, min=0.0))
    r3 = (b3 + sq3) / (2 * a3)
    return torch.minimum(torch.minimum(r1, r2), r3)


def pixel_grid(h, w, device):
    """(ys, xs): the (H, W) f32 row and column numbers."""
    ys = torch.arange(h, device=device, dtype=torch.float32)[:, None].expand(h, w)
    xs = torch.arange(w, device=device, dtype=torch.float32)[None, :].expand(h, w)
    return ys, xs


def gaussian_splats(centers, radius, valid, h, w):
    """Each object's Gaussian on an (H, W) map: exp(-(dx^2 + dy^2) /
    (2 sigma^2)), sigma = (2 r + 1) / 6, inside the (2r + 1)-square around
    its integer center (x, y) and 0 elsewhere or where ``valid`` is False.
    centers (M, 2), radius (M,) -> (M, H, W)."""
    ys, xs = pixel_grid(h, w, centers.device)
    cx = centers[:, 0].to(torch.float32)[:, None, None]
    cy = centers[:, 1].to(torch.float32)[:, None, None]
    r = radius[:, None, None]
    sigma = (2.0 * r + 1.0) / 6.0
    dx = xs - cx
    dy = ys - cy
    g = torch.exp(-(dx * dx + dy * dy) / (2.0 * sigma * sigma))
    inside = (dx.abs() <= r) & (dy.abs() <= r) & valid[:, None, None]
    return torch.where(inside, g, 0.0)


def draw_gaussians(map_hw, centers_int, radius, valid):
    """Max-splat per-object Gaussians (``gaussian_splats``) onto one (H, W)
    heat map; centers_int (M, 2) integer (x, y), radius (M,) integer-valued,
    valid (M,) bool. The max makes the order of the objects irrelevant."""
    h, w = map_hw.shape
    splats = gaussian_splats(centers_int, radius, valid, h, w)
    return torch.maximum(map_hw, splats.amax(dim=0)) if len(splats) else map_hw


def fill_convex_quad(h, w, corners_xy, valid):
    """Per-object masks (M, H, W) of the pixels (x, y) inside each valid
    convex quad (M, 4, 2) of corner pixel coordinates, edges included (a
    cross product of at least -1e-6 counts as inside); the winding is
    normalised by the sign of the signed area."""
    ys, xs = pixel_grid(h, w, corners_xy.device)
    x, y = corners_xy[..., 0], corners_xy[..., 1]
    area = 0.5 * (x * torch.roll(y, -1, dims=-1) - torch.roll(x, -1, dims=-1) * y).sum(-1)
    sgn = torch.sign(area)[:, None, None]
    inside = torch.ones((corners_xy.shape[0], h, w), dtype=torch.bool,
                        device=corners_xy.device)
    for e in range(4):
        p1 = corners_xy[:, e]
        p2 = corners_xy[:, (e + 1) % 4]
        ex = (p2[:, 0] - p1[:, 0])[:, None, None]
        ey = (p2[:, 1] - p1[:, 1])[:, None, None]
        rx = xs[None] - p1[:, 0][:, None, None]
        ry = ys[None] - p1[:, 1][:, None, None]
        inside = inside & ((ex * ry - ey * rx) * sgn >= -1e-6)
    return inside & valid[:, None, None]
