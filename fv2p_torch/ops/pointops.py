"""Point-cloud ops (counterpart of ``fv2p_tpu/ops/pointops.py``):

  * farthest_point_sample_batch  (kernel B2 + wraparound padding)
  * three_nn / three_nn_interpolate(_flat)  (kernel B3 + inverse-distance
    weights)
  * ball_query_group  (gather variant)
  * points_in_boxes_index
  * roipoint_pool3d
  * bilinear_interpolate_bev

All ops use fixed shapes + validity masks, batched over a leading axis.
"""
import torch

from ..utils import common_utils
from .cuda.fps import fps
from .cuda.three_nn import three_nn


def farthest_point_sample_batch(points, valid, num_samples):
    """(B, N, 3), (B, N) bool -> (B, num_samples) int64 indices. When fewer
    than num_samples points are valid, the picks wrap around cyclically."""
    idxs = fps(points, valid, num_samples).long()
    nvalid = valid.sum(dim=-1, keepdim=True)
    ar = torch.arange(num_samples, device=points.device)[None, :]
    wrapped = idxs.gather(1, ar % nvalid.clamp(min=1))
    return torch.where(ar < nvalid, idxs, wrapped)


def three_nn_interpolate(src_xyz, src_valid, src_feats, query_xyz):
    """Inverse-distance top-3 interpolation of source features onto queries,
    batched: src (B, N, 3), src_valid (B, N), src_feats (B, N, C),
    query (B, M, 3) -> (B, M, C). weight = (1/(d2+1e-8)) / sum."""
    b, n, c = src_feats.shape
    return three_nn_interpolate_flat(src_xyz, src_valid, src_feats.reshape(b * n, c),
                                     query_xyz, sample_rows=n)


def three_nn_interpolate_flat(src_xyz, src_valid, src_feats, query_xyz, sample_rows=0):
    """``three_nn_interpolate`` with the features of all sources in one
    array src_feats (R, C): query set b's neighbours are the rows
    ``b * sample_rows + idx``. With ``sample_rows`` 0 every query set
    searches one source array shared by the batch (src (B, N, 3) and
    src_valid (B, N) per set, the indices rows of src_feats)."""
    d, idx = three_nn(src_xyz, src_valid, query_xyz)
    w = 1.0 / (d + 1e-8)
    w = w / w.sum(dim=-1, keepdim=True)
    off = torch.arange(idx.shape[0], device=idx.device)[:, None, None] * sample_rows
    return (src_feats[idx.long() + off] * w[..., None]).sum(dim=2)


def first_k_hits(hits, k):
    """(..., N) bool -> (..., k) int64: indices of the first k True entries
    in ascending order, -1 where the row has fewer."""
    n = hits.shape[-1]
    iota = torch.arange(n, device=hits.device)
    masked = torch.where(hits, iota, n)
    kk = min(k, n)
    vals = torch.topk(masked, kk, dim=-1, largest=False, sorted=True).values
    if kk < k:
        pad = vals.new_full(vals.shape[:-1] + (k - kk,), n)
        vals = torch.cat([vals, pad], dim=-1)
    return torch.where(vals < n, vals, -1)


def ball_query_group(new_xyz, xyz, xyz_valid, feats, radius, nsample, d2):
    """First nsample points within radius of each query (index order, empty
    slots backfilled with the first hit), batched over a leading axis.

    new_xyz (R, M, 3), xyz (R, N, 3), xyz_valid (R, N), feats (R, N, C),
    d2 (R, M, N) squared distances -> grouped_xyz (R, M, S, 3) relative,
    grouped_feats (R, M, S, C), any_neighbor (R, M); empty balls are zero.
    """
    r, m, _ = new_xyz.shape
    idx = first_k_hits((d2 < radius * radius) & xyz_valid[:, None, :], nsample)
    any_neighbor = idx[..., 0] >= 0
    idx = torch.where(idx >= 0, idx, idx[..., :1].clamp(min=0))
    dt = torch.promote_types(xyz.dtype, feats.dtype)
    rows_src = torch.cat([xyz.to(dt), feats.to(dt)], dim=-1)      # (R, N, 3+C)
    rows = torch.gather(
        rows_src, 1,
        idx.reshape(r, m * nsample, 1).expand(-1, -1, rows_src.shape[-1]))
    rows = rows.reshape(r, m, nsample, -1)
    grouped_xyz = rows[..., :3] - new_xyz[:, :, None, :].to(rows.dtype)
    grouped_feats = rows[..., 3:]
    zero = ~any_neighbor[:, :, None, None]
    return (grouped_xyz.masked_fill(zero, 0.0),
            grouped_feats.masked_fill(zero, 0.0), any_neighbor)


def points_in_boxes_index(points, boxes, boxes_valid):
    """The first box (in box order) that contains each point, -1 if none.
    points (N, 3), boxes (M, 7) center-based, boxes_valid (M,)."""
    from ..utils import iou3d
    inside = iou3d.points_in_rotated_boxes(points, boxes) & boxes_valid[:, None]
    m = boxes.shape[0]
    box_ids = torch.arange(m, device=points.device)[:, None]
    first = torch.where(inside, box_ids, m).amin(dim=0)
    return torch.where(first < m, first, -1)


def roipoint_pool3d(points, point_feats, rois, num_sampled, pool_extra_width):
    """Pool the first num_sampled points inside each enlarged RoI, padded by
    wraparound of the collected indices.

    points (B, N, 3), point_feats (B, N, C), rois (B, R, 7) ->
    pooled (B, R, num_sampled, 3 + C), empty_flag (B, R).
    """
    from ..utils import iou3d
    b, n, _ = points.shape
    extra = common_utils.device_constant(pool_extra_width, rois.dtype, rois.device)
    enlarged = torch.cat([rois[..., :3], rois[..., 3:6] + extra, rois[..., 6:7]],
                         dim=-1)
    inside = torch.stack([iou3d.points_in_rotated_boxes(points[i], enlarged[i])
                          for i in range(b)])                      # (B, R, N)
    idx = first_k_hits(inside, num_sampled)
    cnt = inside.sum(dim=-1)
    empty = cnt == 0
    ar = torch.arange(num_sampled, device=points.device)
    wrap = torch.gather(idx.clamp(min=0), 2,
                        (ar % cnt.clamp(min=1)[..., None]))
    idx = torch.where(idx >= 0, idx, wrap).clamp(min=0)
    src = torch.cat([points, point_feats.to(points.dtype)], dim=-1)  # (B,N,3+C)
    r = rois.shape[1]
    pooled = torch.gather(
        src, 1, idx.reshape(b, r * num_sampled, 1).expand(-1, -1, src.shape[-1]))
    pooled = pooled.reshape(b, r, num_sampled, -1)
    return pooled.masked_fill(empty[..., None, None], 0.0), empty


def bilinear_interpolate_bev(im, x, y):
    """im (H, W, C); x, y (N,) fractional pixel coords -> (N, C). Corner
    indices are clamped into the map; weights use the unclamped offsets."""
    h, w = im.shape[0], im.shape[1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    x0i = x0.long()
    y0i = y0.long()
    x1c = (x0i + 1).clamp(0, w - 1)
    y1c = (y0i + 1).clamp(0, h - 1)
    x0c = x0i.clamp(0, w - 1)
    y0c = y0i.clamp(0, h - 1)

    ia = im[y0c, x0c]
    ib = im[y1c, x0c]
    ic = im[y0c, x1c]
    id_ = im[y1c, x1c]

    x1f = x0 + 1.0
    y1f = y0 + 1.0
    wa = (x1f - x) * (y1f - y)
    wb = (x1f - x) * (y - y0)
    wc = (x - x0) * (y1f - y)
    wd = (x - x0) * (y - y0)
    return (ia * wa[:, None] + ib * wb[:, None] + ic * wc[:, None]
            + id_ * wd[:, None])
