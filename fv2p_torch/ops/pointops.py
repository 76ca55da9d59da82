"""Point-cloud ops (counterpart of ``fv2p_tpu/ops/pointops.py``):

  * farthest_point_sample_batch  (kernel B2 + wraparound padding)
  * three_nn / three_nn_interpolate(_flat)  (kernel B3 + inverse-distance
    weights)
  * ball_query_group  (gather variant, over a given distance matrix)
  * ball_query_rows + group_rows  (the same search in bounded memory, over
    each sample's own rows of a batch-flat source array)
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
    in ascending order, -1 where the row has fewer. The candidates are
    int32, half the bytes of the (..., N) temporary."""
    n = hits.shape[-1]
    iota = torch.arange(n, dtype=torch.int32, device=hits.device)
    masked = torch.where(hits, iota, n)
    kk = min(k, n)
    vals = torch.topk(masked, kk, dim=-1, largest=False, sorted=True).values.long()
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


# (query, source) pairs one chunk of ``ball_query_rows`` searches: about 13
# bytes each (f32 distance and square, in-ball mask, int32 candidate index),
# some 440 MB of temporaries whatever the number of queries and sources
BALL_QUERY_PAIRS = 1 << 25


def ball_query_rows(new_xyz, xyz, xyz_valid, bounds, radii, nsamples,
                    max_pairs=BALL_QUERY_PAIRS):
    """For each query of sample b and each radius, the first nsample valid
    rows of sample b's sources within the radius, in row order.

    new_xyz (B, M, 3); xyz (N, 3), xyz_valid (N,): the sources of the whole
    batch in one array, sample b's rows ``[bounds[b], bounds[b + 1])``
    (``bounds``: B + 1 host ints). Returns one (B, M, nsample) int64 tensor
    of rows per radius, -1 past a ball's count. These are the rows of the
    dense search over all N sources with the other samples' rows masked
    (JAX's batch-flat form), found chunk by chunk: a chunk is a block of
    one sample's queries against a block of its sources, at most
    ``max_pairs`` pairs, whose first hits are appended to those of the
    earlier source blocks. The distances are computed once for all radii.
    """
    b, m, _ = new_xyz.shape
    out = [torch.full((b, m, int(ns)), -1, dtype=torch.int64, device=new_xyz.device)
           for ns in nsamples]
    q_all = new_xyz.detach().float()
    src = xyz.detach().float()
    with torch.no_grad():
        for i in range(b):
            start, end = int(bounds[i]), int(bounds[i + 1])
            if end <= start:
                continue
            s_step = min(end - start, max_pairs)
            q_step = max(1, max_pairs // s_step)
            for a in range(0, m, q_step):
                q = q_all[i, a:a + q_step]
                found = [None] * len(out)
                for c in range(start, end, s_step):
                    sx, sy, sz = src[c:min(c + s_step, end)].unbind(-1)
                    nc = sx.shape[0]
                    d2 = q[:, 0:1] - sx
                    d2.mul_(d2)
                    t = q[:, 1:2] - sy
                    d2.add_(t.mul_(t))
                    t = q[:, 2:3] - sz
                    d2.add_(t.mul_(t))
                    del t
                    valid = xyz_valid[c:c + nc]
                    for j, (r, ns) in enumerate(zip(radii, nsamples)):
                        first = first_k_hits((d2 < float(r) * float(r)) & valid, int(ns))
                        rows = torch.where(first >= 0, first + c, -1)
                        found[j] = rows if found[j] is None else _append_hits(found[j], rows)
                for j, o in enumerate(out):
                    o[i, a:a + q_step] = found[j]
    return out


def _append_hits(acc, new):
    """The first hits of two source blocks in order: acc and new (Q, S),
    each its rows first and -1 after -> (Q, S)."""
    ns = acc.shape[1]
    cnt = (acc >= 0).sum(dim=1, keepdim=True)
    slot = torch.arange(ns, device=acc.device)[None, :]
    take = (slot - cnt).clamp(0, ns - 1)
    return torch.where(slot < cnt, acc, new.gather(1, take))


def group_rows(new_xyz, xyz, feats, idx):
    """Gather the rows ``ball_query_rows`` found: new_xyz (B, M, 3), xyz
    (N, 3), feats (N, C), idx (B, M, S) -> grouped_xyz (B, M, S, 3)
    relative to the query, grouped_feats (B, M, S, C), any_neighbor (B, M).
    Empty slots repeat the ball's first row; empty balls are zero
    (``ball_query_group``'s output). The gather is an ``index_select``,
    whose backward adds into the sources with ``index_add_``: the default
    backward of ``src[idx]`` sorts the indices and adds each row's
    duplicates one after another, and every empty ball sends all its slots
    to row 0, hundreds of thousands of them at a RoI grid."""
    any_neighbor = idx[..., 0] >= 0
    idx = torch.where(idx >= 0, idx, idx[..., :1].clamp(min=0))
    dt = torch.promote_types(xyz.dtype, feats.dtype)
    src = torch.cat([xyz.to(dt), feats.to(dt)], dim=-1)
    rows = torch.index_select(src, 0, idx.reshape(-1)).reshape(idx.shape + src.shape[-1:])
    zero = ~any_neighbor[..., None, None]
    grouped_xyz = rows[..., :3] - new_xyz[:, :, None, :].to(dt)
    return (grouped_xyz.masked_fill(zero, 0.0),
            rows[..., 3:].masked_fill(zero, 0.0), any_neighbor)


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
