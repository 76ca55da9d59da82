"""RoI-aware 3D grid pooling (counterpart of ``fv2p_tpu/ops/roiaware_pool.py``).

Every (RoI, point) pair gets the flat id of the RoI grid cell the point
falls in; the pairs whose point lies inside the box (a valid point, a RoI
of positive size) are kept, and one scatter over them builds all R * S^3
cells: an ``amax`` from -1e10 for 'max', a sum and a count for 'avg'. An
empty cell is exactly 0. No cell caps its points (JAX caps none; the CUDA
reference kept at most ``MAX_POINTS_PER_VOXEL``).

JAX scatters every pair and sends the outside ones to one dropped row. On
the card that row takes nearly all of the 4 M pairs of a KITTI scan's 100
RoIs, and a call at batch 4 took 44-47 ms (`NVIDIA H100 80GB HBM3,
700.00 W`; `PERF.md` §6, PR 13). Keeping the inside pairs (one host wait
for their count) scatters only those.

This is tensor code, as JAX's is XLA outside any Pallas kernel. On the
card the 'avg' sum is a float scatter-add whose order is not fixed, so its
last bits may change from run to run.
"""
import torch

_NEG = -1e10


def roiaware_pool3d(points, point_feats, point_valid, rois, pool_size, method='max'):
    """Pool per-point features into each RoI's local S^3 grid.

    points (N, 3), point_feats (N, C), point_valid (N,) bool, rois (R, 7)
    [x, y, z, dx, dy, dz, heading] (z the box centre); -> (R, S, S, S, C)
    float32, the grid axes ordered (x, y, z)."""
    s = int(pool_size)
    r, n, c = rois.shape[0], points.shape[0], point_feats.shape[1]
    rois = rois.to(torch.float32)
    center, dims = rois[:, None, 0:3], rois[:, None, 3:6]
    shifted = points.to(torch.float32)[None] - center               # (R, N, 3)
    cos, sin = torch.cos(-rois[:, 6:7]), torch.sin(-rois[:, 6:7])
    local = torch.stack([shifted[..., 0] * cos - shifted[..., 1] * sin,
                         shifted[..., 0] * sin + shifted[..., 1] * cos,
                         shifted[..., 2]], dim=-1)
    half = dims / 2.0
    inside = (local.abs() <= half + 1e-5).all(dim=-1)
    inside &= point_valid[None, :] & (rois[:, None, 3] > 0)
    cell = torch.floor((local + half) / (dims / s)).to(torch.int64).clamp(0, s - 1)
    flat = ((torch.arange(r, device=rois.device)[:, None] * s + cell[..., 0]) * s
            + cell[..., 1]) * s + cell[..., 2]
    pair = inside.reshape(r * n).nonzero().squeeze(1)              # the inside pairs
    flat = flat.reshape(r * n)[pair]
    upd = point_feats.to(torch.float32)[pair % n]                  # (M, C)
    cells = r * s ** 3
    if method == 'max':
        grid = upd.new_full((cells, c), _NEG)
        grid = grid.scatter_reduce(0, flat[:, None].expand(-1, c), upd, 'amax',
                                   include_self=True)
        grid = torch.where(grid <= _NEG / 2, torch.zeros_like(grid), grid)
    elif method == 'avg':
        grid = upd.new_zeros((cells, c)).index_add(0, flat, upd)
        cnt = upd.new_zeros(cells).index_add(0, flat, torch.ones_like(flat, dtype=upd.dtype))
        grid = grid / cnt.clamp(min=1.0)[:, None]
    else:
        raise NotImplementedError(method)
    return grid.reshape(r, s, s, s, c)


def roiaware_pool3d_batch(points, point_feats, point_valid, rois, pool_size, method='max'):
    """The leading B axis on every argument, one sample at a time (as JAX's
    ``lax.map``), so that the (R, N) pair tensors are one sample's."""
    return torch.stack([roiaware_pool3d(p, f, v, rr, pool_size, method)
                        for p, f, v, rr in zip(points, point_feats, point_valid, rois)])
