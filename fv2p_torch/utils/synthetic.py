"""Synthetic LiDAR batches for smoke runs and benchmarks.

Voxel occupancy comes from ray-cast surface scans (``lidar_sim``), so the
rulebook density, per-level dilation and gather locality behave like real
scans. The random stream matches the JAX package's bench batch builder
draw for draw: the same seed gives the same numpy arrays.
"""
import numpy as np
import torch

from ..ops.sparse import host_rulebook
from .lidar_sim import simulate_scan, voxelize_coords


def scan_coords(rng, meta, n_fill):
    """Ray-cast scan voxelized to exactly n_fill unique (z, y, x) rows.
    Returns (coords, points): the voxel rows plus the raw scan points."""
    nx, ny, nz = meta['grid_size']
    boxes = np.stack([
        np.array([rng.uniform(8, 60), rng.uniform(-25, 25), -1.0,
                  3.9, 1.6, 1.56, rng.uniform(-3, 3)], np.float32)
        for _ in range(6)])
    pc_range = np.asarray(meta['point_cloud_range'], np.float32)
    vs = (pc_range[3:] - pc_range[:3]) / np.array([nx, ny, nz], np.float32)
    pts = simulate_scan(rng, boxes)
    zyx = voxelize_coords(pts, vs, pc_range)
    while len(zyx) < n_fill:                    # densify: more azimuth steps
        pts = simulate_scan(rng, boxes, azim_steps=760)
        extra = voxelize_coords(pts, vs, pc_range)
        zyx = np.unique(np.concatenate([zyx, extra]), axis=0)
    sel = np.sort(rng.choice(len(zyx), n_fill, replace=False))
    return zyx[sel].astype(np.int64), pts


def synthetic_batch_np(meta, batch_size, n_cap, n_fill, n_points, seed=0):
    """Numpy batch: voxels from surface scans, VoxelResBackBone8x host
    rulebooks attached, and ``n_points`` raw points per sample from the same
    scans (wraparound-padded when a scan has fewer)."""
    rng = np.random.RandomState(seed)
    p = meta['max_points_per_voxel']
    coords = np.zeros((batch_size, n_cap, 3), np.int32)
    voxels = np.zeros((batch_size, n_cap, p, 4), np.float32)
    nums = np.zeros((batch_size, n_cap), np.int32)
    valid = np.zeros((batch_size, n_cap), bool)
    scan_pts = []
    for b in range(batch_size):
        coords[b, :n_fill], pts_b = scan_coords(rng, meta, n_fill)
        scan_pts.append(pts_b)
        voxels[b, :n_fill] = rng.rand(n_fill, p, 4).astype(np.float32)
        nums[b, :n_fill] = rng.randint(1, p + 1, n_fill)
        valid[b, :n_fill] = True
    batch = {'voxels': voxels, 'voxel_coords': coords,
             'voxel_num_points': nums, 'voxel_valid': valid}
    host_rulebook.prepare_batch_rulebooks(batch, 'VoxelResBackBone8x',
                                          meta['grid_size'])
    nf = int(meta.get('num_point_features', 4))
    pts = np.zeros((batch_size, n_points, nf), np.float32)
    for b in range(batch_size):
        src = scan_pts[b][:, :nf]
        if len(src) >= n_points:
            idx = np.sort(rng.choice(len(src), n_points, replace=False))
        else:                                      # wraparound pad
            idx = np.arange(n_points) % len(src)
        pts[b, :, :src.shape[1]] = src[idx]
    batch['points'] = pts
    batch['points_valid'] = np.ones((batch_size, n_points), bool)
    return batch


def batch_to_torch(batch_np, device):
    """numpy batch dict (one nesting level for ``rulebooks``) -> tensors."""
    def conv(v):
        return torch.from_numpy(np.ascontiguousarray(v)).to(device)
    return {k: ({kk: conv(vv) for kk, vv in v.items()} if isinstance(v, dict)
                else conv(v))
            for k, v in batch_np.items()}
