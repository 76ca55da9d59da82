"""Synthetic LiDAR batches for smoke runs and benchmarks.

Voxel occupancy comes from ray-cast surface scans (``lidar_sim``), so the
rulebook density, per-level dilation and gather locality behave like real
scans. The random stream matches the JAX package's bench batch builder
draw for draw: the same seed gives the same numpy arrays.

A train batch adds ``gt_boxes`` (B, max_objs, 8) and may keep the raw points
as the dataset does (``pad_points``): each scan's points in ray order up to
the cap, then zero rows with ``points_valid`` False. Neither draws from the
random stream.
"""
import numpy as np
import torch

from ..ops.sparse import host_rulebook
from .lidar_sim import simulate_scan, voxelize_coords


def scan_coords(rng, meta, n_fill):
    """Ray-cast scan voxelized to exactly n_fill unique (z, y, x) rows.
    Returns (coords, points, boxes): the voxel rows, the raw scan points and
    the six cars (K, 7) placed in the scene."""
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
    return zyx[sel].astype(np.int64), pts, boxes


# the two fixed gt rows of the JAX package's bench batch (class 1, Car)
BENCH_GT_ROWS = ((10.0, 0.0, -1.0, 3.9, 1.6, 1.5, 0.3, 1),
                 (20.0, -5.0, -1.0, 3.7, 1.6, 1.4, -0.7, 1))


def synthetic_batch_np(meta, batch_size, n_cap, n_fill, n_points, seed=0,
                       gt=None, max_objs=50, pad_points=False, caps_override=None):
    """Numpy batch: voxels from surface scans, VoxelResBackBone8x host
    rulebooks attached, and ``n_points`` raw points per sample from the same
    scans: sampled (wraparound-padded when a scan has fewer), or with
    ``pad_points`` the scan's points first and invalid zero rows after.
    ``gt``: None (no boxes), 'bench' (the JAX bench batch's two rows) or
    'scan' (the six cars of each scan, class 1), padded with zero rows to
    ``max_objs``. ``caps_override``: the level capacities of the rulebooks
    (``host_rulebook.select_mode_caps`` of a yaml's LEVEL_CAPACITIES), or
    None for the derived defaults."""
    if gt not in (None, 'bench', 'scan'):
        raise ValueError(f'gt must be None, "bench" or "scan", not {gt!r}')
    rng = np.random.RandomState(seed)
    p = meta['max_points_per_voxel']
    coords = np.zeros((batch_size, n_cap, 3), np.int32)
    voxels = np.zeros((batch_size, n_cap, p, 4), np.float32)
    nums = np.zeros((batch_size, n_cap), np.int32)
    valid = np.zeros((batch_size, n_cap), bool)
    scan_pts, scan_boxes = [], []
    for b in range(batch_size):
        coords[b, :n_fill], pts_b, boxes_b = scan_coords(rng, meta, n_fill)
        scan_pts.append(pts_b)
        scan_boxes.append(boxes_b)
        voxels[b, :n_fill] = rng.rand(n_fill, p, 4).astype(np.float32)
        nums[b, :n_fill] = rng.randint(1, p + 1, n_fill)
        valid[b, :n_fill] = True
    batch = {'voxels': voxels, 'voxel_coords': coords,
             'voxel_num_points': nums, 'voxel_valid': valid}
    host_rulebook.prepare_batch_rulebooks(batch, 'VoxelResBackBone8x',
                                          meta['grid_size'],
                                          caps_override=caps_override)
    nf = int(meta.get('num_point_features', 4))
    pts = np.zeros((batch_size, n_points, nf), np.float32)
    pts_valid = np.ones((batch_size, n_points), bool)
    for b in range(batch_size):
        src = scan_pts[b][:, :nf]
        if pad_points:                             # the dataset's padding
            n = min(len(src), n_points)
            pts[b, :n, :src.shape[1]] = src[:n]
            pts_valid[b, n:] = False
            continue
        if len(src) >= n_points:
            idx = np.sort(rng.choice(len(src), n_points, replace=False))
        else:                                      # wraparound pad
            idx = np.arange(n_points) % len(src)
        pts[b, :, :src.shape[1]] = src[idx]
    batch['points'] = pts
    batch['points_valid'] = pts_valid
    if gt is not None:
        boxes = np.zeros((batch_size, max_objs, 8), np.float32)
        for b in range(batch_size):
            rows = (np.asarray(BENCH_GT_ROWS, np.float32) if gt == 'bench' else
                    np.concatenate([scan_boxes[b], np.ones((len(scan_boxes[b]), 1),
                                                           np.float32)], 1))
            boxes[b, :len(rows)] = rows[:max_objs]
        batch['gt_boxes'] = boxes
    return batch


def _is_array(v):
    return torch.is_tensor(v) or (isinstance(v, np.ndarray) and v.dtype.kind in 'biuf')


def batch_to_torch(batch_np, device):
    """A batch dict of numpy arrays or tensors (one nesting level for
    ``rulebooks``) -> tensors on ``device``. What is neither (``calib``,
    ``frame_id``, ...) is left out. To a CUDA device the arrays go through
    pinned memory (pinned here unless they are already) with non-blocking
    copies, so the copy overlaps what the card is running."""
    device = torch.device(device)
    pin = device.type == 'cuda'

    def conv(v):
        t = v if torch.is_tensor(v) else torch.from_numpy(np.ascontiguousarray(v))
        if pin:
            return (t if t.is_pinned() else t.pin_memory()).to(device, non_blocking=True)
        return t.to(device)
    out = {}
    for k, v in batch_np.items():
        if isinstance(v, dict):
            out[k] = {kk: conv(vv) for kk, vv in v.items() if _is_array(vv)}
        elif _is_array(v):
            out[k] = conv(v)
    return out
