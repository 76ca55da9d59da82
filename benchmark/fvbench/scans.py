"""Ray-cast LiDAR scans and the benchmark's input batches, drawn from a seed.

Frozen at commit c8e3fcd from ``fv2p_torch/utils/lidar_sim.py`` (the scan
simulator, unchanged) and from the draw part of
``fv2p_torch/utils/synthetic.py`` (``scan_coords`` unchanged; ``draw_batch``
is ``synthetic_batch_np`` without the rulebooks, which each side builds for
itself, and with the scan's raw points sampled and then padded as the
traffic file says).

The simulator casts a spinning multi-beam LiDAR (HDL-64-like geometry,
KITTI's front field of view) against a ground plane, oriented boxes, poles
and walls, so the voxels lie on surfaces as real scans' do: strided sparse
convs merge neighbouring cells instead of dilating isolated ones.
"""
import numpy as np

GROUND_Z = -1.73           # KITTI velodyne height above ground (m)
MAX_RANGE = 71.0


def _ray_dirs(n_beams, azim_steps, fov=(-0.78, 0.78),
              elev=(-0.4328, 0.0349)):
    """Unit ray directions (n_beams * azim_steps, 3), velodyne frame."""
    az = np.linspace(fov[0], fov[1], azim_steps, dtype=np.float32)
    el = np.linspace(elev[0], elev[1], n_beams, dtype=np.float32)
    az, el = np.meshgrid(az, el)
    az, el = az.ravel(), el.ravel()
    ce = np.cos(el)
    return np.stack([ce * np.cos(az), ce * np.sin(az), np.sin(el)], 1)


def _ray_box_t(dirs, box):
    """Slab-test hit distance of rays from the origin against one 7-dof box
    (cx, cy, cz, l, w, h, ry); +inf where missed. cz is the box CENTER."""
    cx, cy, cz, l, w, h, ry = [float(v) for v in box[:7]]
    c, s = np.cos(-ry), np.sin(-ry)
    # origin and dirs in the box frame
    ox, oy = c * (-cx) - s * (-cy), s * (-cx) + c * (-cy)
    oz = -cz
    dx = c * dirs[:, 0] - s * dirs[:, 1]
    dy = s * dirs[:, 0] + c * dirs[:, 1]
    dz = dirs[:, 2]
    t0 = np.zeros(len(dirs), np.float32)
    t1 = np.full(len(dirs), np.inf, np.float32)
    for o, d, half in ((ox, dx, l / 2), (oy, dy, w / 2), (oz, dz, h / 2)):
        d = np.where(np.abs(d) < 1e-9, 1e-9, d)
        ta = (-half - o) / d
        tb = (half - o) / d
        lo, hi = np.minimum(ta, tb), np.maximum(ta, tb)
        t0, t1 = np.maximum(t0, lo), np.minimum(t1, hi)
    t = np.where((t1 >= t0) & (t1 > 0), np.maximum(t0, 1e-3), np.inf)
    return t.astype(np.float32)


def simulate_scan(rng, boxes=(), n_beams=56, azim_steps=480,
                  range_noise=0.02, drop_prob=0.08, clutter=True):
    """Cast one scan. boxes: (K, 7) [cx, cy, z_center, l, w, h, ry] in the
    velodyne frame. Returns (N, 4) float32 points (x, y, z, intensity), the
    nearest-surface hit per ray, range-limited and randomly decimated."""
    dirs = _ray_dirs(n_beams, azim_steps)
    n = len(dirs)
    t_hit = np.full(n, np.inf, np.float32)
    kind = np.zeros(n, np.int8)              # 0 ground, 1 box, 2 clutter

    # ground plane z = GROUND_Z with gentle large-scale undulation
    dz = dirs[:, 2]
    tg = np.where(dz < -1e-4, GROUND_Z / np.minimum(dz, -1e-4), np.inf)
    t_hit = tg.astype(np.float32)

    scene = [(np.asarray(b, np.float32), 1) for b in boxes]
    if clutter:
        for _ in range(rng.randint(4, 9)):   # walls / big static boxes
            cx = rng.uniform(12, 62)
            cy = rng.uniform(-28, 28)
            l, w, h = rng.uniform(2, 14), rng.uniform(0.3, 3.5), \
                rng.uniform(1.5, 3.5)
            scene.append((np.array([cx, cy, GROUND_Z + h / 2, l, w, h,
                                    rng.uniform(0, np.pi)], np.float32), 2))
        for _ in range(rng.randint(6, 14)):  # poles / trunks
            cx = rng.uniform(6, 60)
            cy = rng.uniform(-30, 30)
            h = rng.uniform(2.0, 5.0)
            scene.append((np.array([cx, cy, GROUND_Z + h / 2, 0.25, 0.25, h,
                                    0.0], np.float32), 2))
    for box, k in scene:
        t = _ray_box_t(dirs, box)
        closer = t < t_hit
        t_hit = np.where(closer, t, t_hit)
        kind = np.where(closer, k, kind)

    ok = t_hit < MAX_RANGE
    t = t_hit[ok] + rng.normal(0, range_noise, ok.sum()).astype(np.float32)
    pts = dirs[ok] * t[:, None]
    inten = np.where(kind[ok] == 1, rng.uniform(0.4, 0.9, ok.sum()),
                     rng.uniform(0.05, 0.45, ok.sum())).astype(np.float32)
    keep = rng.rand(len(pts)) > drop_prob
    return np.concatenate([pts[keep], inten[keep, None]],
                          1).astype(np.float32)


def voxelize_coords(points, voxel_size, pc_range, max_voxels=None):
    """Unique (z, y, x) int32 voxel coords of in-range points — the
    coordinate convention of datasets/processor/voxel_generator.py."""
    pc_range = np.asarray(pc_range, np.float32)
    vs = np.asarray(voxel_size, np.float32)
    m = np.all((points[:, :3] >= pc_range[:3])
               & (points[:, :3] < pc_range[3:6] - 1e-4), axis=1)
    xyz = ((points[m, :3] - pc_range[:3]) / vs).astype(np.int32)
    zyx = np.unique(xyz[:, ::-1], axis=0)
    if max_voxels is not None and len(zyx) > max_voxels:
        sel = np.sort(np.random.RandomState(0).choice(
            len(zyx), max_voxels, replace=False))
        zyx = zyx[sel]
    return zyx


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


def draw_batch(rng, meta, batch_size, n_cap, n_fill, n_points, pad_points_to,
               sample_points, max_objs):
    """One numpy batch of ``batch_size`` scans, each ``n_fill`` voxels under a
    cap of ``n_cap`` rows (random point features, as the JAX bench batch
    has), with its raw points and its six cars as gt (class 1, padded with
    zero rows to ``max_objs``).

    Raw points: with ``sample_points`` ``n_points`` drawn from the scan
    (wraparound-padded when it has fewer), else the scan's first
    ``n_points`` in ray order; then zero rows with ``points_valid`` False up
    to ``pad_points_to``."""
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
    nf = int(meta['num_point_features'])
    width = max(n_points, pad_points_to)
    pts = np.zeros((batch_size, width, nf), np.float32)
    pts_valid = np.zeros((batch_size, width), bool)
    for b in range(batch_size):
        src = scan_pts[b][:, :nf]
        if not sample_points:
            n = min(len(src), n_points)
            pts[b, :n, :src.shape[1]] = src[:n]
            pts_valid[b, :n] = True
            continue
        if len(src) >= n_points:
            idx = np.sort(rng.choice(len(src), n_points, replace=False))
        else:                                      # wraparound pad
            idx = np.arange(n_points) % len(src)
        pts[b, :n_points, :src.shape[1]] = src[idx]
        pts_valid[b, :n_points] = True
    gt = np.zeros((batch_size, max_objs, 8), np.float32)
    for b in range(batch_size):
        rows = np.concatenate([scan_boxes[b], np.ones((len(scan_boxes[b]), 1),
                                                      np.float32)], 1)
        gt[b, :len(rows)] = rows[:max_objs]
    return {'voxels': voxels, 'voxel_coords': coords, 'voxel_num_points': nums,
            'voxel_valid': valid, 'points': pts, 'points_valid': pts_valid,
            'gt_boxes': gt}
