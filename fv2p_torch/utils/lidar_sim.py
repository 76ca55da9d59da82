"""Ray-cast LiDAR scan simulator for synthetic fixtures and benchmarks.

Real LiDAR points lie on *surfaces* (ground, object shells, walls), so their
voxelization is spatially contiguous and stride-2 sparse convs mostly MERGE
neighboring voxels instead of dilating isolated ones. Sprinkle-style
synthetic occupancy (uniform or loosely clustered random cells) is the
pathological opposite: every voxel is isolated and dilates by up to 8x per
stride level, which both poisons capacity planning and mis-benches the
sparse path. This module simulates a spinning multi-beam LiDAR (HDL-64-like
geometry: fixed beam elevations, uniform azimuth steps, front field of view
as in KITTI's camera-FOV crop) against an analytic scene of a ground plane,
oriented boxes, vertical poles, and walls, returning surface point clouds
whose voxel statistics behave like real scans.

Not part of the reference surface (the reference trains on real KITTI
velodyne data); this is the repository's stand-in for it where no
dataset is at hand.
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
