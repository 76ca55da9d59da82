"""Hard voxelization in vectorized numpy (the reference's point-to-voxel
loop, ``pcdet/datasets/processor/voxel_generator.py:136-207``).

Semantics:
  * first-come-first-serve voxel registration in point order; voxels beyond
    ``max_voxels`` are dropped (with the points that fell in them);
  * at most ``max_points`` points per voxel (extras dropped, earliest kept);
  * output coords in reversed (z, y, x) order.
"""
import numpy as np


class VoxelGenerator:
    def __init__(self, voxel_size, point_cloud_range, max_num_points,
                 max_voxels=20000):
        self.voxel_size = np.array(voxel_size, np.float32)
        self.point_cloud_range = np.array(point_cloud_range, np.float32)
        self.max_num_points = int(max_num_points)
        self.max_voxels = int(max_voxels)
        grid = (self.point_cloud_range[3:6] - self.point_cloud_range[0:3]) / self.voxel_size
        self.grid_size = np.round(grid).astype(np.int64)  # (nx, ny, nz)

    def generate(self, points):
        """Args: points (N, C>=3) with xyz leading.
        Returns: voxels (V, max_points, C), coords (V, 3) int32 (z, y, x),
                 num_points_per_voxel (V,).
        """
        vsize = self.voxel_size
        pmin = self.point_cloud_range[0:3]
        nx, ny, nz = self.grid_size

        idx = np.floor((points[:, :3] - pmin) / vsize).astype(np.int64)
        in_range = ((idx >= 0).all(axis=1) & (idx[:, 0] < nx)
                    & (idx[:, 1] < ny) & (idx[:, 2] < nz))
        points = points[in_range]
        idx = idx[in_range]
        if points.shape[0] == 0:
            c = points.shape[1] if points.ndim == 2 else 4
            return (np.zeros((0, self.max_num_points, c), points.dtype),
                    np.zeros((0, 3), np.int32), np.zeros((0,), np.int32))

        keys = (idx[:, 2] * ny + idx[:, 1]) * nx + idx[:, 0]  # z-major like coords

        uniq, first_idx, inv, counts = np.unique(
            keys, return_index=True, return_inverse=True, return_counts=True)
        # FCFS voxel order = order of first appearance
        fcfs = np.argsort(first_idx, kind='stable')
        n_vox = min(len(uniq), self.max_voxels)
        kept_uniq_rank = fcfs[:n_vox]                 # indices into uniq
        voxel_rank_of_uniq = np.full(len(uniq), -1, np.int64)
        voxel_rank_of_uniq[kept_uniq_rank] = np.arange(n_vox)
        point_voxel = voxel_rank_of_uniq[inv]         # (N,) or -1 if dropped

        # slot of each point within its voxel (original order preserved)
        order = np.argsort(inv, kind='stable')
        sorted_inv = inv[order]
        group_start = np.zeros(len(uniq), np.int64)
        group_start[1:] = np.cumsum(counts)[:-1]
        slot_sorted = np.arange(len(inv)) - group_start[sorted_inv]
        slot = np.empty(len(inv), np.int64)
        slot[order] = slot_sorted

        keep = (point_voxel >= 0) & (slot < self.max_num_points)

        c = points.shape[1]
        voxels = np.zeros((n_vox, self.max_num_points, c), points.dtype)
        voxels[point_voxel[keep], slot[keep]] = points[keep]
        num_points = np.minimum(counts[kept_uniq_rank], self.max_num_points).astype(np.int32)

        vox_keys = uniq[kept_uniq_rank]
        vz = vox_keys // (ny * nx)
        vy = (vox_keys // nx) % ny
        vx = vox_keys % nx
        coords = np.stack([vz, vy, vx], axis=1).astype(np.int32)
        return voxels, coords, num_points
