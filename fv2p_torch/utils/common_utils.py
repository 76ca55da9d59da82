"""Common geometry utilities (reference ``pcdet/utils/common_utils.py``)."""
import functools
import math

import numpy as np
import torch


def device_constant(values, dtype, device):
    """A small constant tensor, copied to ``device`` once per process: a copy
    from pageable host memory makes the host wait for the card's queue.
    Callers must not modify it in place."""
    arr = np.asarray(values, dtype=np.float64)
    return _device_constant(arr.tobytes(), arr.shape, dtype, torch.device(device))


@functools.lru_cache(maxsize=None)
def _device_constant(buf, shape, dtype, device):
    arr = np.frombuffer(buf, np.float64).reshape(shape)
    return torch.tensor(arr, dtype=dtype, device=device)


def limit_period(val, offset=0.5, period=math.pi):
    """Wrap values into ``[-offset*period, (1-offset)*period)``."""
    return val - torch.floor(val / period + offset) * period


def rotate_points_along_z(points, angle):
    """points (B, N, 3 + C), angle (B,) CCW radians -> rotated points."""
    cosa = torch.cos(angle)
    sina = torch.sin(angle)
    zeros = torch.zeros_like(angle)
    ones = torch.ones_like(angle)
    rot_matrix = torch.stack([
        cosa, sina, zeros,
        -sina, cosa, zeros,
        zeros, zeros, ones,
    ], dim=1).reshape(-1, 3, 3)
    points_rot = torch.matmul(points[:, :, 0:3], rot_matrix.to(points.dtype))
    return torch.cat([points_rot, points[:, :, 3:]], dim=-1)


def get_voxel_centers(voxel_coords, downsample_times, voxel_size,
                      point_cloud_range):
    """(N, 3) integer (z, y, x) voxel coords -> (N, 3) metric xyz centers."""
    voxel_centers = voxel_coords.flip(-1).to(torch.float32)
    vs = device_constant(voxel_size, torch.float32,
                         voxel_coords.device) * downsample_times
    pc_min = device_constant(point_cloud_range[0:3], torch.float32,
                             voxel_coords.device)
    return (voxel_centers + 0.5) * vs + pc_min
