"""Common geometry, logging and seeding utilities (reference
``pcdet/utils/common_utils.py``): tensor versions for the model, numpy
versions (``*_np``) for the data pipeline."""
import functools
import logging
import math
import os
import random

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


def limit_period_np(val, offset=0.5, period=np.pi):
    return val - np.floor(val / period + offset) * period


def rotate_points_along_z_np(points, angle):
    """points (B, N, 3 + C), angle (B,) CCW radians -> rotated points."""
    cosa, sina = np.cos(angle), np.sin(angle)
    zeros, ones = np.zeros_like(angle), np.ones_like(angle)
    rot = np.stack([cosa, sina, zeros, -sina, cosa, zeros, zeros, zeros, ones],
                   axis=1).reshape(-1, 3, 3)
    pts = np.matmul(points[:, :, 0:3], rot.astype(points.dtype))
    return np.concatenate([pts, points[:, :, 3:]], axis=-1)


def keep_arrays_by_name(gt_names, used_classes):
    """Indices of the entries whose name is in used_classes."""
    inds = [i for i, x in enumerate(gt_names) if x in used_classes]
    return np.array(inds, dtype=np.int64)


def drop_info_with_name(info, name):
    """The annotation dict without the rows of the given name."""
    keep_indices = [i for i, x in enumerate(info['name']) if x != name]
    return {key: info[key][keep_indices] for key in info.keys()}


def create_logger(log_file=None, rank=0, log_level=logging.INFO):
    logger = logging.getLogger(__name__)
    for handler in list(logger.handlers):      # a runner started again
        logger.removeHandler(handler)
        handler.close()
    logger.setLevel(log_level if rank == 0 else 'ERROR')
    formatter = logging.Formatter('%(asctime)s  %(levelname)5s  %(message)s')
    console = logging.StreamHandler()
    console.setLevel(log_level if rank == 0 else 'ERROR')
    console.setFormatter(formatter)
    logger.addHandler(console)
    if log_file is not None:
        file_handler = logging.FileHandler(filename=log_file)
        file_handler.setLevel(log_level if rank == 0 else 'ERROR')
        file_handler.setFormatter(formatter)
        logger.addHandler(file_handler)
    logger.propagate = False
    return logger


def set_random_seed(seed):
    """Seed Python's, numpy's and torch's global generators."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    os.environ['PYTHONHASHSEED'] = str(seed)
