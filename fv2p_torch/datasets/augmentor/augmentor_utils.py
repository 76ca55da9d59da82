"""Global augmentations, numpy (reference ``augmentor/augmentor_utils.py``).
Each draws from the ``rng`` (a ``np.random.RandomState``) it is given."""
import numpy as np

from ...utils import common_utils


def random_flip_along_x(gt_boxes, points, rng):
    """Mirror across the x axis (y -> -y, ry -> -ry) with prob 0.5; flips
    vy (col 8) on boxes that carry a velocity (cols 7:9)."""
    enable = rng.choice([False, True], replace=False, p=[0.5, 0.5])
    if enable:
        gt_boxes[:, 1] = -gt_boxes[:, 1]
        gt_boxes[:, 6] = -gt_boxes[:, 6]
        points[:, 1] = -points[:, 1]
        if gt_boxes.shape[1] > 7:
            gt_boxes[:, 8] = -gt_boxes[:, 8]
    return gt_boxes, points


def random_flip_along_y(gt_boxes, points, rng):
    """Mirror across the y axis; flips vx (col 7) on 9-dim boxes."""
    enable = rng.choice([False, True], replace=False, p=[0.5, 0.5])
    if enable:
        gt_boxes[:, 0] = -gt_boxes[:, 0]
        gt_boxes[:, 6] = -(gt_boxes[:, 6] + np.pi)
        points[:, 0] = -points[:, 0]
        if gt_boxes.shape[1] > 7:
            gt_boxes[:, 7] = -gt_boxes[:, 7]
    return gt_boxes, points


def global_rotation(gt_boxes, points, rot_range, rng):
    """Rotate the scene about z; the velocity vector (cols 7:9 when
    present) rotates with it."""
    noise_rotation = rng.uniform(rot_range[0], rot_range[1])
    points = common_utils.rotate_points_along_z_np(
        points[np.newaxis, :, :], np.array([noise_rotation]))[0]
    gt_boxes[:, 0:3] = common_utils.rotate_points_along_z_np(
        gt_boxes[np.newaxis, :, 0:3], np.array([noise_rotation]))[0]
    gt_boxes[:, 6] += noise_rotation
    if gt_boxes.shape[1] > 7:
        gt_boxes[:, 7:9] = common_utils.rotate_points_along_z_np(
            np.hstack((gt_boxes[:, 7:9],
                       np.zeros((gt_boxes.shape[0], 1))))[np.newaxis, :, :],
            np.array([noise_rotation]))[0][:, 0:2]
    return gt_boxes, points


def global_scaling(gt_boxes, points, scale_range, rng):
    if scale_range[1] - scale_range[0] < 1e-3:
        return gt_boxes, points
    noise_scale = rng.uniform(scale_range[0], scale_range[1])
    points[:, :3] *= noise_scale
    gt_boxes[:, :6] *= noise_scale
    return gt_boxes, points
