"""Composable data processors (reference ``processor/data_processor.py``):
range mask -> shuffle -> voxelize, driven by the DATA_PROCESSOR list.

``pad_to_fixed_shape`` emits the fixed-capacity per-sample arrays the model
takes (padding + a validity mask in place of ragged batches). The random
draws (``shuffle_points``, ``sample_points``) come from the ``rng`` (a
``np.random.RandomState``) that ``forward`` is given, in the reference's
order of calls."""
from functools import partial

import numpy as np

from ...utils import box_utils
from .voxel_generator import VoxelGenerator


def mask_points_by_range(points, limit_range):
    return points[(points[:, 0] >= limit_range[0]) & (points[:, 0] <= limit_range[3])
                  & (points[:, 1] >= limit_range[1]) & (points[:, 1] <= limit_range[4])]


class DataProcessor:
    def __init__(self, processor_configs, point_cloud_range, training):
        self.point_cloud_range = np.array(point_cloud_range, np.float32)
        self.training = training
        self.mode = 'train' if training else 'test'
        self.voxel_generator = None
        self.max_voxels = None
        # a point-only pipeline (PointRCNN: no transform_points_to_voxels)
        # has no grid; JAX's DataProcessor leaves these unset and its dataset
        # then fails to build for such a yaml
        self.grid_size = self.voxel_size = None
        self.data_processor_queue = []
        for cur_cfg in processor_configs:
            cur_processor = getattr(self, cur_cfg.NAME)(config=cur_cfg)
            self.data_processor_queue.append(cur_processor)

    def mask_points_and_boxes_outside_range(self, data_dict=None, config=None,
                                            rng=None):
        if data_dict is None:
            return partial(self.mask_points_and_boxes_outside_range, config=config)
        data_dict['points'] = mask_points_by_range(
            data_dict['points'], self.point_cloud_range)
        if data_dict.get('gt_boxes', None) is not None and config.REMOVE_OUTSIDE_BOXES \
                and self.training:
            mask = box_utils.mask_boxes_outside_range_numpy(
                data_dict['gt_boxes'], self.point_cloud_range, min_num_corners=1)
            data_dict['gt_boxes'] = data_dict['gt_boxes'][mask]
            if 'gt_names' in data_dict:
                data_dict['gt_names'] = data_dict['gt_names'][mask]
        return data_dict

    def shuffle_points(self, data_dict=None, config=None, rng=None):
        if data_dict is None:
            return partial(self.shuffle_points, config=config)
        if config.SHUFFLE_ENABLED[self.mode]:
            points = data_dict['points']
            shuffle_idx = rng.permutation(points.shape[0])
            data_dict['points'] = points[shuffle_idx]
        return data_dict

    def transform_points_to_voxels(self, data_dict=None, config=None, rng=None):
        if data_dict is None:
            self.voxel_generator = VoxelGenerator(
                voxel_size=config.VOXEL_SIZE,
                point_cloud_range=self.point_cloud_range,
                max_num_points=config.MAX_POINTS_PER_VOXEL,
                max_voxels=config.MAX_NUMBER_OF_VOXELS[self.mode],
            )
            self.max_voxels = int(config.MAX_NUMBER_OF_VOXELS[self.mode])
            self.grid_size = self.voxel_generator.grid_size
            self.voxel_size = np.array(config.VOXEL_SIZE, np.float32)
            return partial(self.transform_points_to_voxels, config=config)

        voxels, coordinates, num_points = self.voxel_generator.generate(
            data_dict['points'])
        if not data_dict.get('use_lead_xyz', True):
            voxels = voxels[..., 3:]
        data_dict['voxels'] = voxels
        data_dict['voxel_coords'] = coordinates
        data_dict['voxel_num_points'] = num_points
        return data_dict

    def sample_points(self, data_dict=None, config=None, rng=None):
        """Random sample/pad points to NUM_POINTS (reference
        data_processor.py:104-140: far-point-preserving subsample)."""
        if data_dict is None:
            self.num_sampled_points = int(config.NUM_POINTS[self.mode])
            return partial(self.sample_points, config=config)
        num_points = int(config.NUM_POINTS[self.mode])
        points = data_dict['points']
        if num_points < len(points):
            pts_depth = np.linalg.norm(points[:, 0:3], axis=1)
            pts_near_flag = pts_depth < 40.0
            far_idxs_choice = np.where(pts_near_flag == 0)[0]
            near_idxs = np.where(pts_near_flag == 1)[0]
            if num_points > len(far_idxs_choice):
                near_idxs_choice = rng.choice(
                    near_idxs, num_points - len(far_idxs_choice), replace=False)
                choice = np.concatenate((near_idxs_choice, far_idxs_choice), axis=0) \
                    if len(far_idxs_choice) > 0 else near_idxs_choice
            else:
                choice = np.arange(0, len(points), dtype=np.int32)
                choice = rng.choice(choice, num_points, replace=False)
            rng.shuffle(choice)
        else:
            choice = np.arange(0, len(points), dtype=np.int32)
            if num_points > len(points):
                extra_choice = rng.choice(choice, num_points - len(points))
                choice = np.concatenate((choice, extra_choice), axis=0)
            rng.shuffle(choice)
        data_dict['points'] = points[choice]
        return data_dict

    def forward(self, data_dict, rng):
        for cur_processor in self.data_processor_queue:
            data_dict = cur_processor(data_dict=data_dict, rng=rng)
        return data_dict

    def pad_to_fixed_shape(self, data_dict):
        """Pad per-sample voxel arrays to the static capacity + valid mask."""
        if self.max_voxels is None:
            return data_dict
        cap = self.max_voxels
        voxels = data_dict['voxels']
        n = voxels.shape[0]
        n_keep = min(n, cap)
        p, c = voxels.shape[1], voxels.shape[2]
        out_voxels = np.zeros((cap, p, c), voxels.dtype)
        out_coords = np.zeros((cap, 3), np.int32)
        out_nums = np.zeros((cap,), np.int32)
        out_valid = np.zeros((cap,), bool)
        out_voxels[:n_keep] = voxels[:n_keep]
        out_coords[:n_keep] = data_dict['voxel_coords'][:n_keep]
        out_nums[:n_keep] = data_dict['voxel_num_points'][:n_keep]
        out_valid[:n_keep] = True
        data_dict['voxels'] = out_voxels
        data_dict['voxel_coords'] = out_coords
        data_dict['voxel_num_points'] = out_nums
        data_dict['voxel_valid'] = out_valid
        return data_dict
