"""Augmentation queue (reference ``augmentor/data_augmentor.py``): gt_sampling
-> random_world_flip -> random_world_rotation -> random_world_scaling, driven
by AUG_CONFIG_LIST; heading re-limited to [-pi, pi) at the end. Every draw
comes from the ``rng`` that ``forward`` is given."""
from functools import partial

import numpy as np

from ...utils import common_utils
from . import augmentor_utils
from .database_sampler import DataBaseSampler


class DataAugmentor:
    def __init__(self, root_path, augmentor_configs, class_names, logger=None):
        self.root_path = root_path
        self.class_names = class_names
        self.logger = logger
        self.data_augmentor_queue = []
        aug_config_list = augmentor_configs if isinstance(augmentor_configs, list) \
            else augmentor_configs.AUG_CONFIG_LIST
        for cur_cfg in aug_config_list:
            if not isinstance(augmentor_configs, list):
                if cur_cfg.NAME in augmentor_configs.DISABLE_AUG_LIST:
                    continue
            cur_augmentor = getattr(self, cur_cfg.NAME)(config=cur_cfg)
            self.data_augmentor_queue.append(cur_augmentor)

    def gt_sampling(self, config=None):
        return DataBaseSampler(
            root_path=self.root_path, sampler_cfg=config,
            class_names=self.class_names, logger=self.logger)

    def random_world_flip(self, data_dict=None, config=None, rng=None):
        if data_dict is None:
            return partial(self.random_world_flip, config=config)
        gt_boxes, points = data_dict['gt_boxes'], data_dict['points']
        for cur_axis in config['ALONG_AXIS_LIST']:
            if cur_axis not in ('x', 'y'):
                raise ValueError(f'random_world_flip along {cur_axis!r}')
            gt_boxes, points = getattr(
                augmentor_utils, 'random_flip_along_%s' % cur_axis)(gt_boxes, points, rng)
        data_dict['gt_boxes'] = gt_boxes
        data_dict['points'] = points
        return data_dict

    def random_world_rotation(self, data_dict=None, config=None, rng=None):
        if data_dict is None:
            return partial(self.random_world_rotation, config=config)
        rot_range = config['WORLD_ROT_ANGLE']
        if not isinstance(rot_range, (list, tuple, np.ndarray)):
            rot_range = [-rot_range, rot_range]
        gt_boxes, points = augmentor_utils.global_rotation(
            data_dict['gt_boxes'], data_dict['points'], rot_range=rot_range, rng=rng)
        data_dict['gt_boxes'] = gt_boxes
        data_dict['points'] = points
        return data_dict

    def random_world_scaling(self, data_dict=None, config=None, rng=None):
        if data_dict is None:
            return partial(self.random_world_scaling, config=config)
        gt_boxes, points = augmentor_utils.global_scaling(
            data_dict['gt_boxes'], data_dict['points'],
            config['WORLD_SCALE_RANGE'], rng)
        data_dict['gt_boxes'] = gt_boxes
        data_dict['points'] = points
        return data_dict

    def forward(self, data_dict, rng):
        for cur_augmentor in self.data_augmentor_queue:
            data_dict = cur_augmentor(data_dict=data_dict, rng=rng)
        data_dict['gt_boxes'][:, 6] = common_utils.limit_period_np(
            data_dict['gt_boxes'][:, 6], offset=0.5, period=2 * np.pi)
        if 'road_plane' in data_dict:
            data_dict.pop('road_plane')
        return data_dict
