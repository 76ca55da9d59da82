"""Dataset base (reference ``pcdet/datasets/dataset.py``): the prepare_data
pipeline (augment -> class filter -> encode -> process) and fixed-shape
batch collation for the model.

Every random draw of the pipeline comes from ``self.rng``, one
``np.random.RandomState`` per dataset object (given to the constructor, or
unseeded), in the reference's order of calls: a ``RandomState(s)`` gives
the draws that ``np.random.seed(s)`` gives the reference. A loader worker reseeds its copy from the seed torch
hands it (``worker_init_fn``)."""
from collections import defaultdict
from pathlib import Path

import numpy as np

from ..config import REPO_ROOT
from ..ops.sparse import host_rulebook
from ..utils import common_utils
from .augmentor.data_augmentor import DataAugmentor
from .processor.data_processor import DataProcessor
from .processor.point_feature_encoder import PointFeatureEncoder


def data_root(data_path):
    """DATA_PATH of a yaml: relative paths are written from ``tools/``,
    where the runners of the reference start."""
    path = Path(data_path)
    return path if path.is_absolute() else (REPO_ROOT / 'tools' / path).resolve()


def worker_init_fn(worker_id):
    """Loader worker setup: the dataset copy's generator seeded from the
    worker's torch seed (distinct per worker, reproducible under a fixed
    torch seed)."""
    import torch.utils.data
    info = torch.utils.data.get_worker_info()
    info.dataset.rng = np.random.RandomState(info.seed % 2 ** 32)


class DatasetTemplate:
    def __init__(self, dataset_cfg=None, class_names=None, training=True,
                 root_path=None, logger=None, rng=None):
        self.dataset_cfg = dataset_cfg
        self.training = training
        self.class_names = class_names
        self.logger = logger
        self.root_path = Path(root_path) if root_path is not None else data_root(
            self.dataset_cfg.DATA_PATH)
        self.rng = rng if rng is not None else np.random.RandomState()
        # gt rows past MAX_GT_BOXES that prepare_data dropped, as JAX drops
        # them (counted in this process only, not in loader workers)
        self.gt_rows_dropped = 0
        if self.dataset_cfg is None or class_names is None:
            return

        self.point_cloud_range = np.array(
            self.dataset_cfg.POINT_CLOUD_RANGE, dtype=np.float32)
        self.point_feature_encoder = PointFeatureEncoder(
            self.dataset_cfg.POINT_FEATURE_ENCODING,
            point_cloud_range=self.point_cloud_range)
        self.data_augmentor = DataAugmentor(
            self.root_path, self.dataset_cfg.DATA_AUGMENTOR, self.class_names,
            logger=self.logger) if self.training else None
        self.data_processor = DataProcessor(
            self.dataset_cfg.DATA_PROCESSOR,
            point_cloud_range=self.point_cloud_range, training=self.training)
        self.grid_size = self.data_processor.grid_size
        self.voxel_size = self.data_processor.voxel_size
        self.max_gt_boxes = int(self.dataset_cfg.get('MAX_GT_BOXES', 50))
        self.total_epochs = 0
        self._merge_all_iters_to_one_epoch = False
        # host rulebooks (set_rulebook_spec from the model config): the
        # integer tables are built per sample, in the loader workers
        self.rulebook_spec = None

    def set_rulebook_spec(self, backbone_name, caps_override=None):
        """Build each sample's rulebooks for ``backbone_name`` at this mode's
        level capacities (``caps_override``: the yaml's LEVEL_CAPACITIES)."""
        cap = self.data_processor.max_voxels
        self.rulebook_spec = host_rulebook.backbone_spec(
            backbone_name, tuple(int(g) for g in self.grid_size), cap,
            caps_override=host_rulebook.select_mode_caps(
                caps_override, self.training))

    @property
    def mode(self):
        return 'train' if self.training else 'test'

    def __len__(self):
        raise NotImplementedError

    def __getitem__(self, index):
        raise NotImplementedError

    def prepare_data(self, data_dict):
        """Augment -> filter classes -> encode -> process; during training
        a sample left without gt is replaced by a random other one."""
        if self.training:
            if 'gt_boxes' not in data_dict:
                raise KeyError('gt_boxes should be provided for training')
            gt_boxes_mask = np.array(
                [n in self.class_names for n in data_dict['gt_names']], dtype=bool)
            data_dict = self.data_augmentor.forward(
                {**data_dict, 'gt_boxes_mask': gt_boxes_mask}, self.rng)
            if len(data_dict['gt_boxes']) == 0:
                new_index = self.rng.randint(self.__len__())
                return self.__getitem__(new_index)

        if data_dict.get('gt_boxes', None) is not None:
            selected = common_utils.keep_arrays_by_name(
                data_dict['gt_names'], self.class_names)
            data_dict['gt_boxes'] = data_dict['gt_boxes'][selected]
            data_dict['gt_names'] = data_dict['gt_names'][selected]
            gt_classes = np.array(
                [self.class_names.index(n) + 1 for n in data_dict['gt_names']],
                dtype=np.int32)
            gt_boxes = np.concatenate(
                (data_dict['gt_boxes'],
                 gt_classes.reshape(-1, 1).astype(np.float32)), axis=1)
            data_dict['gt_boxes'] = gt_boxes

        data_dict = self.point_feature_encoder.forward(data_dict)
        data_dict = self.data_processor.forward(data_dict, self.rng)
        data_dict = self.data_processor.pad_to_fixed_shape(data_dict)

        # gt padded to a fixed count
        if data_dict.get('gt_boxes', None) is not None:
            gt = data_dict['gt_boxes']
            out = np.zeros((self.max_gt_boxes, gt.shape[1]), np.float32)
            n = min(gt.shape[0], self.max_gt_boxes)
            out[:n] = gt[:n]
            data_dict['gt_boxes'] = out
            self.gt_rows_dropped += gt.shape[0] - n

        # the raw points, padded, for a model that reads them (FV2P decoder)
        if self.dataset_cfg.get('KEEP_RAW_POINTS', False):
            p_cap = int(self.dataset_cfg.get('MAX_POINTS_PER_SCAN', 24000))
            pts = data_dict['points']
            out_p = np.zeros((p_cap, pts.shape[1]), np.float32)
            pv = np.zeros((p_cap,), bool)
            n = min(pts.shape[0], p_cap)
            out_p[:n] = pts[:n]
            pv[:n] = True
            data_dict['points'] = out_p
            data_dict['points_valid'] = pv
        else:
            data_dict.pop('points', None)

        data_dict.pop('gt_names', None)

        if self.rulebook_spec is not None:
            n = int(data_dict['voxel_valid'].sum())
            shape1 = self.rulebook_spec['shapes']['x_conv1']
            order = host_rulebook.sort_voxels_by_key(
                data_dict['voxel_coords'][:n], shape1)
            for key in ('voxels', 'voxel_coords', 'voxel_num_points'):
                data_dict[key][:n] = data_dict[key][:n][order]
            data_dict['_rb_sample'] = host_rulebook.build_sample_rulebooks(
                data_dict['voxel_coords'], n, self.rulebook_spec)
            host_rulebook._record_overflow(data_dict['_rb_sample'],
                                           self.rulebook_spec)
            data_dict['_rb_spec'] = self.rulebook_spec
        return data_dict

    @staticmethod
    def collate_batch(batch_list, _unused=False):
        """Stack fixed-shape samples into (B, ...) arrays; ``frame_id``,
        ``calib``, ``image_shape`` and ``use_lead_xyz`` pass through (stacked
        where they are arrays, else as lists) and the per-sample rulebooks
        are collated."""
        data_dict = defaultdict(list)
        for cur_sample in batch_list:
            for key, val in cur_sample.items():
                data_dict[key].append(val)
        rb_samples = data_dict.pop('_rb_sample', None)
        rb_spec = data_dict.pop('_rb_spec', None)
        batch = {}
        for key, val in data_dict.items():
            if key in ['frame_id', 'calib', 'image_shape', 'use_lead_xyz']:
                batch[key] = np.stack(val) if isinstance(val[0], np.ndarray) else val
            else:
                batch[key] = np.stack(val, axis=0)
        if rb_samples is not None:
            batch['rulebooks'] = host_rulebook.collate_rulebooks(
                rb_samples, rb_spec[0])
        return batch
