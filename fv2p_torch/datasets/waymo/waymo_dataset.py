"""Waymo Open Dataset (reference ``pcdet/datasets/waymo/waymo_dataset.py``):
sequence-pkl infos with a sampled interval, per-frame .npy lidar with the
NLZ points dropped and the intensity squashed by tanh, prediction dicts,
KITTI-format or native Waymo evaluation, and the gt database for the
gt-sampling augmentor.

The infos are read as written (by the reference's preprocessing, or by
``fv2p_torch.tools.make_synthetic_waymo`` for the fixtures). Extracting them
from tfrecords (``get_infos``, ``create_waymo_infos``, ``waymo_utils``) and
the official evaluator need tensorflow and ``waymo_open_dataset``, and are
not ported; ``waymo_eval`` calls the native estimator, which the JAX
package also falls back to when that import fails.

Every random draw (gt sampling, the world flips, rotation and scaling, the
point shuffle) comes from ``self.rng``, as in ``datasets/dataset.py``."""
import copy
import pickle
from pathlib import Path

import numpy as np

from ...utils import box_utils, common_utils
from ..dataset import DatasetTemplate


class WaymoDataset(DatasetTemplate):
    def __init__(self, dataset_cfg, class_names, training=True, root_path=None,
                 logger=None, rng=None):
        super().__init__(dataset_cfg=dataset_cfg, class_names=class_names,
                         training=training, root_path=root_path, logger=logger, rng=rng)
        self.data_path = self.root_path / self.dataset_cfg.PROCESSED_DATA_TAG
        self.split = self.dataset_cfg.DATA_SPLIT[self.mode]
        self.sample_sequence_list = self._sequence_list(self.split)
        self.infos = []
        self.include_waymo_data(self.mode)

    def _sequence_list(self, split):
        split_dir = self.root_path / 'ImageSets' / (split + '.txt')
        if not split_dir.exists():
            return []
        return [x.strip() for x in split_dir.read_text().splitlines()]

    def include_waymo_data(self, mode):
        """Every listed sequence's info pkl, then every SAMPLED_INTERVAL-th
        frame of the concatenation."""
        if self.logger:
            self.logger.info('Loading Waymo dataset')
        waymo_infos = []
        num_skipped = 0
        for name in self.sample_sequence_list:
            sequence_name = name.split('.')[0]
            info_path = self.data_path / sequence_name / ('%s.pkl' % sequence_name)
            if not info_path.exists():
                num_skipped += 1
                continue
            with open(info_path, 'rb') as f:
                waymo_infos.extend(pickle.load(f))
        self.infos.extend(waymo_infos)
        if self.logger:
            self.logger.info('Total skipped info %s' % num_skipped)
            self.logger.info('Total samples for Waymo dataset: %d' % len(waymo_infos))
        interval = self.dataset_cfg.SAMPLED_INTERVAL[mode]
        if interval > 1:
            self.infos = self.infos[::interval]
            if self.logger:
                self.logger.info('Total sampled samples for Waymo dataset: %d'
                                 % len(self.infos))

    def set_split(self, split):
        """Re-point the dataset at another split's sequence list (its infos
        emptied, as the reference leaves them)."""
        super().__init__(dataset_cfg=self.dataset_cfg, class_names=self.class_names,
                         training=self.training, root_path=self.root_path,
                         logger=self.logger, rng=self.rng)
        self.split = split
        self.sample_sequence_list = self._sequence_list(split)
        self.infos = []

    @staticmethod
    def check_sequence_name_with_all_version(sequence_file):
        """Tolerate the two public tfrecord naming schemes: with and without
        ``_with_camera_labels``."""
        s = str(sequence_file)
        if '_with_camera_labels' not in s and not sequence_file.exists():
            sequence_file = Path(s[:-len('.tfrecord')] + '_with_camera_labels.tfrecord')
        if '_with_camera_labels' in s and not sequence_file.exists():
            sequence_file = Path(s.replace('_with_camera_labels', ''))
        return sequence_file

    def create_groundtruth_database(self, info_path, save_path, used_classes=None,
                                    split='train', sampled_interval=10,
                                    processed_data_tag=None):
        """Crop every object's points out of every ``sampled_interval``-th
        frame of ``info_path`` into ``save_path``'s gt database (one .bin a
        object, points relative to the box center) and pickle the database
        infos by class. The points-in-box test is host numpy."""
        database_save_path = save_path / ('pcdet_gt_database_%s_sampled_%d'
                                          % (split, sampled_interval))
        db_info_save_path = save_path / ('pcdet_waymo_dbinfos_%s_sampled_%d.pkl'
                                         % (split, sampled_interval))
        database_save_path.mkdir(parents=True, exist_ok=True)
        all_db_infos = {}
        with open(info_path, 'rb') as f:
            infos = pickle.load(f)

        for k in range(0, len(infos), sampled_interval):
            info = infos[k]
            pc_info = info['point_cloud']
            sequence_name = pc_info['lidar_sequence']
            sample_idx = pc_info['sample_idx']
            points = self.get_lidar(sequence_name, sample_idx)
            annos = info['annos']
            names = annos['name']
            difficulty = annos['difficulty']
            gt_boxes = annos['gt_boxes_lidar']
            num_obj = gt_boxes.shape[0]
            if num_obj == 0:
                continue
            point_indices = box_utils.points_in_boxes_np(points, gt_boxes[:, :7])

            for i in range(num_obj):
                filename = '%s_%04d_%s_%d.bin' % (sequence_name, sample_idx, names[i], i)
                filepath = database_save_path / filename
                gt_points = points[point_indices[i] > 0]
                gt_points[:, :3] -= gt_boxes[i, :3]
                if (used_classes is None) or names[i] in used_classes:
                    with open(filepath, 'w') as f:
                        gt_points.tofile(f)
                    db_path = str(filepath.relative_to(self.root_path))
                    db_info = {'name': names[i], 'path': db_path,
                               'sequence_name': sequence_name,
                               'sample_idx': sample_idx, 'gt_idx': i,
                               'box3d_lidar': gt_boxes[i],
                               'num_points_in_gt': gt_points.shape[0],
                               'difficulty': difficulty[i]}
                    all_db_infos.setdefault(names[i], []).append(db_info)
        for name, v in all_db_infos.items():
            print('Database %s: %d' % (name, len(v)))
        with open(db_info_save_path, 'wb') as f:
            pickle.dump(all_db_infos, f)

    def get_lidar(self, sequence_name, sample_idx):
        """(N, 6) .npy [x, y, z, intensity, elongation, NLZ flag] -> the
        points outside no-label zones (flag -1), (N', 5), intensity through
        tanh."""
        lidar_file = self.data_path / sequence_name / ('%04d.npy' % sample_idx)
        point_features = np.load(lidar_file)
        points_all, nlz_flag = point_features[:, 0:5], point_features[:, 5]
        points_all = points_all[nlz_flag == -1]
        points_all[:, 3] = np.tanh(points_all[:, 3])
        return points_all

    def __len__(self):
        if self._merge_all_iters_to_one_epoch:
            return len(self.infos) * self.total_epochs
        return len(self.infos)

    def __getitem__(self, index):
        if self._merge_all_iters_to_one_epoch:
            index = index % len(self.infos)
        info = copy.deepcopy(self.infos[index])
        pc_info = info['point_cloud']
        points = self.get_lidar(pc_info['lidar_sequence'], pc_info['sample_idx'])
        input_dict = {'points': points, 'frame_id': info['frame_id']}
        if 'annos' in info:
            annos = common_utils.drop_info_with_name(info['annos'], name='unknown')
            input_dict.update({'gt_names': annos['name'],
                               'gt_boxes': annos['gt_boxes_lidar']})
        data_dict = self.prepare_data(data_dict=input_dict)
        data_dict['metadata'] = info.get('metadata', info['frame_id'])
        return data_dict

    @staticmethod
    def generate_prediction_dicts(batch_dict, pred_dicts, class_names, output_path=None):
        """The model's fixed-shape predictions (``pred_valid`` masking the
        padding) -> one dict a scan: name, score, boxes_lidar, frame_id and
        metadata. ``output_path`` is accepted and unused, as in the
        reference."""

        def get_template(num):
            return {'name': np.zeros(num), 'score': np.zeros(num),
                    'boxes_lidar': np.zeros([num, 7])}

        annos = []
        batch_size = len(pred_dicts) if isinstance(pred_dicts, list) \
            else np.asarray(pred_dicts['pred_scores']).shape[0]
        for index in range(batch_size):
            if isinstance(pred_dicts, list):
                box_dict = pred_dicts[index]
            else:
                box_dict = {k: v[index] for k, v in pred_dicts.items()}
            scores = np.asarray(box_dict['pred_scores'])
            boxes = np.asarray(box_dict['pred_boxes'])
            labels = np.asarray(box_dict['pred_labels'])
            if 'pred_valid' in box_dict:
                valid = np.asarray(box_dict['pred_valid'])
                scores, boxes, labels = scores[valid], boxes[valid], labels[valid]
            pred = get_template(scores.shape[0])
            if scores.shape[0] > 0:
                pred['name'] = np.array(class_names)[labels - 1]
                pred['score'] = scores
                pred['boxes_lidar'] = boxes
            pred['frame_id'] = batch_dict['frame_id'][index]
            if 'metadata' in batch_dict:
                pred['metadata'] = batch_dict['metadata'][index]
            annos.append(pred)
        return annos

    def kitti_eval(self, eval_det_annos, eval_gt_annos, class_names, device=None):
        """The official KITTI metrics with Waymo's classes renamed to KITTI's
        and the lidar boxes moved to a pseudo camera frame (x_cam = -y,
        y_cam = -z, z_cam = x; a 50-pixel fake 2D box so that every box
        passes the height filter). The rotated overlaps run on ``device``
        (None: the CUDA card)."""
        from ..kitti.kitti_object_eval import eval as kitti_eval

        map_name_to_kitti = {'Vehicle': 'Car', 'Pedestrian': 'Pedestrian',
                             'Cyclist': 'Cyclist', 'Sign': 'Sign', 'Car': 'Car'}

        def transform_to_kitti_format(annos, is_gt=False):
            for anno in annos:
                for k in range(anno['name'].shape[0]):
                    anno['name'][k] = map_name_to_kitti.get(anno['name'][k],
                                                            'Person_sitting')
                anno['bbox'] = np.zeros((len(anno['name']), 4))
                anno['bbox'][:, 2:4] = 50
                anno['truncated'] = np.zeros(len(anno['name']))
                anno['occluded'] = np.zeros(len(anno['name']))
                if 'boxes_lidar' in anno:
                    gt_boxes_lidar = anno['boxes_lidar'].copy()
                else:
                    gt_boxes_lidar = anno['gt_boxes_lidar'].copy()
                if is_gt and 'num_points_in_gt' in anno:
                    mask = anno['num_points_in_gt'] > 0
                    gt_boxes_lidar = gt_boxes_lidar[mask]
                    anno['name'] = anno['name'][mask]
                    if 'score' in anno:
                        anno['score'] = anno['score'][mask]
                anno['alpha'] = -np.arctan2(-gt_boxes_lidar[:, 1], gt_boxes_lidar[:, 0]) \
                    if len(gt_boxes_lidar) else np.zeros(0)
                if len(gt_boxes_lidar) > 0:
                    anno['location'] = np.stack([-gt_boxes_lidar[:, 1], -gt_boxes_lidar[:, 2],
                                                 gt_boxes_lidar[:, 0]], axis=1)
                    anno['dimensions'] = gt_boxes_lidar[:, [3, 5, 4]]  # l, h, w
                    anno['rotation_y'] = -gt_boxes_lidar[:, 6] - np.pi / 2
                else:
                    anno['location'] = np.zeros((0, 3))
                    anno['dimensions'] = np.zeros((0, 3))
                    anno['rotation_y'] = np.zeros(0)

        transform_to_kitti_format(eval_det_annos)
        transform_to_kitti_format(eval_gt_annos, is_gt=True)

        kitti_class_names = [map_name_to_kitti.get(x, x) for x in class_names]
        return kitti_eval.get_official_eval_result(
            gt_annos=eval_gt_annos, dt_annos=eval_det_annos,
            current_classes=kitti_class_names, device=device)

    def waymo_eval(self, eval_det_annos, eval_gt_annos, class_names):
        """Waymo's L1/L2 AP and APH through the native estimator (numpy and
        scipy, host only), ap_dict keys ``OBJECT_TYPE_TYPE_<CLASS>_LEVEL_<k>/
        AP[H]`` with float values."""
        from .waymo_eval_native import NativeWaymoDetectionMetricsEstimator
        ap_dict = NativeWaymoDetectionMetricsEstimator().waymo_evaluation(
            eval_det_annos, eval_gt_annos, class_name=class_names, distance_thresh=1000,
            fake_gt_infos=self.dataset_cfg.get('INFO_WITH_FAKELIDAR', False))
        ap_result_str = '\n'
        for key in ap_dict:
            ap_dict[key] = ap_dict[key][0]
            ap_result_str += '%s: %.4f \n' % (key, ap_dict[key])
        return ap_result_str, ap_dict

    def evaluation(self, det_annos, class_names, device=None, **kwargs):
        """``det_annos`` (one per info, in order) scored against the infos'
        annotations by ``eval_metric``: 'kitti' (the default; its overlaps
        on ``device``, None meaning the CUDA card) or 'waymo' (native, on
        the host)."""
        if 'annos' not in self.infos[0].keys():
            return 'No ground-truth boxes for evaluation', {}
        eval_det_annos = copy.deepcopy(det_annos)
        eval_gt_annos = [copy.deepcopy(info['annos']) for info in self.infos]
        metric = kwargs.get('eval_metric', 'kitti')
        if metric == 'kitti':
            return self.kitti_eval(eval_det_annos, eval_gt_annos, class_names, device=device)
        if metric == 'waymo':
            return self.waymo_eval(eval_det_annos, eval_gt_annos, class_names)
        raise NotImplementedError(metric)
