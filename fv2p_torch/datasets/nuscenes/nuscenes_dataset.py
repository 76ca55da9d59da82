"""nuScenes dataset (reference ``pcdet/datasets/nuscenes/nuscenes_dataset.py``):
info-pkl loading, CBGS class-balanced resampling, multi-sweep lidar with a
per-point time lag, prediction dicts and the devkit-free native evaluation
(``nuscenes_eval_native``). The info files and the gt database are read as
committed; building them (``create_nuscenes_info``,
``create_groundtruth_database``) and the devkit's evaluation are not ported.

The resampling and the choice of sweeps draw from ``self.rng``, as every
draw of the data pipeline does (``datasets/dataset.py``); the resampling
runs in the constructor, so a seeded run passes its generator there."""
import copy
import pickle
from pathlib import Path

import numpy as np

from ..dataset import DatasetTemplate, data_root


class NuScenesDataset(DatasetTemplate):
    def __init__(self, dataset_cfg, class_names, training=True, root_path=None,
                 logger=None, rng=None):
        root_path = (Path(root_path) if root_path is not None
                     else data_root(dataset_cfg.DATA_PATH)) / dataset_cfg.VERSION
        super().__init__(dataset_cfg=dataset_cfg, class_names=class_names,
                         training=training, root_path=root_path, logger=logger, rng=rng)
        self.infos = []
        self.include_nuscenes_data(self.mode)
        if self.training and self.dataset_cfg.get('BALANCED_RESAMPLING', False):
            self.infos = self.balanced_infos_resampling(self.infos)

    def include_nuscenes_data(self, mode):
        infos = []
        for info_path in self.dataset_cfg.INFO_PATH[mode]:
            p = self.root_path / info_path
            if not p.exists():
                continue
            with open(p, 'rb') as f:
                infos.extend(pickle.load(f))
        self.infos.extend(infos)
        if self.logger is not None:
            self.logger.info('Total samples for NuScenes dataset: %d' % len(infos))

    def balanced_infos_resampling(self, infos):
        """CBGS class-balanced resampling (https://arxiv.org/abs/1908.09492):
        duplicate frames so that every class contributes ~1/C of the
        samples."""
        if self.class_names is None:
            return infos
        cls_infos = {name: [] for name in self.class_names}
        for info in infos:
            for name in set(info['gt_names']):
                if name in self.class_names:
                    cls_infos[name].append(info)
        duplicated = sum(len(v) for v in cls_infos.values())
        if duplicated == 0:
            return infos
        cls_dist = {k: len(v) / duplicated for k, v in cls_infos.items()}
        frac = 1.0 / len(self.class_names)
        sampled = []
        for cur, ratio in zip(cls_infos.values(),
                              [frac / max(v, 1e-9) for v in cls_dist.values()]):
            if len(cur) == 0:
                continue
            idx = self.rng.choice(len(cur), int(len(cur) * ratio))
            sampled += [cur[i] for i in idx]
        if self.logger is not None:
            self.logger.info('Total samples after balanced resampling: %d' % len(sampled))
        return sampled

    def get_sweep(self, sweep_info):
        """One sweep's points (N, 4) in the key frame (ego points within
        1 m removed, then the sweep's transform) and their time lag (N, 1)."""
        lidar_path = self.root_path / sweep_info['lidar_path']
        pts = np.fromfile(str(lidar_path), dtype=np.float32, count=-1).reshape([-1, 5])[:, :4]
        ego = (np.abs(pts[:, 0]) < 1.0) & (np.abs(pts[:, 1]) < 1.0)
        pts = pts[~ego].T
        if sweep_info['transform_matrix'] is not None:
            n = pts.shape[1]
            pts[:3, :] = sweep_info['transform_matrix'].dot(
                np.vstack((pts[:3, :], np.ones(n))))[:3, :]
        times = sweep_info['time_lag'] * np.ones((1, pts.shape[1]))
        return pts.T, times.T

    def get_lidar_with_sweeps(self, index, max_sweeps=1):
        """The key frame's points and up to ``max_sweeps - 1`` sweeps drawn
        from the info's, with the time lag as a fifth column (0 for the key
        frame)."""
        info = self.infos[index]
        lidar_path = self.root_path / info['lidar_path']
        points = np.fromfile(str(lidar_path), dtype=np.float32, count=-1).reshape([-1, 5])[:, :4]
        sweep_points = [points]
        sweep_times = [np.zeros((points.shape[0], 1))]
        n_avail = len(info['sweeps'])
        if n_avail > 0 and max_sweeps > 1:
            for k in self.rng.choice(n_avail, min(max_sweeps - 1, n_avail), replace=False):
                p, t = self.get_sweep(info['sweeps'][k])
                sweep_points.append(p)
                sweep_times.append(t)
        points = np.concatenate(sweep_points, axis=0)
        times = np.concatenate(sweep_times, axis=0).astype(points.dtype)
        return np.concatenate((points, times), axis=1)

    def __len__(self):
        return len(self.infos)

    def __getitem__(self, index):
        info = copy.deepcopy(self.infos[index])
        points = self.get_lidar_with_sweeps(index, max_sweeps=int(self.dataset_cfg.MAX_SWEEPS))
        input_dict = {'points': points, 'frame_id': Path(info['lidar_path']).stem,
                      'metadata': {'token': info['token']}}
        if 'gt_boxes' in info:
            if self.dataset_cfg.get('FILTER_MIN_POINTS_IN_GT', False):
                mask = info['num_lidar_pts'] > self.dataset_cfg.FILTER_MIN_POINTS_IN_GT - 1
            else:
                mask = None
            input_dict.update(
                gt_names=info['gt_names'] if mask is None else info['gt_names'][mask],
                gt_boxes=info['gt_boxes'] if mask is None else info['gt_boxes'][mask])

        data_dict = self.prepare_data(data_dict=input_dict)
        if self.dataset_cfg.get('SET_NAN_VELOCITY_TO_ZEROS', False) and 'gt_boxes' in data_dict:
            gt = data_dict['gt_boxes']
            gt[np.isnan(gt)] = 0
            data_dict['gt_boxes'] = gt
        if not self.dataset_cfg.get('PRED_VELOCITY', True) and 'gt_boxes' in data_dict:
            data_dict['gt_boxes'] = data_dict['gt_boxes'][:, [0, 1, 2, 3, 4, 5, 6, -1]]
        return data_dict

    @staticmethod
    def generate_prediction_dicts(batch_dict, pred_dicts, class_names, output_path=None):
        """Fixed-shape predictions (a list of per-scan dicts, or the eval
        loop's dict of batched arrays) -> one dict a scan: name, score,
        boxes_lidar (every box column), pred_labels, frame_id, metadata."""
        if not isinstance(pred_dicts, list):
            bs = np.asarray(pred_dicts['pred_scores']).shape[0]
            pred_dicts = [{k: v[i] for k, v in pred_dicts.items()} for i in range(bs)]
        annos = []
        for index, box_dict in enumerate(pred_dicts):
            valid = np.asarray(box_dict['pred_valid'])
            scores = np.asarray(box_dict['pred_scores'])[valid]
            boxes = np.asarray(box_dict['pred_boxes'])[valid]
            labels = np.asarray(box_dict['pred_labels'])[valid]
            n = scores.shape[0]
            d = {'name': np.zeros(n), 'score': np.zeros(n), 'boxes_lidar': np.zeros([n, 7]),
                 'pred_labels': np.zeros(n)}
            if n > 0:
                d.update(name=np.array(class_names)[labels - 1], score=scores,
                         boxes_lidar=boxes, pred_labels=labels)
            d['frame_id'] = batch_dict['frame_id'][index]
            if 'metadata' in batch_dict:
                d['metadata'] = batch_dict['metadata'][index]
            annos.append(d)
        return annos

    def evaluation(self, det_annos, class_names, **kwargs):
        """The native ``detection_cvpr_2019`` metrics of ``det_annos`` (one
        per info, in order) against ``self.infos``: (text, {mAP, NDS,
        per-class AP at each distance and TP errors, mATE ... mAVE})."""
        from .nuscenes_eval_native import nuscenes_detection_eval
        return nuscenes_detection_eval(det_annos, self.infos, class_names)
