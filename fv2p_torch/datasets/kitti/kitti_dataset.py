"""KITTI dataset (reference ``pcdet/datasets/kitti/kitti_dataset.py``):
info-pkl loading, FOV filtering, KITTI-format prediction dicts (lidar ->
camera -> image) and the official evaluation; and the data preparation that
writes the info pickles and the gt database from a KITTI tree
(``create_kitti_infos``):

    python -c "from pathlib import Path; \\
        from fv2p_torch.config import EasyDict, cfg_from_yaml_file; \\
        from fv2p_torch.datasets.kitti.kitti_dataset import create_kitti_infos; \\
        cfg = EasyDict(); \\
        cfg_from_yaml_file('tools/cfgs/dataset_configs/kitti_dataset.yaml', cfg); \\
        create_kitti_infos(cfg, ['Car', 'Pedestrian', 'Cyclist'], \\
                           Path('data/kitti'), Path('data/kitti'))"

The points-in-box test of the preparation is host numpy
(``box_utils.points_in_boxes_np``), so the pickles and the
database's ``.bin`` files are those of the JAX package's preparation."""
import concurrent.futures
import copy
import pickle
import struct

import numpy as np

from ...utils import box_utils, calibration_kitti, common_utils, object3d_kitti
from ..dataset import DatasetTemplate


class KittiDataset(DatasetTemplate):
    def __init__(self, dataset_cfg, class_names, training=True, root_path=None,
                 logger=None, rng=None):
        super().__init__(dataset_cfg=dataset_cfg, class_names=class_names,
                         training=training, root_path=root_path, logger=logger, rng=rng)
        self.split = self.dataset_cfg.DATA_SPLIT[self.mode]
        self.root_split_path = self.root_path / (
            'training' if self.split != 'test' else 'testing')

        split_dir = self.root_path / 'ImageSets' / (self.split + '.txt')
        self.sample_id_list = [x.strip() for x in split_dir.read_text().splitlines()] \
            if split_dir.exists() else None

        self.kitti_infos = []
        self.include_kitti_data(self.mode)

    def include_kitti_data(self, mode):
        if self.logger is not None:
            self.logger.info('Loading KITTI dataset')
        kitti_infos = []
        for info_path in self.dataset_cfg.INFO_PATH[mode]:
            info_path = self.root_path / info_path
            if not info_path.exists():
                continue
            with open(info_path, 'rb') as f:
                infos = pickle.load(f)
                kitti_infos.extend(infos)
        self.kitti_infos.extend(kitti_infos)
        if self.logger is not None:
            self.logger.info('Total samples for KITTI dataset: %d'
                             % (len(kitti_infos)))

    def set_split(self, split):
        """Point the dataset at another split of the same tree (its
        ImageSets list and its training/testing directory)."""
        super().__init__(dataset_cfg=self.dataset_cfg, class_names=self.class_names,
                         training=self.training, root_path=self.root_path,
                         logger=self.logger, rng=self.rng)
        self.split = split
        self.root_split_path = self.root_path / (
            'training' if self.split != 'test' else 'testing')
        split_dir = self.root_path / 'ImageSets' / (self.split + '.txt')
        self.sample_id_list = [x.strip() for x in split_dir.read_text().splitlines()] \
            if split_dir.exists() else None

    def get_lidar(self, idx):
        lidar_file = self.root_split_path / 'velodyne' / ('%s.bin' % idx)
        return np.fromfile(str(lidar_file), dtype=np.float32).reshape(-1, 4)

    def get_image_shape(self, idx):
        """(height, width) int32 of the PNG, read from its IHDR header."""
        img_file = self.root_split_path / 'image_2' / ('%s.png' % idx)
        with open(img_file, 'rb') as f:
            f.seek(16)
            w, h = struct.unpack('>II', f.read(8))
        return np.array([h, w], dtype=np.int32)

    def get_label(self, idx):
        label_file = self.root_split_path / 'label_2' / ('%s.txt' % idx)
        return object3d_kitti.get_objects_from_label(label_file)

    def get_calib(self, idx):
        calib_file = self.root_split_path / 'calib' / ('%s.txt' % idx)
        return calibration_kitti.Calibration(calib_file)

    def get_road_plane(self, idx):
        plane_file = self.root_split_path / 'planes' / ('%s.txt' % idx)
        if not plane_file.exists():
            return None
        with open(plane_file, 'r') as f:
            lines = f.readlines()
        lines = [float(i) for i in lines[3].split()]
        plane = np.asarray(lines)
        if plane[1] > 0:
            plane = -plane
        norm = np.linalg.norm(plane[0:3])
        return plane / norm

    @staticmethod
    def get_fov_flag(pts_rect, img_shape, calib):
        pts_img, pts_rect_depth = calib.rect_to_img(pts_rect)
        val_flag_1 = np.logical_and(pts_img[:, 0] >= 0, pts_img[:, 0] < img_shape[1])
        val_flag_2 = np.logical_and(pts_img[:, 1] >= 0, pts_img[:, 1] < img_shape[0])
        val_flag_merge = np.logical_and(val_flag_1, val_flag_2)
        return np.logical_and(val_flag_merge, pts_rect_depth >= 0)

    def get_infos(self, num_workers=4, has_label=True, count_inside_pts=True,
                  sample_id_list=None):
        """One info dict per sample of ``sample_id_list`` (default: the
        split's), in that order, built in a pool of ``num_workers`` threads:
        image shape, calibration, and with ``has_label`` the annotations
        with the gt boxes in the lidar frame and (``count_inside_pts``) the
        number of the FOV's points inside each."""

        def process_single_scene(sample_idx):
            info = {'point_cloud': {'num_features': 4, 'lidar_idx': sample_idx},
                    'image': {'image_idx': sample_idx,
                              'image_shape': self.get_image_shape(sample_idx)}}
            calib = self.get_calib(sample_idx)
            P2 = np.concatenate([calib.P2, np.array([[0., 0., 0., 1.]])], axis=0)
            R0_4x4 = np.zeros([4, 4], dtype=calib.R0.dtype)
            R0_4x4[3, 3] = 1.
            R0_4x4[:3, :3] = calib.R0
            V2C_4x4 = np.concatenate([calib.V2C, np.array([[0., 0., 0., 1.]])], axis=0)
            info['calib'] = {'P2': P2, 'R0_rect': R0_4x4, 'Tr_velo_to_cam': V2C_4x4}
            if has_label:
                info['annos'] = self._annotations(sample_idx, calib, info,
                                                  count_inside_pts)
            return info

        sample_id_list = sample_id_list if sample_id_list is not None \
            else self.sample_id_list
        with concurrent.futures.ThreadPoolExecutor(num_workers) as executor:
            return list(executor.map(process_single_scene, sample_id_list))

    def _annotations(self, sample_idx, calib, info, count_inside_pts):
        obj_list = self.get_label(sample_idx)
        annotations = {
            'name': np.array([obj.cls_type for obj in obj_list]),
            'truncated': np.array([obj.truncation for obj in obj_list]),
            'occluded': np.array([obj.occlusion for obj in obj_list]),
            'alpha': np.array([obj.alpha for obj in obj_list]),
            'bbox': np.concatenate([obj.box2d.reshape(1, 4) for obj in obj_list], axis=0)
            if obj_list else np.zeros((0, 4)),
            'dimensions': np.array([[obj.l, obj.h, obj.w] for obj in obj_list]).reshape(-1, 3),
            'location': np.concatenate([obj.loc.reshape(1, 3) for obj in obj_list], axis=0)
            if obj_list else np.zeros((0, 3)),
            'rotation_y': np.array([obj.ry for obj in obj_list]),
            'score': np.array([obj.score for obj in obj_list]),
            'difficulty': np.array([obj.level for obj in obj_list], np.int32),
        }
        num_objects = len([obj for obj in obj_list if obj.cls_type != 'DontCare'])
        num_gt = len(annotations['name'])
        annotations['index'] = np.array(
            list(range(num_objects)) + [-1] * (num_gt - num_objects), dtype=np.int32)

        loc = annotations['location'][:num_objects]
        dims = annotations['dimensions'][:num_objects]
        rots = annotations['rotation_y'][:num_objects]
        loc_lidar = calib.rect_to_lidar(loc)
        l, h, w = dims[:, 0:1], dims[:, 1:2], dims[:, 2:3]
        loc_lidar[:, 2] += h[:, 0] / 2
        gt_boxes_lidar = np.concatenate(
            [loc_lidar, l, w, h, -(np.pi / 2 + rots[..., np.newaxis])], axis=1)
        annotations['gt_boxes_lidar'] = gt_boxes_lidar

        if count_inside_pts:
            points = self.get_lidar(sample_idx)
            pts_rect = calib.lidar_to_rect(points[:, 0:3])
            fov_flag = self.get_fov_flag(pts_rect, info['image']['image_shape'], calib)
            num_points_in_gt = -np.ones(num_gt, dtype=np.int32)
            if num_objects > 0:
                num_points_in_gt[:num_objects] = box_utils.points_in_boxes_np(
                    points[fov_flag], gt_boxes_lidar).sum(axis=1)
            annotations['num_points_in_gt'] = num_points_in_gt
        return annotations

    def create_groundtruth_database(self, info_path=None, used_classes=None,
                                    split='train'):
        """Write each annotated object's points, relative to its box
        centre, to ``gt_database[_<split>]/<sample>_<name>_<i>.bin``, and the
        database of ``used_classes`` (every class: None) to
        ``kitti_dbinfos_<split>.pkl``, from the infos at ``info_path``."""
        database_save_path = self.root_path / ('gt_database' if split == 'train'
                                               else 'gt_database_%s' % split)
        db_info_save_path = self.root_path / ('kitti_dbinfos_%s.pkl' % split)
        database_save_path.mkdir(parents=True, exist_ok=True)
        all_db_infos = {}
        with open(info_path, 'rb') as f:
            infos = pickle.load(f)

        for info in infos:
            sample_idx = info['point_cloud']['lidar_idx']
            points = self.get_lidar(sample_idx)
            annos = info['annos']
            names = annos['name']
            gt_boxes = annos['gt_boxes_lidar']
            if gt_boxes.shape[0] == 0:
                continue
            point_indices = box_utils.points_in_boxes_np(points, gt_boxes)
            for i in range(gt_boxes.shape[0]):
                filepath = database_save_path / ('%s_%s_%d.bin' % (sample_idx, names[i], i))
                gt_points = points[point_indices[i]]
                gt_points[:, :3] -= gt_boxes[i, :3]
                gt_points.tofile(filepath)
                if used_classes is None or names[i] in used_classes:
                    all_db_infos.setdefault(names[i], []).append({
                        'name': names[i], 'path': str(filepath.relative_to(self.root_path)),
                        'image_idx': sample_idx, 'gt_idx': i, 'box3d_lidar': gt_boxes[i],
                        'num_points_in_gt': gt_points.shape[0],
                        'difficulty': annos['difficulty'][i], 'bbox': annos['bbox'][i],
                        'score': annos['score'][i]})
        for k, v in all_db_infos.items():
            print('Database %s: %d' % (k, len(v)))
        with open(db_info_save_path, 'wb') as f:
            pickle.dump(all_db_infos, f)

    @staticmethod
    def generate_prediction_dicts(batch_dict, pred_dicts, class_names,
                                  output_path=None):
        """Fixed-shape device outputs -> KITTI-format prediction dicts
        (reference kitti_dataset.py:245-320)."""

        def get_template_prediction(num_samples):
            return {
                'name': np.zeros(num_samples), 'truncated': np.zeros(num_samples),
                'occluded': np.zeros(num_samples), 'alpha': np.zeros(num_samples),
                'bbox': np.zeros([num_samples, 4]),
                'dimensions': np.zeros([num_samples, 3]),
                'location': np.zeros([num_samples, 3]),
                'rotation_y': np.zeros(num_samples), 'score': np.zeros(num_samples),
                'boxes_lidar': np.zeros([num_samples, 7]),
            }

        def generate_single_sample_dict(batch_index, box_dict):
            valid = np.asarray(box_dict['pred_valid'])
            pred_scores = np.asarray(box_dict['pred_scores'])[valid]
            pred_boxes = np.asarray(box_dict['pred_boxes'])[valid]
            pred_labels = np.asarray(box_dict['pred_labels'])[valid]
            pred_dict = get_template_prediction(pred_scores.shape[0])
            if pred_scores.shape[0] == 0:
                return pred_dict

            calib = batch_dict['calib'][batch_index]
            image_shape = batch_dict['image_shape'][batch_index]
            pred_boxes_camera = box_utils.boxes3d_lidar_to_kitti_camera(
                pred_boxes, calib)
            pred_boxes_img = box_utils.boxes3d_kitti_camera_to_imageboxes(
                pred_boxes_camera, calib, image_shape=image_shape)

            pred_dict['name'] = np.array(class_names)[pred_labels - 1]
            pred_dict['alpha'] = (-np.arctan2(-pred_boxes[:, 1], pred_boxes[:, 0])
                                  + pred_boxes_camera[:, 6])
            pred_dict['bbox'] = pred_boxes_img
            pred_dict['dimensions'] = pred_boxes_camera[:, 3:6]
            pred_dict['location'] = pred_boxes_camera[:, 0:3]
            pred_dict['rotation_y'] = pred_boxes_camera[:, 6]
            pred_dict['score'] = pred_scores
            pred_dict['boxes_lidar'] = pred_boxes
            return pred_dict

        annos = []
        batch_size = len(pred_dicts) if isinstance(pred_dicts, list) \
            else np.asarray(pred_dicts['pred_scores']).shape[0]
        for index in range(batch_size):
            if isinstance(pred_dicts, list):
                box_dict = pred_dicts[index]
            else:
                box_dict = {k: v[index] for k, v in pred_dicts.items()}
            frame_id = batch_dict['frame_id'][index]
            single_pred_dict = generate_single_sample_dict(index, box_dict)
            single_pred_dict['frame_id'] = frame_id
            annos.append(single_pred_dict)

            if output_path is not None:
                cur_det_file = output_path / ('%s.txt' % frame_id)
                with open(cur_det_file, 'w') as f:
                    bbox = single_pred_dict['bbox']
                    loc = single_pred_dict['location']
                    dims = single_pred_dict['dimensions']
                    for idx in range(len(bbox)):
                        print('%s -1 -1 %.4f %.4f %.4f %.4f %.4f %.4f %.4f %.4f '
                              '%.4f %.4f %.4f %.4f %.4f'
                              % (single_pred_dict['name'][idx],
                                 single_pred_dict['alpha'][idx],
                                 bbox[idx][0], bbox[idx][1], bbox[idx][2],
                                 bbox[idx][3], dims[idx][1], dims[idx][2],
                                 dims[idx][0], loc[idx][0], loc[idx][1],
                                 loc[idx][2], single_pred_dict['rotation_y'][idx],
                                 single_pred_dict['score'][idx]), file=f)
        return annos

    def evaluation(self, det_annos, class_names, device=None, **kwargs):
        """Official KITTI AP of ``det_annos`` (one per info, in order); the
        rotated overlaps run on ``device`` (None: the CUDA card)."""
        if 'annos' not in self.kitti_infos[0].keys():
            return None, {}
        from .kitti_object_eval import eval as kitti_eval
        eval_det_annos = copy.deepcopy(det_annos)
        eval_gt_annos = [copy.deepcopy(info['annos']) for info in self.kitti_infos]
        ap_result_str, ap_dict = kitti_eval.get_official_eval_result(
            eval_gt_annos, eval_det_annos, class_names, device=device)
        return ap_result_str, ap_dict

    def __len__(self):
        if self._merge_all_iters_to_one_epoch:
            return len(self.kitti_infos) * self.total_epochs
        return len(self.kitti_infos)

    def __getitem__(self, index):
        if self._merge_all_iters_to_one_epoch:
            index = index % len(self.kitti_infos)
        info = copy.deepcopy(self.kitti_infos[index])
        sample_idx = info['point_cloud']['lidar_idx']

        points = self.get_lidar(sample_idx)
        calib = self.get_calib(sample_idx)
        img_shape = info['image']['image_shape']
        if self.dataset_cfg.FOV_POINTS_ONLY:
            pts_rect = calib.lidar_to_rect(points[:, 0:3])
            fov_flag = self.get_fov_flag(pts_rect, img_shape, calib)
            points = points[fov_flag]

        input_dict = {'points': points, 'frame_id': sample_idx, 'calib': calib}

        if 'annos' in info:
            annos = info['annos']
            annos = common_utils.drop_info_with_name(annos, name='DontCare')
            gt_names = annos['name']
            gt_boxes_lidar = annos['gt_boxes_lidar']
            input_dict.update({'gt_names': gt_names, 'gt_boxes': gt_boxes_lidar})
            road_plane = self.get_road_plane(sample_idx)
            if road_plane is not None:
                input_dict['road_plane'] = road_plane

        data_dict = self.prepare_data(data_dict=input_dict)
        data_dict['image_shape'] = img_shape
        # calib stays in the sample: collate passes it through as a list and
        # generate_prediction_dicts needs it for the lidar -> camera -> image
        # conversion
        return data_dict



def create_kitti_infos(dataset_cfg, class_names, data_path, save_path, workers=4):
    """``kitti_infos_{train,val,trainval}.pkl`` under ``save_path`` from the
    KITTI tree at ``data_path``, then the train split's gt database
    (``gt_database/``, ``kitti_dbinfos_train.pkl``) under ``data_path``."""
    dataset = KittiDataset(dataset_cfg=dataset_cfg, class_names=class_names,
                           root_path=data_path, training=False)
    train_filename = save_path / 'kitti_infos_train.pkl'
    infos = {}
    for split in ('train', 'val'):
        dataset.set_split(split)
        infos[split] = dataset.get_infos(num_workers=workers, has_label=True,
                                         count_inside_pts=True)
        with open(save_path / ('kitti_infos_%s.pkl' % split), 'wb') as f:
            pickle.dump(infos[split], f)
    with open(save_path / 'kitti_infos_trainval.pkl', 'wb') as f:
        pickle.dump(infos['train'] + infos['val'], f)

    dataset.set_split('train')
    dataset.create_groundtruth_database(train_filename, class_names, split='train')
