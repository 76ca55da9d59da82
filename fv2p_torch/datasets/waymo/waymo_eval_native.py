"""Native (numpy/scipy) Waymo detection metrics — a dependency-free
re-implementation of the ``waymo_open_dataset`` detection metric semantics
that the reference drives through TensorFlow ops
(reference ``pcdet/datasets/waymo/waymo_eval.py:9-23,203``). The port
has only this evaluator: the official one needs tensorflow and
``waymo_open_dataset``.

Semantics implemented, matching the config the reference builds
(``waymo_eval.py:89-117`` there):

- breakdown ``OBJECT_TYPE`` x difficulty ``{LEVEL_1, LEVEL_2}``;
- per-type 3D-IoU thresholds ``[-, 0.7, 0.5, 0.5, 0.5]`` for
  Vehicle/Pedestrian/Sign-slot/Cyclist;
- Hungarian matching per frame (maximize total IoU over pairs whose IoU
  exceeds the class threshold);
- score cutoffs ``0.00, 0.01, ..., 0.99, 1.0`` (101 points), the exact
  cutoff list the reference config enumerates;
- LEVEL_1 evaluates only difficulty-1 GT; predictions matched to a
  difficulty-2 GT are *ignored* (neither TP nor FP). LEVEL_2 evaluates all;
- AP = step integral of the precision/recall curve after making precision
  monotone non-increasing in recall (the standard interpolated AP the WOD
  ``ComputeMeanAveragePrecision`` performs over its cutoff-sampled curve);
- APH = same curve with every precision point scaled by the mean heading
  accuracy ``max(0, 1 - |wrap(theta_pd - theta_gt)| / pi)`` of its true
  positives (recall stays unweighted), per the WOD definition — perfect
  detection at uniform heading accuracy ``h`` scores ``APH = h``.

Known deviation from the TF library: WOD additionally inserts synthetic
points to penalize recall gaps larger than a fixed delta when integrating;
with the dense 101-cutoff sampling above the difference is bounded by one
cutoff's recall step and is zero for the fixture-scale regressions tested
here.
"""
import numpy as np

from ...utils.np_box_ops import boxes_iou3d_np


def limit_period(val, offset=0.5, period=np.pi):
    return val - np.floor(val / period + offset) * period


class NativeWaymoDetectionMetricsEstimator:
    """The ``waymo_evaluation`` call surface and ap_dict key scheme
    (``OBJECT_TYPE_TYPE_<CLASS>_LEVEL_<k>/AP[H]`` -> one-element list) of
    the reference's ``OpenPCDetWaymoDetectionMetricsEstimator``, without
    tensorflow or ``waymo_open_dataset``."""

    WAYMO_CLASSES = ['unknown', 'Vehicle', 'Pedestrian', 'Truck', 'Cyclist']
    # proto names by type id (Truck occupies the TYPE_SIGN slot, as in the
    # reference's class list)
    _PROTO_NAMES = ['UNKNOWN', 'VEHICLE', 'PEDESTRIAN', 'SIGN', 'CYCLIST']
    IOU_THRESHOLDS = [0.0, 0.7, 0.5, 0.5, 0.5]
    SCORE_CUTOFFS = np.concatenate([np.arange(100) * 0.01, [1.0]])

    def generate_waymo_type_results(self, infos, class_names, is_gt=False,
                                    fake_gt_infos=True):
        """Per-frame anno dicts -> flat arrays (reference :26-87)."""

        def fakelidar_to_lidar(boxes):
            w, l, h, r = boxes[:, 3:4], boxes[:, 4:5], boxes[:, 5:6], boxes[:, 6:7]
            boxes[:, 2] += h[:, 0] / 2
            return np.concatenate(
                [boxes[:, 0:3], l, w, h, -(r + np.pi / 2)], axis=-1)

        frame_id, boxes3d, obj_type = [], [], []
        score, difficulty = [], []
        for frame_index, info in enumerate(infos):
            if is_gt:
                box_mask = np.array([n in class_names for n in info['name']],
                                    dtype=np.bool_)
                if 'num_points_in_gt' not in info:
                    raise NotImplementedError(
                        'num_points_in_gt is required for Waymo evaluation')
                zero_diff = info['difficulty'] == 0
                info['difficulty'][(info['num_points_in_gt'] > 5) & zero_diff] = 1
                info['difficulty'][(info['num_points_in_gt'] <= 5) & zero_diff] = 2
                box_mask = box_mask & (info['num_points_in_gt'] > 0)

                num_boxes = int(box_mask.sum())
                box_name = info['name'][box_mask]
                difficulty.append(info['difficulty'][box_mask])
                score.append(np.ones(num_boxes))
                if fake_gt_infos:
                    info['gt_boxes_lidar'] = fakelidar_to_lidar(
                        info['gt_boxes_lidar'])
                boxes3d.append(
                    np.asarray(info['gt_boxes_lidar'],
                               np.float64)[box_mask].reshape(-1, 7))
            else:
                num_boxes = len(info['boxes_lidar'])
                difficulty.append([0] * num_boxes)
                score.append(np.asarray(info['score'], np.float64).reshape(-1))
                boxes3d.append(
                    np.asarray(info['boxes_lidar'], np.float64).reshape(-1, 7))
                box_name = info['name']

            obj_type += [self.WAYMO_CLASSES.index(name) for name in box_name]
            frame_id.append(np.full(num_boxes, frame_index, np.int64))

        frame_id = np.concatenate(frame_id).reshape(-1).astype(np.int64)
        boxes3d = np.concatenate(boxes3d, axis=0).reshape(-1, 7)
        obj_type = np.array(obj_type, np.int64).reshape(-1)
        score = np.concatenate(score).reshape(-1)
        difficulty = np.concatenate(difficulty).reshape(-1).astype(np.int8)
        if len(boxes3d):
            boxes3d[:, -1] = limit_period(boxes3d[:, -1], offset=0.5,
                                          period=np.pi * 2)
        return frame_id, boxes3d, obj_type, score, difficulty

    @staticmethod
    def mask_by_distance(distance_thresh, boxes_3d, *args):
        mask = np.linalg.norm(boxes_3d[:, 0:2], axis=1) < distance_thresh + 0.5
        return tuple([boxes_3d[mask]] + [arg[mask] for arg in args])

    @staticmethod
    def _hungarian_match(iou, thresh):
        """Maximize total IoU over pairs with iou > thresh.

        Returns (pd_idx, gt_idx) arrays of accepted matches."""
        from scipy.optimize import linear_sum_assignment
        if iou.size == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        cost = np.where(iou > thresh, -iou, 1.0)
        rows, cols = linear_sum_assignment(cost)
        ok = iou[rows, cols] > thresh
        return rows[ok], cols[ok]

    def _pr_points(self, frames, cls_id, level):
        """PR-curve samples for one (class, level) breakdown.

        Args:
            frames: list of per-frame dicts with keys pd_boxes, pd_scores,
                gt_boxes, gt_difficulty, iou (pd x gt table for this class).
        Returns:
            (num_cutoffs, 4) array of [tp_weight, fp, fn, tp_count]."""
        thresh = self.IOU_THRESHOLDS[cls_id]
        out = np.zeros((len(self.SCORE_CUTOFFS), 4), np.float64)
        for fr in frames:
            gt_level = fr['gt_difficulty']          # (G,) 1 or 2
            in_scope = (gt_level <= level)          # L1: only diff-1 GT
            for ci, cutoff in enumerate(self.SCORE_CUTOFFS):
                keep = fr['pd_scores'] >= cutoff
                iou = fr['iou'][keep]               # (P', G)
                pd_i, gt_i = self._hungarian_match(iou, thresh)
                matched_scope = in_scope[gt_i] if len(gt_i) else \
                    np.zeros(0, bool)
                ha = fr['heading_acc'][keep][pd_i, gt_i] if len(pd_i) else \
                    np.zeros(0)
                tp_w = float(ha[matched_scope].sum())
                tp_c = int(matched_scope.sum())
                # preds matched to out-of-scope GT are ignored entirely
                fp = int(keep.sum()) - len(pd_i)
                fn = int(in_scope.sum()) - tp_c
                out[ci] += (tp_w, fp, fn, tp_c)
        return out

    @staticmethod
    def _ap_from_counts(counts, weighted, max_recall_gap=None):
        """counts: (C, 4) [tp_weight, fp, fn, tp_count] per cutoff.

        AP uses raw counts. APH scales each precision point by the mean
        heading accuracy of its true positives (tp_weight / tp_count) while
        recall stays unweighted — the WOD definition, under which perfect
        detection with uniform heading accuracy h yields APH = h * AP.

        ``max_recall_gap``: pessimistic variant bounding the TF library's
        recall-gap penalty (see module docstring): a recall step larger than
        the gap is credited only ``max_recall_gap`` of step integral (as if
        the inserted synthetic points had precision 0). The true WOD value
        lies between this lower bound and the default (None) upper bound."""
        tp = counts[:, 0] if weighted else counts[:, 3]
        fp, fn, tp_c = counts[:, 1], counts[:, 2], counts[:, 3]
        denom_p = tp_c + fp
        denom_r = tp_c + fn
        precision = np.where(denom_p > 0, tp / np.maximum(denom_p, 1), 0.0)
        recall = np.where(denom_r > 0, tp_c / np.maximum(denom_r, 1), 0.0)
        # sort by recall ascending; enforce precision monotone non-increasing
        order = np.argsort(recall, kind='stable')
        r = recall[order]
        p = precision[order]
        p = np.maximum.accumulate(p[::-1])[::-1]
        r_prev = np.concatenate([[0.0], r[:-1]])
        dr = r - r_prev
        if max_recall_gap is not None:
            dr = np.minimum(dr, max_recall_gap)
        return float(np.sum(dr * p))

    def waymo_evaluation(self, prediction_infos, gt_infos, class_name,
                         distance_thresh=100, fake_gt_infos=True):
        assert len(prediction_infos) == len(gt_infos), \
            '%d vs %d' % (len(prediction_infos), len(gt_infos))
        pd_frameid, pd_boxes3d, pd_type, pd_score, _ = \
            self.generate_waymo_type_results(prediction_infos, class_name,
                                             is_gt=False)
        gt_frameid, gt_boxes3d, gt_type, _, gt_difficulty = \
            self.generate_waymo_type_results(gt_infos, class_name, is_gt=True,
                                             fake_gt_infos=fake_gt_infos)
        pd_boxes3d, pd_frameid, pd_type, pd_score = self.mask_by_distance(
            distance_thresh, pd_boxes3d, pd_frameid, pd_type, pd_score)
        gt_boxes3d, gt_frameid, gt_type, gt_difficulty = self.mask_by_distance(
            distance_thresh, gt_boxes3d, gt_frameid, gt_type, gt_difficulty)
        if len(pd_score) and pd_score.max() > 1:
            pd_score = 1 / (1 + np.exp(-pd_score))

        n_frames = len(gt_infos)
        ap_dict = {}
        for name in class_name:
            cls_id = self.WAYMO_CLASSES.index(name)
            frames = []
            for f in range(n_frames):
                pm = (pd_frameid == f) & (pd_type == cls_id)
                gm = (gt_frameid == f) & (gt_type == cls_id)
                if not pm.any() and not gm.any():
                    continue
                pd_b, gt_b = pd_boxes3d[pm], gt_boxes3d[gm]
                iou = boxes_iou3d_np(pd_b, gt_b)
                dtheta = np.abs(pd_b[:, None, 6] - gt_b[None, :, 6])
                dtheta = np.minimum(dtheta % (2 * np.pi),
                                    2 * np.pi - dtheta % (2 * np.pi))
                frames.append(dict(
                    pd_scores=pd_score[pm], gt_difficulty=gt_difficulty[gm],
                    iou=iou,
                    heading_acc=np.maximum(0.0, 1.0 - dtheta / np.pi)))
            proto = self._PROTO_NAMES[cls_id]
            for level in (1, 2):
                counts = self._pr_points(frames, cls_id, level)
                key = 'OBJECT_TYPE_TYPE_%s_LEVEL_%d' % (proto, level)
                ap_dict[key + '/AP'] = [self._ap_from_counts(counts, False)]
                ap_dict[key + '/APH'] = [self._ap_from_counts(counts, True)]
        return ap_dict
