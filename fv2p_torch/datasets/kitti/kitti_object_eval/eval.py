"""Official KITTI AP evaluation (the devkit's algorithm, as the reference's
``pcdet/datasets/kitti/kitti_object_eval_python/eval.py`` computes it).

  * the greedy matching loops run in a small C++ library
    (``native_eval.cpp``, built by g++ at first use, loaded with ctypes);
  * rotated BEV / 3D overlaps are the intersection areas of kernel B1
    (``utils/iou3d.boxes_overlap_bev``) on the device the caller names: a
    CUDA device launches the kernel, the CPU takes its plain version;
  * image-box IoU is vectorized numpy.
"""
import ctypes
from pathlib import Path

import numpy as np
import torch

from ....utils import iou3d, native

NATIVE_SRC = Path(__file__).resolve().parent / 'native_eval.cpp'
_DP, _LP = ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64)
_I, _D = ctypes.c_int, ctypes.c_double
_NATIVE_SIGNATURES = {
    'collect_tp_scores': ((_DP, _I, _I, _DP, _DP, _LP, _LP, _I, _D, _DP), _I),
    'accumulate_pr': ((_DP, _I, _I, _DP, _DP, _LP, _LP, _DP, _I, _I, _D, _DP,
                       _I, _I, _DP), _I),
}


def _dptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _lptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def get_thresholds(scores, num_gt, num_sample_pts=41):
    scores = np.sort(scores)[::-1]
    current_recall = 0
    thresholds = []
    for i, score in enumerate(scores):
        l_recall = (i + 1) / num_gt
        r_recall = (i + 2) / num_gt if i < (len(scores) - 1) else l_recall
        if (((r_recall - current_recall) < (current_recall - l_recall))
                and (i < (len(scores) - 1))):
            continue
        thresholds.append(score)
        current_recall += 1 / (num_sample_pts - 1.0)
    return thresholds


def clean_data(gt_anno, dt_anno, current_class, difficulty):
    CLASS_NAMES = ['car', 'pedestrian', 'cyclist', 'van', 'person_sitting', 'truck']
    MIN_HEIGHT = [40, 25, 25]
    MAX_OCCLUSION = [0, 1, 2]
    MAX_TRUNCATION = [0.15, 0.3, 0.5]
    dc_bboxes, ignored_gt, ignored_dt = [], [], []
    current_cls_name = CLASS_NAMES[current_class].lower()
    num_gt = len(gt_anno['name'])
    num_dt = len(dt_anno['name'])
    num_valid_gt = 0
    for i in range(num_gt):
        bbox = gt_anno['bbox'][i]
        gt_name = gt_anno['name'][i].lower()
        height = bbox[3] - bbox[1]
        if gt_name == current_cls_name:
            valid_class = 1
        elif current_cls_name == 'pedestrian' and gt_name == 'person_sitting':
            valid_class = 0
        elif current_cls_name == 'car' and gt_name == 'van':
            valid_class = 0
        else:
            valid_class = -1
        ignore = bool(gt_anno['occluded'][i] > MAX_OCCLUSION[difficulty]
                      or gt_anno['truncated'][i] > MAX_TRUNCATION[difficulty]
                      or height <= MIN_HEIGHT[difficulty])
        if valid_class == 1 and not ignore:
            ignored_gt.append(0)
            num_valid_gt += 1
        elif valid_class == 0 or (ignore and valid_class == 1):
            ignored_gt.append(1)
        else:
            ignored_gt.append(-1)
        if gt_anno['name'][i] == 'DontCare':
            dc_bboxes.append(gt_anno['bbox'][i])
    for i in range(num_dt):
        valid_class = 1 if dt_anno['name'][i].lower() == current_cls_name else -1
        height = abs(dt_anno['bbox'][i, 3] - dt_anno['bbox'][i, 1])
        if height < MIN_HEIGHT[difficulty]:
            ignored_dt.append(1)
        elif valid_class == 1:
            ignored_dt.append(0)
        else:
            ignored_dt.append(-1)
    return num_valid_gt, ignored_gt, ignored_dt, dc_bboxes


def image_box_overlap(boxes, query_boxes, criterion=-1):
    """Vectorized (N, K) axis-aligned IoU (reference image_box_overlap)."""
    n, k = boxes.shape[0], query_boxes.shape[0]
    if n == 0 or k == 0:
        return np.zeros((n, k), dtype=np.float64)
    iw = (np.minimum(boxes[:, None, 2], query_boxes[None, :, 2])
          - np.maximum(boxes[:, None, 0], query_boxes[None, :, 0]))
    ih = (np.minimum(boxes[:, None, 3], query_boxes[None, :, 3])
          - np.maximum(boxes[:, None, 1], query_boxes[None, :, 1]))
    inter = np.where((iw > 0) & (ih > 0), iw * ih, 0.0)
    area_a = ((boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]))[:, None]
    area_b = ((query_boxes[:, 2] - query_boxes[:, 0])
              * (query_boxes[:, 3] - query_boxes[:, 1]))[None, :]
    if criterion == -1:
        ua = area_a + area_b - inter
    elif criterion == 0:
        ua = np.broadcast_to(area_a, inter.shape)
    elif criterion == 1:
        ua = np.broadcast_to(area_b, inter.shape)
    else:
        ua = np.ones_like(inter)
    return np.where(inter > 0, inter / ua, 0.0)


def _rotated_overlap_area(boxes_xzlwr, qboxes_xzlwr, device):
    """Exact rotated-rect intersection areas (N, K) of camera-frame BEV boxes
    (x, z, l, w, ry), from kernel B1's overlap entry point on ``device``."""
    n, k = boxes_xzlwr.shape[0], qboxes_xzlwr.shape[0]
    if n == 0 or k == 0:
        return np.zeros((n, k), dtype=np.float64)

    def to7(b):
        out = np.zeros((b.shape[0], 7), np.float32)
        out[:, 0] = b[:, 0]          # x
        out[:, 1] = b[:, 1]          # z -> y
        out[:, 3] = b[:, 2]          # l -> dx
        out[:, 4] = b[:, 3]          # w -> dy
        out[:, 5] = 1.0
        out[:, 6] = -b[:, 4]         # consistent angle mapping
        return torch.from_numpy(out).to(device)

    area = iou3d.boxes_overlap_bev(to7(boxes_xzlwr), to7(qboxes_xzlwr))
    return area.cpu().numpy().astype(np.float64)


def bev_box_overlap(boxes, qboxes, device, criterion=-1):
    inter = _rotated_overlap_area(boxes, qboxes, device)
    area_a = (boxes[:, 2] * boxes[:, 3])[:, None]
    area_b = (qboxes[:, 2] * qboxes[:, 3])[None, :]
    if criterion == -1:
        ua = area_a + area_b - inter
    elif criterion == 0:
        ua = np.broadcast_to(area_a, inter.shape)
    elif criterion == 1:
        ua = np.broadcast_to(area_b, inter.shape)
    else:
        return inter
    return np.where(ua > 0, inter / ua, 0.0)


def d3_box_overlap(boxes, qboxes, device, criterion=-1):
    """Camera-frame 3D IoU (reference d3_box_overlap + kernel): boxes
    (x, y, z, l, h, w, ry), y down, y == bottom."""
    rinc = _rotated_overlap_area(boxes[:, [0, 2, 3, 5, 6]],
                                 qboxes[:, [0, 2, 3, 5, 6]], device)
    n, k = rinc.shape
    if n == 0 or k == 0:
        return rinc
    iw = (np.minimum(boxes[:, None, 1], qboxes[None, :, 1])
          - np.maximum(boxes[:, None, 1] - boxes[:, None, 4],
                       qboxes[None, :, 1] - qboxes[None, :, 4]))
    vol_a = (boxes[:, 3] * boxes[:, 4] * boxes[:, 5])[:, None]
    vol_b = (qboxes[:, 3] * qboxes[:, 4] * qboxes[:, 5])[None, :]
    inc = np.where(iw > 0, iw * rinc, 0.0)
    if criterion == -1:
        ua = vol_a + vol_b - inc
    elif criterion == 0:
        ua = np.broadcast_to(vol_a, inc.shape)
    elif criterion == 1:
        ua = np.broadcast_to(vol_b, inc.shape)
    else:
        ua = np.ones_like(inc)
    return np.where((rinc > 0) & (iw > 0), inc / ua, 0.0)


def calculate_iou_per_image(gt_annos, dt_annos, metric, device):
    """(num_dt_i, num_gt_i) overlap per image (the reference's partly batching
    is a CUDA-launch amortization; per-image is fine here — the polygon
    clipper is already batched internally)."""
    overlaps = []
    for gt, dt in zip(gt_annos, dt_annos):
        if metric == 0:
            ov = image_box_overlap(dt['bbox'].astype(np.float64),
                                   gt['bbox'].astype(np.float64))
        elif metric == 1:
            def bev(a):
                return np.concatenate(
                    [a['location'][:, [0, 2]], a['dimensions'][:, [0, 2]],
                     a['rotation_y'][..., None]], axis=1)
            ov = bev_box_overlap(bev(dt), bev(gt), device).astype(np.float64)
        elif metric == 2:
            def cam(a):
                return np.concatenate(
                    [a['location'], a['dimensions'], a['rotation_y'][..., None]],
                    axis=1)
            ov = d3_box_overlap(cam(dt), cam(gt), device).astype(np.float64)
        else:
            raise ValueError('unknown metric')
        overlaps.append(np.ascontiguousarray(ov, dtype=np.float64))
    return overlaps


def _prepare_data(gt_annos, dt_annos, current_class, difficulty):
    gt_datas_list, dt_datas_list = [], []
    ignored_gts, ignored_dets, dontcares = [], [], []
    total_num_valid_gt = 0
    for i in range(len(gt_annos)):
        num_valid_gt, ignored_gt, ignored_det, dc_bboxes = clean_data(
            gt_annos[i], dt_annos[i], current_class, difficulty)
        ignored_gts.append(np.array(ignored_gt, dtype=np.int64))
        ignored_dets.append(np.array(ignored_det, dtype=np.int64))
        dc = np.zeros((0, 4), np.float64) if len(dc_bboxes) == 0 \
            else np.stack(dc_bboxes, 0).astype(np.float64)
        dontcares.append(np.ascontiguousarray(dc))
        total_num_valid_gt += num_valid_gt
        gt_datas = np.concatenate(
            [gt_annos[i]['bbox'], gt_annos[i]['alpha'][..., None]], 1)
        dt_datas = np.concatenate(
            [dt_annos[i]['bbox'], dt_annos[i]['alpha'][..., None],
             dt_annos[i]['score'][..., None]], 1)
        gt_datas_list.append(np.ascontiguousarray(gt_datas, np.float64))
        dt_datas_list.append(np.ascontiguousarray(dt_datas, np.float64))
    return (gt_datas_list, dt_datas_list, ignored_gts, ignored_dets, dontcares,
            total_num_valid_gt)


def eval_class(gt_annos, dt_annos, current_classes, difficultys, metric,
               min_overlaps, device, compute_aos=False):
    if len(gt_annos) != len(dt_annos):
        raise ValueError(f'{len(gt_annos)} gt annos but {len(dt_annos)} det annos')
    lib = native.load(NATIVE_SRC, _NATIVE_SIGNATURES)
    overlaps = calculate_iou_per_image(gt_annos, dt_annos, metric, device)
    N_SAMPLE_PTS = 41
    num_minoverlap = len(min_overlaps)
    num_class = len(current_classes)
    num_difficulty = len(difficultys)
    precision = np.zeros([num_class, num_difficulty, num_minoverlap, N_SAMPLE_PTS])
    recall = np.zeros([num_class, num_difficulty, num_minoverlap, N_SAMPLE_PTS])
    aos = np.zeros([num_class, num_difficulty, num_minoverlap, N_SAMPLE_PTS])

    for m, current_class in enumerate(current_classes):
        for le, difficulty in enumerate(difficultys):
            (gt_datas_list, dt_datas_list, ignored_gts, ignored_dets,
             dontcares, total_num_valid_gt) = _prepare_data(
                gt_annos, dt_annos, current_class, difficulty)
            for k, min_overlap in enumerate(min_overlaps[:, metric, m]):
                thresholdss = []
                buf = np.zeros(4096, np.float64)
                for i in range(len(gt_annos)):
                    ng, nd = len(ignored_gts[i]), len(ignored_dets[i])
                    n = lib.collect_tp_scores(
                        _dptr(overlaps[i]), ng, nd, _dptr(gt_datas_list[i]),
                        _dptr(dt_datas_list[i]), _lptr(ignored_gts[i]),
                        _lptr(ignored_dets[i]), metric, float(min_overlap),
                        _dptr(buf))
                    if n < 0:
                        raise ValueError('more than 4096 boxes in one image')
                    thresholdss += buf[:n].tolist()
                thresholds = np.ascontiguousarray(
                    get_thresholds(np.array(thresholdss), total_num_valid_gt),
                    np.float64)
                pr = np.zeros([len(thresholds), 4], np.float64)
                for i in range(len(gt_annos)):
                    ng, nd = len(ignored_gts[i]), len(ignored_dets[i])
                    rc = lib.accumulate_pr(
                        _dptr(overlaps[i]), ng, nd, _dptr(gt_datas_list[i]),
                        _dptr(dt_datas_list[i]), _lptr(ignored_gts[i]),
                        _lptr(ignored_dets[i]), _dptr(dontcares[i]),
                        dontcares[i].shape[0], metric, float(min_overlap),
                        _dptr(thresholds), len(thresholds),
                        int(compute_aos), _dptr(pr))
                    if rc != 0:
                        raise ValueError('more than 4096 boxes in one image')
                for i in range(len(thresholds)):
                    recall[m, le, k, i] = pr[i, 0] / max(pr[i, 0] + pr[i, 2], 1e-12)
                    precision[m, le, k, i] = pr[i, 0] / max(pr[i, 0] + pr[i, 1], 1e-12)
                    if compute_aos:
                        aos[m, le, k, i] = pr[i, 3] / max(pr[i, 0] + pr[i, 1], 1e-12)
                for i in range(len(thresholds)):
                    precision[m, le, k, i] = np.max(precision[m, le, k, i:], axis=-1)
                    recall[m, le, k, i] = np.max(recall[m, le, k, i:], axis=-1)
                    if compute_aos:
                        aos[m, le, k, i] = np.max(aos[m, le, k, i:], axis=-1)
    return {'recall': recall, 'precision': precision, 'orientation': aos}


def get_mAP(prec):
    sums = 0
    for i in range(0, prec.shape[-1], 4):
        sums = sums + prec[..., i]
    return sums / 11 * 100


def get_mAP_R40(prec):
    sums = 0
    for i in range(1, prec.shape[-1]):
        sums = sums + prec[..., i]
    return sums / 40 * 100


def do_eval(gt_annos, dt_annos, current_classes, min_overlaps, device,
            compute_aos=False, PR_detail_dict=None):
    difficultys = [0, 1, 2]
    ret = eval_class(gt_annos, dt_annos, current_classes, difficultys, 0,
                     min_overlaps, device, compute_aos)
    mAP_bbox = get_mAP(ret['precision'])
    mAP_bbox_R40 = get_mAP_R40(ret['precision'])
    if PR_detail_dict is not None:
        PR_detail_dict['bbox'] = ret['precision']
    mAP_aos = mAP_aos_R40 = None
    if compute_aos:
        mAP_aos = get_mAP(ret['orientation'])
        mAP_aos_R40 = get_mAP_R40(ret['orientation'])
        if PR_detail_dict is not None:
            PR_detail_dict['aos'] = ret['orientation']
    ret = eval_class(gt_annos, dt_annos, current_classes, difficultys, 1,
                     min_overlaps, device)
    mAP_bev = get_mAP(ret['precision'])
    mAP_bev_R40 = get_mAP_R40(ret['precision'])
    if PR_detail_dict is not None:
        PR_detail_dict['bev'] = ret['precision']
    ret = eval_class(gt_annos, dt_annos, current_classes, difficultys, 2,
                     min_overlaps, device)
    mAP_3d = get_mAP(ret['precision'])
    mAP_3d_R40 = get_mAP_R40(ret['precision'])
    if PR_detail_dict is not None:
        PR_detail_dict['3d'] = ret['precision']
    return (mAP_bbox, mAP_bev, mAP_3d, mAP_aos, mAP_bbox_R40, mAP_bev_R40,
            mAP_3d_R40, mAP_aos_R40)


def get_official_eval_result(gt_annos, dt_annos, current_classes,
                             PR_detail_dict=None, device=None):
    """(result text, AP dict) of the official KITTI metrics. The rotated
    overlaps run on ``device``: None means the CUDA card (and raises
    without one); pass ``device='cpu'`` for the plain version."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError('get_official_eval_result: no CUDA device; '
                               "pass device='cpu' to run on the CPU")
        device = 'cuda'
    overlap_0_7 = np.array(
        [[0.7, 0.5, 0.5, 0.7, 0.5, 0.7], [0.7, 0.5, 0.5, 0.7, 0.5, 0.7],
         [0.7, 0.5, 0.5, 0.7, 0.5, 0.7]])
    overlap_0_5 = np.array(
        [[0.7, 0.5, 0.5, 0.7, 0.5, 0.5], [0.5, 0.25, 0.25, 0.5, 0.25, 0.5],
         [0.5, 0.25, 0.25, 0.5, 0.25, 0.5]])
    min_overlaps = np.stack([overlap_0_7, overlap_0_5], axis=0)  # [2, 3, 6]
    class_to_name = {0: 'Car', 1: 'Pedestrian', 2: 'Cyclist', 3: 'Van',
                     4: 'Person_sitting', 5: 'Truck'}
    name_to_class = {v: n for n, v in class_to_name.items()}
    if not isinstance(current_classes, (list, tuple)):
        current_classes = [current_classes]
    current_classes_int = []
    for curcls in current_classes:
        if isinstance(curcls, str):
            current_classes_int.append(name_to_class[curcls])
        else:
            current_classes_int.append(curcls)
    current_classes = current_classes_int
    min_overlaps = min_overlaps[:, :, current_classes]
    result = ''
    compute_aos = False
    for anno in dt_annos:
        if anno['alpha'].shape[0] != 0:
            if anno['alpha'][0] != -10:
                compute_aos = True
            break
    (mAPbbox, mAPbev, mAP3d, mAPaos, mAPbbox_R40, mAPbev_R40, mAP3d_R40,
     mAPaos_R40) = do_eval(gt_annos, dt_annos, current_classes, min_overlaps,
                           device, compute_aos, PR_detail_dict=PR_detail_dict)

    ret_dict = {}
    for j, curcls in enumerate(current_classes):
        for i in range(min_overlaps.shape[0]):
            result += ('%s AP@%.2f, %.2f, %.2f:\n' % (
                class_to_name[curcls], *min_overlaps[i, :, j][:3].tolist()))
            result += ('bbox AP:%.4f, %.4f, %.4f\n' % (
                mAPbbox[j, 0, i], mAPbbox[j, 1, i], mAPbbox[j, 2, i]))
            result += ('bev  AP:%.4f, %.4f, %.4f\n' % (
                mAPbev[j, 0, i], mAPbev[j, 1, i], mAPbev[j, 2, i]))
            result += ('3d   AP:%.4f, %.4f, %.4f\n' % (
                mAP3d[j, 0, i], mAP3d[j, 1, i], mAP3d[j, 2, i]))
            if compute_aos:
                result += ('aos  AP:%.2f, %.2f, %.2f\n' % (
                    mAPaos[j, 0, i], mAPaos[j, 1, i], mAPaos[j, 2, i]))
            result += ('%s AP_R40@%.2f, %.2f, %.2f:\n' % (
                class_to_name[curcls], *min_overlaps[i, :, j][:3].tolist()))
            result += ('bbox AP:%.4f, %.4f, %.4f\n' % (
                mAPbbox_R40[j, 0, i], mAPbbox_R40[j, 1, i], mAPbbox_R40[j, 2, i]))
            result += ('bev  AP:%.4f, %.4f, %.4f\n' % (
                mAPbev_R40[j, 0, i], mAPbev_R40[j, 1, i], mAPbev_R40[j, 2, i]))
            result += ('3d   AP:%.4f, %.4f, %.4f\n' % (
                mAP3d_R40[j, 0, i], mAP3d_R40[j, 1, i], mAP3d_R40[j, 2, i]))
            if compute_aos:
                result += ('aos  AP:%.2f, %.2f, %.2f\n' % (
                    mAPaos_R40[j, 0, i], mAPaos_R40[j, 1, i], mAPaos_R40[j, 2, i]))

            if i == 0:
                cls_name = class_to_name[curcls]
                for d, diff in enumerate(['easy', 'moderate', 'hard']):
                    ret_dict['%s_3d/%s' % (cls_name, diff)] = mAP3d[j, d, 0]
                    ret_dict['%s_3d/%s_R40' % (cls_name, diff)] = mAP3d_R40[j, d, 0]
                    ret_dict['%s_bev/%s' % (cls_name, diff)] = mAPbev[j, d, 0]
                    ret_dict['%s_bev/%s_R40' % (cls_name, diff)] = mAPbev_R40[j, d, 0]
                    ret_dict['%s_image/%s' % (cls_name, diff)] = mAPbbox[j, d, 0]
                    ret_dict['%s_image/%s_R40' % (cls_name, diff)] = mAPbbox_R40[j, d, 0]
                    if compute_aos:
                        ret_dict['%s_aos/%s' % (cls_name, diff)] = mAPaos[j, d, 0]
                        ret_dict['%s_aos/%s_R40' % (cls_name, diff)] = mAPaos_R40[j, d, 0]

    return result, ret_dict
