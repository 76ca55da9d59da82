"""Native nuScenes detection metrics (the port's own copy of
``fv2p_tpu/datasets/nuscenes/nuscenes_eval_native.py``, plain numpy): the
official ``detection_cvpr_2019`` algorithm (nuscenes-devkit
``nuscenes/eval/detection``) re-implemented so that
``NuScenesDataset.evaluation`` produces real numbers without the devkit or
a full NuScenes database on disk (the reference can only evaluate through
the devkit: ``pcdet/datasets/nuscenes/nuscenes_dataset.py:198-252``).

Algorithm, per the published spec:

- Matching: per class and per center-distance threshold d in {0.5, 1, 2, 4} m,
  predictions are ranked by score across the whole split; each is greedily
  matched to the closest unmatched same-class GT in its frame within d.
- AP: precision interpolated onto a 101-point recall grid; samples below
  min_recall = 0.1 are dropped, precision is reduced by min_precision = 0.1
  and clipped at 0, and the mean is normalized by (1 - 0.1). mAP averages
  over classes and the four thresholds.
- TP metrics, computed on the d = 2 m matching and averaged over the recall
  range [0.1, max_recall] via the same 101-point grid of cumulative means:
  ATE (2D center distance), ASE (1 - IoU of center/yaw-aligned boxes),
  AOE (absolute wrapped yaw difference; period pi for barriers), and AVE
  (L2 xy-velocity difference) when both sides carry 9-dim boxes.
- NDS = (5 * mAP + sum(max(0, 1 - mTP))) / (5 + #TP-metrics). Deviation from
  the devkit: AAE (attribute error) is omitted — this framework has no
  attribute head — so the normalizer counts only the TP metrics actually
  computed instead of a hard-coded 5.
"""
import numpy as np

# devkit class-specific evaluation ranges (detection_cvpr_2019)
DEFAULT_CLASS_RANGE = {
    'car': 50, 'truck': 50, 'bus': 50, 'trailer': 50,
    'construction_vehicle': 50, 'pedestrian': 40, 'motorcycle': 40,
    'bicycle': 40, 'traffic_cone': 30, 'barrier': 30,
}
DIST_THRESHS = (0.5, 1.0, 2.0, 4.0)
TP_DIST = 2.0
MIN_RECALL = 0.1
MIN_PRECISION = 0.1
_NUM_RECALL_PTS = 101


def _wrapped_yaw_diff(a, b, period=2 * np.pi):
    d = np.abs(a - b) % period
    return np.minimum(d, period - d)


def _aligned_size_iou(dims_a, dims_b):
    """IoU of two boxes after aligning center and yaw: min-dims volume over
    union (devkit ``scale_iou``)."""
    inter = np.prod(np.minimum(dims_a, dims_b), axis=-1)
    union = np.prod(dims_a, axis=-1) + np.prod(dims_b, axis=-1) - inter
    return inter / np.maximum(union, 1e-9)


def _collect(det_annos, gt_infos, class_name, class_range):
    """Flatten one class: ranked predictions and per-frame GT tables."""
    preds = []  # (score, frame, box)
    gts = []    # per-frame list of boxes
    max_r = class_range.get(class_name, 50)
    for f, (det, info) in enumerate(zip(det_annos, gt_infos)):
        names = np.asarray(info['gt_names'])
        boxes = np.asarray(info['gt_boxes'], np.float64)
        m = (names == class_name)
        if m.any():
            b = boxes[m]
            m2 = np.linalg.norm(b[:, :2], axis=1) <= max_r
            gts.append(b[m2])
        else:
            gts.append(np.zeros((0, boxes.shape[1] if boxes.ndim == 2 else 7)))
        dnames = np.asarray(det['name'])
        dboxes = np.asarray(det['boxes_lidar'], np.float64)
        dboxes = dboxes.reshape(len(dnames), dboxes.shape[-1]
                                if dboxes.ndim == 2 else 7)
        dscores = np.asarray(det['score'], np.float64)
        dm = (dnames == class_name)
        for b, s in zip(dboxes[dm], dscores[dm]):
            if np.linalg.norm(b[:2]) <= max_r:
                preds.append((float(s), f, b))
    preds.sort(key=lambda t: -t[0])
    return preds, gts


def _match_class(preds, gts, dist_th, yaw_period):
    """Greedy devkit matching. Returns per-prediction tp flags and, for TPs,
    the error terms (trans, scale, orient, vel), plus total GT count."""
    npos = sum(len(g) for g in gts)
    taken = [np.zeros(len(g), bool) for g in gts]
    tp, fp = [], []
    errs = []  # rows: (ate, ase, aoe, ave_or_nan)
    for score, f, box in preds:
        g = gts[f]
        best, best_d = -1, float(dist_th)
        for gi in range(len(g)):
            if taken[f][gi]:
                continue
            d = float(np.linalg.norm(box[:2] - g[gi, :2]))
            if d < best_d:
                best, best_d = gi, d
        if best >= 0:
            taken[f][best] = True
            tp.append(1.0)
            fp.append(0.0)
            gbox = g[best]
            ate = best_d
            ase = 1.0 - float(_aligned_size_iou(box[3:6], gbox[3:6]))
            aoe = float(_wrapped_yaw_diff(box[6], gbox[6], yaw_period))
            ave = (float(np.linalg.norm(box[7:9] - gbox[7:9]))
                   if len(box) >= 9 and len(gbox) >= 9 else np.nan)
            errs.append((ate, ase, aoe, ave))
        else:
            tp.append(0.0)
            fp.append(1.0)
            errs.append((np.nan,) * 4)
    return np.array(tp), np.array(fp), np.array(errs).reshape(-1, 4), npos


def _calc_ap(tp, fp, npos):
    """Devkit CalcAP: 101-pt interpolation, clipped/normalized by 0.1."""
    if npos == 0 or len(tp) == 0 or tp.sum() == 0:
        return 0.0
    ctp, cfp = np.cumsum(tp), np.cumsum(fp)
    rec = ctp / npos
    prec = ctp / np.maximum(ctp + cfp, 1e-9)
    grid = np.linspace(0, 1, _NUM_RECALL_PTS)
    prec_i = np.interp(grid, rec, prec, right=0)
    first = round(100 * MIN_RECALL) + 1
    p = prec_i[first:] - MIN_PRECISION
    p[p < 0] = 0
    return float(p.mean() / (1 - MIN_PRECISION))


def _calc_tp_errors(tp, errs, npos):
    """Cumulative-mean TP errors averaged over the devkit recall range.
    Returns dict of trans/scale/orient/vel errors (vel NaN-dropped)."""
    names = ('trans_err', 'scale_err', 'orient_err', 'vel_err')
    out = {}
    sel = tp > 0
    if npos == 0 or not sel.any():
        return {n: 1.0 for n in names[:3]} | {'vel_err': np.nan}
    rec = np.cumsum(tp) / npos
    grid = np.linspace(0, 1, _NUM_RECALL_PTS)
    first = round(100 * MIN_RECALL) + 1
    last = int(round(100 * rec[sel].max())) + 1
    for k, name in enumerate(names):
        e = errs[:, k]
        if name == 'vel_err' and np.isnan(e[sel]).all():
            out[name] = np.nan
            continue
        # cumulative mean over TPs, carried forward across FP positions
        vals = np.where(sel, np.nan_to_num(e), 0.0)
        cmean = np.cumsum(vals) / np.maximum(np.cumsum(sel), 1)
        ci = np.interp(grid, rec, cmean, right=cmean[-1])
        if last <= first:
            out[name] = 1.0  # devkit: max recall below min_recall
        else:
            out[name] = float(ci[first:last].mean())
    return out


def nuscenes_detection_eval(det_annos, gt_infos, class_names,
                            class_range=None):
    """Run the native eval. ``det_annos``: prediction dicts with ``name``,
    ``score``, ``boxes_lidar``. ``gt_infos``: info dicts with ``gt_names``,
    ``gt_boxes``. Returns (result_str, result_dict) in the same key style as
    ``nuscenes_utils.format_nuscene_results``."""
    assert len(det_annos) == len(gt_infos), \
        '%d vs %d' % (len(det_annos), len(gt_infos))
    class_range = class_range or DEFAULT_CLASS_RANGE
    ap_per_class = {}
    tp_per_class = {}
    scored = []  # classes with at least one in-range GT in the split
    for cls in class_names:
        yaw_period = np.pi if cls == 'barrier' else 2 * np.pi
        preds, gts = _collect(det_annos, gt_infos, cls, class_range)
        aps = []
        for dist_th in DIST_THRESHS:
            tp, fp, errs, npos = _match_class(preds, gts, dist_th, yaw_period)
            aps.append(_calc_ap(tp, fp, npos))
            if dist_th == TP_DIST:
                tp_per_class[cls] = _calc_tp_errors(tp, errs, npos)
        ap_per_class[cls] = aps
        if npos > 0:
            scored.append(cls)

    # classes absent from the split contribute nothing (devkit nan handling)
    mean_ap = float(np.mean([a for c in scored for a in ap_per_class[c]])) \
        if scored else 0.0
    tp_names = ('trans_err', 'scale_err', 'orient_err', 'vel_err')
    mean_tp = {}
    for n in tp_names:
        vals = [tp_per_class[c][n] for c in scored
                if not np.isnan(tp_per_class[c][n])]
        if vals:
            mean_tp[n] = float(np.mean(vals))
    nds_terms = [max(0.0, 1.0 - v) for v in mean_tp.values()]
    nds = (5 * mean_ap + sum(nds_terms)) / (5 + len(nds_terms))

    result_dict = {'mAP': mean_ap, 'NDS': nds}
    lines = ['----- Native nuScenes detection metrics -----']
    for cls in class_names:
        for th, ap in zip(DIST_THRESHS, ap_per_class[cls]):
            result_dict['%s_AP_dist_%s' % (cls, th)] = ap
        lines.append('%s AP@0.5/1/2/4m: %s' % (
            cls, '/'.join('%.4f' % a for a in ap_per_class[cls])))
        for n in tp_names:
            v = tp_per_class[cls][n]
            if not np.isnan(v):
                result_dict['%s_%s' % (cls, n)] = v
        lines.append('%s ATE/ASE/AOE: %.4f/%.4f/%.4f' % (
            cls, tp_per_class[cls]['trans_err'],
            tp_per_class[cls]['scale_err'], tp_per_class[cls]['orient_err']))
    short = {'trans_err': 'mATE', 'scale_err': 'mASE',
             'orient_err': 'mAOE', 'vel_err': 'mAVE'}
    for n, v in mean_tp.items():
        result_dict[short[n]] = v
    lines.append('mAP: %.4f' % mean_ap)
    lines.append('NDS: %.4f' % nds)
    return '\n'.join(lines) + '\n', result_dict
