"""Evaluation loop (counterpart of ``tools/eval_utils/eval_utils.py``): batch
loop -> recall counts at RECALL_THRESH_LIST -> KITTI-format prediction dicts
-> ``dataset.evaluation``.

The model returns fixed-shape padded predictions (a ``pred_valid`` mask in
place of ragged lists). The recall counter's 3D IoUs come from kernel B1
(``utils/iou3d.boxes_iou3d``) on the model's device, one call per scan for
the final boxes and one for the RoIs. Timing: the host clock around each
forward, ended by the copy of its predictions to the host.

Data parallel (``merge_ranks``): each rank runs its own scans; rank 0
gathers every rank's det_annos back into dataset order (the loader's
``rank::world`` split, undone by ``parallel.interleave``), sums the recall
counters and the rows the device rulebooks dropped, scores and writes
``result.json``, as JAX merges its processes' results.
"""
import json
import time

import numpy as np
import torch

from .. import parallel
from ..datasets import batch_to_numpy, prefetch
from ..ops.sparse import host_rulebook
from ..utils import iou3d, misc
from ..utils.synthetic import batch_to_torch

PRED_KEYS = ('pred_boxes', 'pred_scores', 'pred_labels', 'pred_valid')


def make_recall_fn(thresh_list):
    """The recall counter: for each gt box, did any valid final box (and any
    RoI) overlap it in 3D above each threshold? Padded gt rows are all zero
    and are not counted. Returns a function of (pred_boxes (B, N, 7),
    pred_valid (B, N), gt_boxes (B, M, 8), roi_boxes (B, R, 7) or None) ->
    (final counts, RoI counts, number of gt), numpy, summed over the
    batch."""

    def max_iou_per_gt(cand, cand_valid, gt, gt_valid):
        iou = iou3d.boxes_iou3d(gt[:, :7].contiguous(), cand[:, :7].contiguous())
        iou = torch.where(cand_valid[None, :], iou, 0.0)
        return torch.where(gt_valid, iou.amax(dim=1), 0.0)

    def recall_counts(pred_boxes, pred_valid, gt_boxes, roi_boxes=None):
        thresh = torch.tensor(thresh_list, dtype=torch.float32, device=gt_boxes.device)
        counts, counts_r, num_gt = [], [], []
        for b in range(gt_boxes.shape[0]):
            gb = gt_boxes[b].float()
            gv = gb[:, :7].abs().sum(-1) > 0
            best = max_iou_per_gt(pred_boxes[b].float(), pred_valid[b], gb, gv)
            counts.append((best[None, :] > thresh[:, None]).sum(1))
            if roi_boxes is None:
                counts_r.append(torch.zeros_like(counts[-1]))
            else:
                rb = roi_boxes[b].float()
                best_r = max_iou_per_gt(rb, torch.ones_like(rb[:, 0], dtype=torch.bool),
                                        gb, gv)
                counts_r.append((best_r[None, :] > thresh[:, None]).sum(1))
            num_gt.append(gv.sum())
        tot = torch.cat([torch.stack(counts).sum(0), torch.stack(counts_r).sum(0),
                         torch.stack(num_gt).sum()[None]]).cpu().numpy()
        n = len(thresh_list)
        return tot[:n], tot[n:2 * n], int(tot[-1])

    return recall_counts


def pad_batch_to_size(batch_np, batch_size):
    """Pad a ragged final batch to the batch size by repeating the last
    sample (gt_boxes pad with zeros so that the recall counter never sees a
    gt twice). Returns (padded batch, number of real samples)."""
    some = next(v for v in batch_np.values() if isinstance(v, np.ndarray))
    n_real = len(some)
    if n_real == batch_size:
        return batch_np, n_real
    pad = batch_size - n_real

    def pad_arr(v, zeros=False):
        tail = np.zeros_like(v[-1:]) if zeros else v[-1:]
        return np.concatenate([v] + [tail] * pad, axis=0)

    out = {}
    for k, v in batch_np.items():
        if isinstance(v, np.ndarray):
            out[k] = pad_arr(v, zeros=(k == 'gt_boxes'))
        elif isinstance(v, dict):
            out[k] = {kk: pad_arr(vv) for kk, vv in v.items()}
        elif isinstance(v, (list, tuple)):
            out[k] = list(v) + [v[-1]] * pad
        else:
            out[k] = v
    return out, n_real


def eval_one_epoch(cfg, model, loader, test_set, eval_dir, logger, batch_size,
                   save_to_file=False, merge_ranks=False):
    """Evaluate ``model`` (eval mode, on its device) over ``loader``; writes
    ``result.json`` into ``eval_dir``. Returns (the dict, the det_annos):
    recall at each threshold, the dataset's AP dict, ``sec_per_example``
    (host seconds of the forward per scan, the first batch apart, which pays
    the kernels' first launches), the loader's wait per batch and the
    forward's median in ms. With ``merge_ranks`` every rank of the process
    group calls it on its own shard; rank 0 returns the merged result (its
    own timings) and the merged det_annos, the other ranks ({}, their own
    det_annos). A batch whose device rulebooks dropped rows raises after
    the loop, on every rank."""
    pp_cfg = cfg.MODEL.POST_PROCESSING
    thresh_list = list(pp_cfg.get('RECALL_THRESH_LIST', [0.3, 0.5, 0.7]))
    recall_fn = make_recall_fn(tuple(thresh_list))
    device = next(model.parameters()).device
    model.eval()

    def convert(batch):
        batch_np = batch_to_numpy(batch)
        padded, n_real = pad_batch_to_size(batch_np, batch_size)
        return padded, n_real, batch_to_torch(batch if padded is batch_np else padded,
                                               device)

    det_annos = []
    recall = {('recall_rcnn_%s' % str(t)): 0 for t in thresh_list}
    recall.update({('recall_roi_%s' % str(t)): 0 for t in thresh_list})
    total_gt = 0
    dropped = None                # device rulebooks: rows dropped per level
    dropped_batches = []
    forward_s, waits = [], []
    n_first = 0
    for i, (_, (batch_np, n_real, batch), wait) in enumerate(prefetch(loader, convert)):
        waits.append(wait)
        t0 = time.perf_counter()
        with torch.no_grad():
            out = model(dict(batch))
        pred = {k: (out[k].float() if out[k].is_floating_point() else out[k]).cpu().numpy()
                for k in PRED_KEYS + ('rulebook_overflow',) if k in out}
        forward_s.append(time.perf_counter() - t0)
        if 'rulebook_overflow' in pred:
            batch_drop = pred.pop('rulebook_overflow')
            dropped = batch_drop if dropped is None else dropped + batch_drop
            if batch_drop.any():
                dropped_batches.append(i)
        if i == 0:
            n_first = n_real

        if 'gt_boxes' in batch:
            counts, counts_r, num_gt = recall_fn(
                out['pred_boxes'], out['pred_valid'], batch['gt_boxes'], out.get('rois'))
            total_gt += num_gt
            for j, t in enumerate(thresh_list):
                recall['recall_rcnn_%s' % str(t)] += int(counts[j])
                recall['recall_roi_%s' % str(t)] += int(counts_r[j])

        annos = test_set.generate_prediction_dicts(
            batch_np, pred, cfg.CLASS_NAMES,
            output_path=eval_dir if save_to_file else None)
        det_annos += annos[:n_real]
        if i % 50 == 0:
            logger.info(f'eval batch {i}/{len(loader)}')

    n_scans = len(det_annos)
    if dropped is not None:
        if merge_ranks:
            dropped = parallel.sum_over_ranks(torch.from_numpy(dropped)).numpy()
        if dropped.any():
            raise RuntimeError(
                'device rulebooks: level capacities dropped %s sparse rows (x_conv2, '
                'x_conv3, x_conv4, out) over the eval set (batches %s of rank %d)'
                % (dropped.tolist(), dropped_batches, parallel.rank()))
    if merge_ranks:
        det_annos = parallel.interleave(misc.all_gather(det_annos))
        merged = misc.reduce_dict({**recall, 'total_gt': total_gt}, average=False)
        total_gt = int(merged.pop('total_gt'))
        recall = {k: int(v) for k, v in merged.items()}
        logger.info(f'merged {len(det_annos)} det_annos of {parallel.world_size()} ranks')
        if parallel.rank() != 0:
            return {}, det_annos
    first_batch_sec = forward_s[0] / max(n_first, 1)
    if n_scans > n_first:
        sec_per_example = sum(forward_s[1:]) / (n_scans - n_first)
    else:  # one batch: the first-launch number is all there is
        sec_per_example = first_batch_sec
    logger.info('sec_per_example: %.4f (first batch: %.4f)'
                % (sec_per_example, first_batch_sec))

    of = host_rulebook.get_overflow_stats()
    if of['samples_over']:
        logger.warning('rulebook capacity overflow: %s' % of)
    elif of['samples']:
        logger.info('rulebook overflow check: clean over %d samples, '
                    'max_active=%s' % (of['samples'], of['max_active']))
    if dropped is not None:
        logger.info('device rulebook overflow check: clean over %d batches '
                    '(rows dropped at x_conv2, x_conv3, x_conv4, out: %s)'
                    % (len(forward_s), dropped.tolist()))

    ret_dict = {}
    if total_gt > 0:
        for t in thresh_list:
            r_rcnn = recall['recall_rcnn_%s' % str(t)] / total_gt
            r_roi = recall['recall_roi_%s' % str(t)] / total_gt
            logger.info('recall_rcnn_%s: %.4f  recall_roi_%s: %.4f'
                        % (t, r_rcnn, t, r_roi))
            ret_dict['recall/rcnn_%s' % str(t)] = r_rcnn
            ret_dict['recall/roi_%s' % str(t)] = r_roi

    result_str, result_dict = test_set.evaluation(
        det_annos, cfg.CLASS_NAMES, device=device,
        eval_metric=pp_cfg.get('EVAL_METRIC', 'kitti'), output_path=str(eval_dir))
    logger.info(result_str)
    ret_dict.update({k: float(v) for k, v in result_dict.items()})
    ret_dict['sec_per_example'] = sec_per_example
    ret_dict['sec_per_example_first_batch'] = first_batch_sec
    ret_dict['loader_wait_s_per_batch'] = float(np.mean(waits))
    ret_dict['forward_ms_median'] = float(np.median(forward_s) * 1e3)
    if dropped is not None:
        ret_dict['device_rulebook_dropped'] = float(dropped.sum())

    with open(eval_dir / 'result.json', 'w') as f:
        json.dump(ret_dict, f, indent=2)
    return ret_dict, det_annos
