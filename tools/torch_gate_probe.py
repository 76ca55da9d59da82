#!/usr/bin/env python3
"""Probe trained FV2P checkpoints of the PyTorch port on the KITTI val scans:
what the RCNN stage does at eval time.

    python3 tools/torch_gate_probe.py --cfg_file tools/cfgs/kitti_models/FV2P/fv2p_overfit.yaml \\
        CKPT [CKPT ...]

For each checkpoint, twice over the val set (batch 4, bf16, one CUDA card;
``--device cpu --dtype float32`` runs it on the CPU):
once as the model runs (BatchNorms on their running statistics), once with
the RoI head's BatchNorms on the statistics of the batch at hand (a
diagnostic, not a mode of the model). Each pass prints the valid final
detections, recall at 0.3 / 0.7, Car 3D AP_R40 (easy / moderate / hard),
the quantiles of the RCNN foreground score over the valid RoIs and the
non-finite values among the RCNN outputs. Then, for the first val batch,
each BatchNorm's input variance at eval time over its running variance.
One JSON line per checkpoint.
"""
import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def rcnn_batchnorms(model):
    from fv2p_torch.models.layers import BatchNorm
    return {n: m for n, m in model.roi_head.named_modules() if isinstance(m, BatchNorm)}


def one_pass(model, batches, test_set, cfg, recall_fn, batch_stats_bn, device):
    """One pass over the val batches; with ``batch_stats_bn`` the RoI
    head's BatchNorms normalise by the batch and the running statistics are
    restored afterwards."""
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    model.eval()
    if batch_stats_bn:
        for m in rcnn_batchnorms(model).values():
            m.train()
    from fv2p_torch.utils.synthetic import batch_to_torch
    annos, valid_dets, scores, nonfinite = [], 0, [], 0
    counts = np.zeros(3)
    counts_roi = np.zeros(3)
    total_gt = 0
    for batch_np, n_real in batches:
        batch = batch_to_torch(batch_np, device)
        with torch.no_grad():
            out = model(dict(batch))
        valid = out['roi_valid'][:n_real]
        cls = torch.sigmoid(out['batch_cls_preds'][:n_real].float())[..., 0]
        scores.append(cls[valid].cpu())
        for key in ('batch_cls_preds', 'batch_box_preds', 'batch_iouscore_preds'):
            nonfinite += int((~torch.isfinite(out[key][:n_real].float())).sum())
        valid_dets += int(out['pred_valid'][:n_real].sum())
        c, cr, n = recall_fn(out['pred_boxes'], out['pred_valid'], batch['gt_boxes'],
                             out.get('rois'))
        counts += c
        counts_roi += cr
        total_gt += n
        pred = {k: (out[k].float() if out[k].is_floating_point() else out[k]).cpu().numpy()
                for k in ('pred_boxes', 'pred_scores', 'pred_labels', 'pred_valid')}
        annos += test_set.generate_prediction_dicts(batch_np, pred, cfg.CLASS_NAMES)[:n_real]
    _, ap = test_set.evaluation(annos, cfg.CLASS_NAMES, device=device)
    s = torch.cat(scores)
    q = torch.quantile(s, torch.tensor([0.5, 0.9, 0.99])).tolist() + [float(s.max())]
    model.load_state_dict(saved)
    model.eval()
    return {'valid_detections': valid_dets, 'recall_rcnn_0.3': counts[0] / total_gt,
            'recall_rcnn_0.7': counts[2] / total_gt, 'recall_roi_0.3': counts_roi[0] / total_gt,
            'car_3d_r40': [ap[f'Car_3d/{d}_R40'] for d in ('easy', 'moderate', 'hard')],
            'fg_score_q50_q90_q99_max': q, 'rcnn_nonfinite': nonfinite}


def bn_variance_ratios(model, batch_np, device):
    """Per BatchNorm of the model: the variance of its input at eval time
    (one val batch; the valid voxel rows of a sparse level, the valid RoIs
    of the RoI head, every row of a dense map) over its running variance,
    the mean over channels. The first call of a module counts (the RoI
    head's first pass)."""
    from fv2p_torch.models.layers import BatchNorm
    from fv2p_torch.ops.sparse.conv import MaskedBatchNorm
    from fv2p_torch.utils.synthetic import batch_to_torch
    seen = {}

    def hook(name):
        def fn(mod, a, o):
            if name in seen:
                return
            x = a[0].detach().float()
            if isinstance(mod, MaskedBatchNorm):
                seen[name] = x[a[1]]
            elif mod.axis % x.dim() != x.dim() - 1:
                seen[name] = x.movedim(mod.axis, -1).reshape(-1, x.shape[mod.axis])
            else:
                seen[name] = x
        return fn
    mods = {n: m for n, m in model.named_modules() if isinstance(m, (BatchNorm, MaskedBatchNorm))}
    hooks = [m.register_forward_hook(hook(n)) for n, m in mods.items()]
    model.eval()
    with torch.no_grad():
        out = model(dict(batch_to_torch(batch_np, device)))
    for h in hooks:
        h.remove()
    valid = out['roi_valid'].reshape(-1)
    ratios = {}
    for name, m in mods.items():
        x = seen[name]
        c = x.shape[-1]
        if name.startswith('roi_head') and x.shape[0] == valid.shape[0]:
            x = x.reshape(valid.shape[0], -1, c)[valid]
        x = x.reshape(-1, c)
        ratios[name] = float((x.var(0, unbiased=False) / m.running_var.clamp(min=1e-12)).mean())
    return ratios


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--cfg_file', required=True)
    parser.add_argument('--device', choices=['cuda', 'cpu'], default='cuda')
    parser.add_argument('--dtype', choices=['bfloat16', 'float32'], default='bfloat16')
    parser.add_argument('ckpts', nargs='+')
    args = parser.parse_args()
    if args.device == 'cuda' and not torch.cuda.is_available():
        sys.exit('torch_gate_probe.py needs a CUDA card (or --device cpu)')
    from fv2p_torch.tools import eval_utils
    from fv2p_torch.tools import test as test_runner
    targs, cfg = test_runner.parse_config(['--cfg_file', args.cfg_file, '--device', args.device,
                                           '--dtype', args.dtype])
    test_set = test_runner.make_dataset(cfg, training=False, logger=None)
    batches = []
    for i in range(0, len(test_set), 4):
        b = test_set.collate_batch([test_set[j] for j in range(i, min(i + 4, len(test_set)))])
        batches.append(eval_utils.pad_batch_to_size(b, 4))
    recall_fn = eval_utils.make_recall_fn((0.3, 0.5, 0.7))
    model = test_runner.make_model(cfg, targs, 'test')
    for path in args.ckpts:
        epoch = test_runner.load_model_state(model, path)['epoch']
        rec = {'epoch': epoch,
               'running_stats': one_pass(model, batches, test_set, cfg, recall_fn, False,
                                         args.device),
               'rcnn_batch_stats': one_pass(model, batches, test_set, cfg, recall_fn, True,
                                            args.device),
               'bn_var_ratio': bn_variance_ratios(model, batches[0][0], args.device)}
        print(json.dumps(rec), flush=True)


if __name__ == '__main__':
    main()
