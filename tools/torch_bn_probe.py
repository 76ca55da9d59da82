#!/usr/bin/env python3
"""Probe trained checkpoints of the PyTorch port: how far the eval-mode
BatchNorm statistics are from what the model sees at eval time.

    python3 tools/torch_bn_probe.py --cfg_file tools/cfgs/nuscenes_models/cbgs_second_multihead_overfit.yaml \\
        CKPT [CKPT ...]

For each checkpoint, ``eval_one_epoch`` over the yaml's test split twice
(bf16, one CUDA card; ``--device cpu --dtype float32`` runs it on the CPU):
once as the model runs (every BatchNorm on its running statistics), once
with every BatchNorm on the statistics of the batch at hand (a diagnostic,
not a mode of the model; the running statistics are restored after). Then,
for the first test batch as the model runs, each BatchNorm's input
variance over its running variance (the largest, the median and the
smallest of the per-layer medians over channels). One JSON line per
checkpoint: the dataset's headline metrics of both passes and the ratios.
"""
import argparse
import json
import logging
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

HEADLINE = ('mAP', 'NDS', 'recall/rcnn_0.3', 'Car_3d/moderate_R40')


def batchnorms(model):
    from fv2p_torch.models.layers import BatchNorm
    from fv2p_torch.ops.sparse.conv import MaskedBatchNorm
    return {n: m for n, m in model.named_modules()
            if isinstance(m, (BatchNorm, MaskedBatchNorm))}


def bn_on_batch_stats(model, args):
    for bn in batchnorms(model).values():
        bn.train()


def variance_ratios(model, batch):
    """Per BatchNorm: the median over channels of the eval-time input
    variance over the running variance, for one forward over `batch`."""
    ratios = {}

    def hook(name):
        def fn(module, args):
            x = args[0].float()
            rows = x[args[1]] if len(args) > 1 else \
                x.movedim(module.axis, -1).reshape(-1, x.shape[module.axis])
            ratios[name] = float((rows.var(0) / module.running_var).median())
        return fn
    handles = [m.register_forward_pre_hook(hook(n)) for n, m in batchnorms(model).items()]
    try:
        with torch.no_grad():
            model(dict(batch))
    finally:
        for h in handles:
            h.remove()
    return ratios


def main():
    from fv2p_torch.datasets import build_dataloader
    from fv2p_torch.tools import test as test_runner
    from fv2p_torch.tools.eval_utils import eval_one_epoch
    from fv2p_torch.utils.synthetic import batch_to_torch
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    test_runner.add_common_args(parser)
    parser.add_argument('ckpts', nargs='+')
    args = parser.parse_args()
    cfg = test_runner.load_config(args)
    batch_size = args.batch_size or cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU
    logger = logging.getLogger('torch_bn_probe')
    test_set = test_runner.make_dataset(cfg, training=False, logger=logger,
                                        rulebooks=args.rulebooks)
    loader = build_dataloader(test_set, batch_size, 0, training=False)
    model = test_runner.make_model(cfg, args, 'test')
    out_dir = test_runner.output_dir_of(cfg, args) / 'bn_probe'
    out_dir.mkdir(parents=True, exist_ok=True)
    device = next(model.parameters()).device
    first = batch_to_torch(next(iter(loader)), device)
    for path in args.ckpts:
        test_runner.load_model_state(model, path)
        saved = {k: v.clone() for k, v in model.state_dict().items()}
        record = {'ckpt': str(path)}
        for label, batch_stats in (('running_stats', False), ('batch_stats', True)):
            # eval_one_epoch puts the model in eval mode; a pre-hook of each
            # forward then puts the BatchNorms back on batch statistics
            hook = model.register_forward_pre_hook(bn_on_batch_stats) if batch_stats else None
            ret, _ = eval_one_epoch(cfg, model, loader, test_set, out_dir, logger, batch_size)
            if hook is not None:
                hook.remove()
            model.load_state_dict(saved)
            record[label] = {k: ret[k] for k in HEADLINE if k in ret}
        model.eval()
        r = np.array(list(variance_ratios(model, first).values()))
        record['eval_var_over_running_var'] = {
            'max': float(r.max()), 'median': float(np.median(r)), 'min': float(r.min()),
            'layers': int(r.size)}
        print(json.dumps(record), flush=True)


if __name__ == '__main__':
    main()
