"""Single-scan inference demo (counterpart of ``tools/demo.py``): load a
``.bin`` / ``.npy`` point cloud, or build a seeded synthetic scan, run one
detector on it and print the boxes.

    python -m fv2p_torch.tools.demo                       # MGAF-3DSSD, synthetic scan
    python -m fv2p_torch.tools.demo --cfg_file tools/cfgs/kitti_models/FV2P/fv2p.yaml \\
        --data_path data/kitti/training/velodyne/000032.bin --ckpt CKPT

``--cfg_file`` is read as given, or else under ``tools/``; ``--ckpt`` takes
a checkpoint of the port's train runner (``fv2p_torch.tools.train``), and
without one the model keeps seeded random weights (seed 0). The model runs
in bf16 on the CUDA card, which must be present; ``--device cpu`` runs the
kernels' plain versions on the CPU. The batch is built as
``tools/demo.py`` builds it: ``DataProcessor.forward`` in test mode, then
``pad_to_fixed_shape``, at batch 1; a voxel model gets no host rulebooks
(its sparse tables are built on the card), a point model
``points``/``points_valid``, and a yaml with ``KEEP_RAW_POINTS`` the loaded
points padded to ``MAX_POINTS_PER_SCAN``. ``--vis`` (a BEV rendering) is
not offered: it needs matplotlib, which the port does not import.
"""
import argparse
import time
from pathlib import Path

import numpy as np
import torch

from ..config import REPO_ROOT, EasyDict, cfg_from_list, cfg_from_yaml_file
from ..datasets import dataset_meta_from_cfg
from ..datasets.processor.data_processor import DataProcessor
from ..models import build_network
from ..utils.synthetic import batch_to_torch
from ..weights import init_random_
from .test import load_model_state

VIS_REFUSED = ('--vis is not offered by the port: its BEV rendering needs '
               'matplotlib, which fv2p_torch does not import')


def parse_config(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--cfg_file', type=str,
                        default='cfgs/kitti_models/MGAF-3DSSD/mgaf-3dssd.yaml')
    parser.add_argument('--data_path', type=str, default=None,
                        help='point cloud .bin/.npy file (synthetic if absent)')
    parser.add_argument('--ckpt', type=str, default=None,
                        help="a checkpoint of fv2p_torch.tools.train")
    parser.add_argument('--device', choices=['cuda', 'cpu'], default='cuda',
                        help="cuda: the card, which must be present; cpu: the "
                             "kernels' plain versions")
    parser.add_argument('--vis', type=str, default=None, help=VIS_REFUSED)
    parser.add_argument('--set', dest='set_cfgs', default=None, nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    if args.vis is not None:
        parser.error(VIS_REFUSED)
    cfg_path = Path(args.cfg_file)
    if not cfg_path.exists():
        cfg_path = REPO_ROOT / 'tools' / args.cfg_file
    cfg = EasyDict()
    cfg_from_yaml_file(str(cfg_path), cfg)
    if args.set_cfgs is not None:
        cfg_from_list(args.set_cfgs, cfg)
    return args, cfg


def load_points(args, cfg):
    """The scan of ``--data_path`` (.bin: float32 (N, 4); else .npy), or
    18000 uniform points over the point cloud range with a car-shaped
    cluster of 300 in front, from ``RandomState(0)``."""
    if args.data_path:
        p = Path(args.data_path)
        if p.suffix == '.bin':
            return np.fromfile(str(p), dtype=np.float32).reshape(-1, 4)
        return np.load(str(p))
    rng = np.random.RandomState(0)
    pr = np.array(cfg.DATA_CONFIG.POINT_CLOUD_RANGE, np.float32)
    n = 18000
    pts = np.zeros((n, 4), np.float32)
    pts[:, 0] = rng.uniform(pr[0], pr[3], n)
    pts[:, 1] = rng.uniform(pr[1], pr[4], n)
    pts[:, 2] = rng.uniform(pr[2], pr[5], n)
    pts[:, 3] = rng.rand(n)
    m = 300
    pts[:m, 0] = rng.uniform(9, 13, m)
    pts[:m, 1] = rng.uniform(-0.9, 0.9, m)
    pts[:m, 2] = rng.uniform(-1.6, -0.3, m)
    return pts


def build_batch(points, cfg):
    """The batch of one scan, numpy arrays with a leading batch axis of 1.
    A test-mode processor that draws (point sampling) draws unseeded, as
    JAX's demo does."""
    proc = DataProcessor(cfg.DATA_CONFIG.DATA_PROCESSOR,
                         np.array(cfg.DATA_CONFIG.POINT_CLOUD_RANGE, np.float32),
                         training=False)
    data = proc.forward({'points': points, 'use_lead_xyz': True}, np.random.RandomState())
    data = proc.pad_to_fixed_shape(data)
    if 'voxels' not in data:
        pts = data['points']
        return {'points': pts[None],
                'points_valid': data.get('points_valid', np.ones(pts.shape[0], bool))[None]}
    batch = {k: data[k][None] for k in ('voxels', 'voxel_coords', 'voxel_num_points',
                                        'voxel_valid')}
    if cfg.DATA_CONFIG.get('KEEP_RAW_POINTS', False):
        p_cap = int(cfg.DATA_CONFIG.get('MAX_POINTS_PER_SCAN', 24000))
        n = min(points.shape[0], p_cap)
        pts = np.zeros((p_cap, points.shape[1]), np.float32)
        pv = np.zeros((p_cap,), bool)
        pts[:n] = points[:n]
        pv[:n] = True
        batch['points'] = pts[None]
        batch['points_valid'] = pv[None]
    return batch


def build_model(cfg, device, compute_dtype=torch.bfloat16, ckpt=None):
    """The yaml's detector in eval mode on ``device`` ('cuda' or 'cpu'),
    with seeded weights (seed 0) or those of ``ckpt``."""
    meta = dataset_meta_from_cfg(cfg.DATA_CONFIG, 'test')
    model = build_network(cfg.MODEL, num_class=len(cfg.CLASS_NAMES),
                          class_names=cfg.CLASS_NAMES, dataset_meta=meta,
                          compute_dtype=compute_dtype,
                          device=None if device == 'cuda' else device)
    init_random_(model, seed=0)
    if ckpt:
        load_model_state(model, ckpt)
    return model


def detect(model, batch_np):
    """One forward over ``batch_np``: the first scan's valid boxes, scores
    and labels (numpy), and the forward's milliseconds (the card
    synchronised at both ends)."""
    device = next(model.parameters()).device
    batch = batch_to_torch(batch_np, device)
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = model(batch)
    valid = out['pred_valid'][0]
    dets = {k: out[k][0][valid].float().cpu().numpy() if k != 'pred_labels'
            else out[k][0][valid].cpu().numpy()
            for k in ('pred_boxes', 'pred_scores', 'pred_labels')}
    return dets, (time.perf_counter() - t0) * 1e3


def detection_lines(dets, class_names):
    """The printed lines: the count, then one line a box (and its velocity
    for a 9-column box)."""
    lines = [f'detections: {dets["pred_scores"].shape[0]}']
    for b, s, l in zip(dets['pred_boxes'], dets['pred_scores'], dets['pred_labels']):
        name = class_names[int(l) - 1]
        extra = ' vel [% .2f % .2f]' % tuple(b[7:9]) if b.shape[0] >= 9 else ''
        lines.append(('  %-10s score %.3f  box [% .2f % .2f % .2f | %.2f %.2f %.2f '
                      '| % .2f]' % (name, s, *b[:7])) + extra)
    return lines


def main(argv=None):
    """Run the demo; returns the detections, the batch, the model, the
    host's set-up seconds (arguments to the model on its device) and the
    forward's ms."""
    t0 = time.perf_counter()
    args, cfg = parse_config(argv)
    points = load_points(args, cfg)
    print(f'loaded {points.shape[0]} points')
    batch_np = build_batch(points, cfg)
    model = build_model(cfg, args.device, ckpt=args.ckpt)
    if args.ckpt:
        print(f'restored {args.ckpt}')
    setup_s = time.perf_counter() - t0
    dets, forward_ms = detect(model, batch_np)
    for line in detection_lines(dets, cfg.CLASS_NAMES):
        print(line)
    return {'detections': dets, 'batch': batch_np, 'model': model, 'setup_s': setup_s,
            'forward_ms': forward_ms}


if __name__ == '__main__':
    main()
