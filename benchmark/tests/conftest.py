"""CPU tests of the benchmark. ``tiny_repo`` lays out a checkout of its own
(``BENCHMARK.json`` and ``benchmark/``) whose cells run the tiny FV2P and
MGAF-3DSSD configurations of the port's CPU tests through the harness on the
CPU: the same files, found by name, as the real cells'."""
import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
for p in (str(BENCH), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_TRAFFIC = {
    'tiny_infer': {'mode': 'infer', 'batch': 2, 'voxel_cap': 256, 'fill': 128,
                   'level_caps': 'derived', 'raw_points': 256, 'sample_points': True,
                   'pad_points_to': 320, 'max_objs': 50, 'pool': 2,
                   'checked_batches': 1},
    'tiny_train': {'mode': 'train', 'batch': 'yaml', 'voxel_cap': 256, 'fill': 128,
                   'level_caps': 'yaml_train', 'raw_points': 320, 'sample_points': False,
                   'pad_points_to': 320, 'max_objs': 50, 'pool': 4,
                   'total_steps': 1000, 'checked_steps': 3},
}
TINY_CELLS = {'tiny_fv2p_infer': ('tiny_fv2p', 'tiny_infer'),
              'tiny_mgaf_infer': ('tiny_mgaf', 'tiny_infer'),
              'tiny_fv2p_train': ('tiny_fv2p', 'tiny_train'),
              'tiny_mgaf_train': ('tiny_mgaf', 'tiny_train')}
# every number compared, at limits that sound CPU runs of the tiny cells
# (f32 on both sides) keep far under and the planted faults cross
TINY_INFER_LIMITS = {'limits': {'score_gap_p90': 1e-3, 'box_gap_med': 1e-3,
                                'unpaired_scans': 0.0}}
TINY_TRAIN_LIMITS = {
    'tiny_fv2p': {'limits': {'steady_loss_gap': 1e-3, 'grad_gap_worst': 0.1,
                             'change_gap_med': 0.1},
                  'steady_terms': ['rpn_loss_cls', 'rpn_loss_loc', 'rpn_loss_dir',
                                   'point_loss_cls']},
    'tiny_mgaf': {'limits': {'steady_loss_gap': 1e-3, 'grad_gap_worst': 0.1,
                             'change_gap_med': 0.1},
                  'steady_terms': ['rpn_hm_loss', 'rpn_offset_loss', 'rpn_height_loss',
                                   'rpn_dim_loss', 'rpn_rot_loss', 'rpn_segm_loss',
                                   'rpn_corner_loss']}}


@pytest.fixture(scope='session')
def tiny_repo(tmp_path_factory):
    root = tmp_path_factory.mktemp('checkout')
    bench = json.loads((REPO / 'BENCHMARK.json').read_text())
    configs = json.loads((BENCH / 'tests' / 'tiny_configs.json').read_text())
    for sub in ('configs', 'traffic', 'limits'):
        (root / 'benchmark' / sub).mkdir(parents=True)
    for sub in ('metrics', 'kernels'):
        shutil.copytree(BENCH / sub, root / 'benchmark' / sub)
    for name, cfg in configs.items():
        (root / 'benchmark' / 'configs' / f'{name}.json').write_text(json.dumps(cfg))
    for name, traffic in TINY_TRAFFIC.items():
        (root / 'benchmark' / 'traffic' / f'{name}.json').write_text(json.dumps(traffic))
    for cell, (config, traffic) in TINY_CELLS.items():
        limits = TINY_INFER_LIMITS if TINY_TRAFFIC[traffic]['mode'] == 'infer' \
            else TINY_TRAIN_LIMITS[config]
        (root / 'benchmark' / 'limits' / f'{cell}.json').write_text(json.dumps(limits))
    bench['configs'] = [{'name': n, 'source': 'tests/test_torch_*.py tiny configuration',
                         'file': f'benchmark/configs/{n}.json', 'reduced': [], 'why': 'CPU test'}
                        for n in configs]
    bench['workloads'] = [{'name': c, 'config': cfg, 'traffic': t, 'chips': 1, 'why': 'CPU test'}
                          for c, (cfg, t) in TINY_CELLS.items()]
    rename = {'fv2p_kitti_infer': 'tiny_fv2p_infer', 'mgaf_kitti_infer': 'tiny_mgaf_infer',
              'fv2p_kitti_train': 'tiny_fv2p_train', 'mgaf_kitti_train': 'tiny_mgaf_train'}
    for m in bench['end_to_end'] + bench['per_layer']:
        if 'workloads' in m:
            m['workloads'] = [rename[w] for w in m['workloads']]
    (root / 'BENCHMARK.json').write_text(json.dumps(bench))
    return root


@pytest.fixture(scope='session', autouse=True)
def few_threads():
    import torch
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)
