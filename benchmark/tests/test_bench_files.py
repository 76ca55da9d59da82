"""The benchmark is data: each cell finds its configuration, traffic, limits
and metric readers by name, and a new cell or metric needs only new files
and entries."""
import inspect
import json
import re
import shutil
import subprocess
import sys

import pytest

from conftest import BENCH, REPO
from fvbench.cell import Cell, dataset_meta, kernel_of, load_reader

BENCHMARK = json.loads((REPO / 'BENCHMARK.json').read_text())
CELLS = [w['name'] for w in BENCHMARK['workloads']]
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$')


@pytest.mark.parametrize('workload', CELLS)
def test_cell_finds_its_files_by_name(workload):
    cell = Cell(workload)
    entry = next(c for c in BENCHMARK['configs'] if c['name'] == cell.entry['config'])
    assert cell.config['name'] == entry['name']
    assert cell.config['reduced'] == entry['reduced']
    assert cell.mode in ('infer', 'train')
    assert set(cell.limits['limits'])
    assert {m['name'] for m in cell.end_to_end} >= {'setup_s'}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    meta = dataset_meta(cell.cfg, cell.traffic['voxel_cap'])
    assert meta['grid_size'] == (1408, 1600, 40)


def test_contract_shape():
    assert set(BENCHMARK) == {'command', 'paths', 'run_seconds', 'configs', 'workloads',
                              'end_to_end', 'per_layer'}
    assert 1 <= BENCHMARK['run_seconds'] <= 51
    names = [x['name'] for k in ('configs', 'workloads', 'end_to_end', 'per_layer')
             for x in BENCHMARK[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for w in BENCHMARK['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert w['chips'] == 1 and 1 <= len(w['why']) <= 200
    for c in BENCHMARK['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert c['file'].startswith('benchmark/') and len(c['why']) <= 200
    for m in BENCHMARK['end_to_end']:
        assert 0.01 <= m['bound'] <= 0.25 and m['source'] in ('host_clock', 'device_trace')
    assert any(m['name'] == 'setup_s' for m in BENCHMARK['end_to_end'])
    assert len(json.dumps(BENCHMARK)) < 64 * 1024


def test_each_per_layer_metric_moves_one_metric_its_cells_report():
    e2e = {m['name']: m for m in BENCHMARK['end_to_end']}
    perf = (REPO / 'PERF.md').read_text()
    for m in BENCHMARK['per_layer']:
        moved = e2e[m['moves']]
        assert set(m['workloads']) <= set(moved.get('workloads', CELLS))
        reader = load_reader(BENCH / 'metrics' / f'{m["name"]}.py')
        assert (reader.UNIT, reader.LAYER, reader.MOVES) == (m['unit'], m['layer'], m['moves'])
        assert f'| {m["layer"]} |' in perf, f'layer {m["layer"]!r} not in PERF.md'


def test_a_new_cell_metric_and_kernel_need_only_new_files(tiny_repo, tmp_path):
    root = tmp_path / 'checkout'
    shutil.copytree(tiny_repo, root)
    bench = json.loads((root / 'BENCHMARK.json').read_text())
    traffic = json.loads((root / 'benchmark' / 'traffic' / 'tiny_infer.json').read_text())
    traffic['batch'] = 1
    (root / 'benchmark' / 'traffic' / 'tiny_infer_b1.json').write_text(json.dumps(traffic))
    (root / 'benchmark' / 'limits' / 'tiny_fv2p_infer_b1.json').write_text(
        (root / 'benchmark' / 'limits' / 'tiny_fv2p_infer.json').read_text())
    (root / 'benchmark' / 'kernels' / 'gather.py').write_text(
        "from fvbench.bounds import HBM_BYTES_S\n\nPROGRAM = 'fv2p_torch.ops.sparse.conv'\n"
        "ENTRIES = ('gather_rows',)\nDEVICE_NAMES = ('gather_kernel',)\n\n\n"
        "def bound(call):\n    return call[1][0].nbytes / HBM_BYTES_S, 0.0\n")
    (root / 'benchmark' / 'metrics' / 'batches_per_s.infer.py').write_text(
        "UNIT = 'batches/s'\nLAYER = 'model step'\nMOVES = 'infer_scans_per_s'\n\n\n"
        "def read(rec):\n    return rec['batches'] / rec['window_s']\n")
    bench['workloads'].append({'name': 'tiny_fv2p_infer_b1', 'config': 'tiny_fv2p',
                               'traffic': 'tiny_infer_b1', 'chips': 1, 'why': 'batch 1'})
    bench['per_layer'].append({'name': 'batches_per_s.infer', 'unit': 'batches/s',
                               'better': 'higher', 'source': 'host_clock',
                               'layer': 'model step', 'moves': 'infer_scans_per_s',
                               'workloads': ['tiny_fv2p_infer_b1']})
    for m in bench['end_to_end']:
        if m['name'] in ('infer_scans_per_s', 'infer_batch_p95_ms'):
            m['workloads'].append('tiny_fv2p_infer_b1')
    (root / 'BENCHMARK.json').write_text(json.dumps(bench))
    cell = Cell('tiny_fv2p_infer_b1', root)
    assert cell.batch_size == 1
    assert 'batches_per_s.infer' in cell.readers
    assert cell.readers['batches_per_s.infer'].read({'batches': 10, 'window_s': 2.0}) == 5.0
    assert 'batches_per_s.infer' not in Cell('tiny_fv2p_infer', root).readers
    assert kernel_of(cell.kernels, 'void gather_kernel<int>()') == 'gather'


# run in a fresh interpreter whose ``refnet`` and ``fvbench`` are the copy's
SECOND_TRUNK_RUN = """
import sys, time
sys.path[:0] = [{bench!r}, {repo!r}]
import torch
torch.set_num_threads(2)
from fvbench import harness, program, reference
from fvbench.cell import Cell, dataset_meta
cell = Cell('tiny_mgaf_second_infer')
meta = dataset_meta(cell.cfg, cell.traffic['voxel_cap'])
ref = reference.build_model(cell.cfg, meta, 'cpu')
port = program.build_model(cell.config['cfg'], meta, torch.float32, ref.state_dict(), 'cpu')
print(type(ref.backbone_3d).__module__, type(port.backbone_3d).__name__)
fields = harness.run(cell, 2 ** 31 + 17, 0.5, False, time.perf_counter(), device='cpu')
print(fields['correct'], fields['readings']['detections'])
"""


def test_a_configuration_with_another_backbone_needs_only_new_files(tiny_repo, tmp_path):
    """SECOND's plain trunk (``VoxelBackBone8x``) under the tiny MGAF-3DSSD:
    its reference module, its slot file, the configuration, the limits and
    the cell are new files and entries; no file of the benchmark changes."""
    from refnet.models.backbones_3d import spconv_backbone
    root = tmp_path / 'checkout'
    shutil.copytree(tiny_repo, root)
    for sub in ('fvbench', 'refnet'):
        shutil.copytree(BENCH / sub, root / 'benchmark' / sub,
                        ignore=shutil.ignore_patterns('__pycache__'))
    before = {p: p.read_bytes() for p in (root / 'benchmark').rglob('*') if p.is_file()}
    models = root / 'benchmark' / 'refnet' / 'models'
    assert not (models / 'slots' / 'VoxelBackBone8x.py').exists()
    (models / 'backbones_3d' / 'second_trunk.py').write_text(
        'from ...ops.sparse.conv import SparseConvBNReLU\n'
        'from .spconv_backbone import _SparseBackbone\n\n\n'
        + inspect.getsource(spconv_backbone.VoxelBackBone8x))
    (models / 'slots' / 'VoxelBackBone8x.py').write_text(
        'from ..backbones_3d.second_trunk import VoxelBackBone8x\n\n\n'
        'def build(det):\n'
        '    cfg, meta = det.model_cfg.BACKBONE_3D, det.dataset_meta\n'
        "    return VoxelBackBone8x(meta['num_point_features'], meta['grid_size'],\n"
        "                           det.compute_dtype, level_caps=cfg.get('LEVEL_CAPACITIES'))\n")
    cfg = json.loads((root / 'benchmark' / 'configs' / 'tiny_mgaf.json').read_text())
    cfg['name'] = 'tiny_mgaf_second'
    cfg['cfg']['MODEL']['BACKBONE_3D']['NAME'] = 'VoxelBackBone8x'
    (root / 'benchmark' / 'configs' / 'tiny_mgaf_second.json').write_text(json.dumps(cfg))
    (root / 'benchmark' / 'limits' / 'tiny_mgaf_second_infer.json').write_text(
        (root / 'benchmark' / 'limits' / 'tiny_mgaf_infer.json').read_text())
    bench = json.loads((root / 'BENCHMARK.json').read_text())
    bench['configs'].append({'name': 'tiny_mgaf_second', 'source': 'CPU test',
                             'file': 'benchmark/configs/tiny_mgaf_second.json',
                             'reduced': [], 'why': 'another sparse trunk'})
    bench['workloads'].append({'name': 'tiny_mgaf_second_infer', 'config': 'tiny_mgaf_second',
                               'traffic': 'tiny_infer', 'chips': 1, 'why': 'SECOND trunk'})
    for m in bench['end_to_end']:
        if m['name'] in ('infer_scans_per_s', 'infer_batch_p95_ms'):
            m['workloads'].append('tiny_mgaf_second_infer')
    (root / 'BENCHMARK.json').write_text(json.dumps(bench))
    assert all(p.read_bytes() == b for p, b in before.items())
    code = SECOND_TRUNK_RUN.format(bench=str(root / 'benchmark'), repo=str(REPO))
    out = subprocess.run([sys.executable, '-c', code], capture_output=True, text=True,
                         cwd=root, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    modules, verdict = out.stdout.split('\n')[-3:-1]
    assert modules == 'refnet.models.backbones_3d.second_trunk VoxelBackBone8x'
    correct, detections = verdict.split()
    assert correct == 'True' and int(detections) > 0


def test_an_unknown_module_names_the_file_to_add():
    from refnet.models.detectors.detector3d_template import build_detector, slot_module
    from fvbench.cell import AttrDict
    with pytest.raises(NotImplementedError, match='refnet/models/detectors/NoSuchNet.py'):
        build_detector(AttrDict({'NAME': 'NoSuchNet'}), 1, ['Car'], {})
    with pytest.raises(NotImplementedError, match='refnet/models/slots/NoSuchTrunk.py'):
        slot_module('NoSuchTrunk')


def test_readers_find_nothing_where_nothing_was_measured():
    """A reader without its spans gives None, never 0 for a share."""
    for m in BENCHMARK['per_layer']:
        reader = load_reader(BENCH / 'metrics' / f'{m["name"]}.py')
        if m['name'].startswith('step_mfu'):
            continue
        assert reader.read({}) is None, m['name']


@pytest.mark.parametrize('mode', ['infer', 'train'])
def test_idle_takes_busy_time_from_the_trace_and_wall_time_from_the_window(mode):
    rec = {'busy_s': 0.8, 'profiled_s': 1.2, 'profiled_batches': 8,
           'window_s': 30.0, 'batches': 250}
    idle = load_reader(BENCH / 'metrics' / f'device_idle_pct.{mode}.py').read(rec)
    slow = load_reader(BENCH / 'metrics' / f'profiler_slowdown_pct.{mode}.py').read(rec)
    assert idle == pytest.approx(100 * (1 - 0.1 / 0.12))
    assert slow == pytest.approx(100 * (0.15 / 0.12 - 1))


def test_configs_hold_the_yaml_as_run():
    """Each configuration file holds its yaml as the port's loader resolves
    it, nothing changed (``reduced`` is empty)."""
    from fv2p_torch.config import EasyDict, cfg_from_yaml_file
    for c in BENCHMARK['configs']:
        cfg = json.loads((REPO / c['file']).read_text())
        assert cfg['reduced'] == [] and cfg['compute_dtype'] == 'bfloat16'
        resolved = cfg_from_yaml_file(str(REPO / cfg['yaml']), EasyDict())
        assert json.loads(json.dumps(resolved)) == cfg['cfg']
