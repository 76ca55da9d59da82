"""A cell of the benchmark, found by name: its entry in ``BENCHMARK.json``,
its configuration file, its traffic file, its limits file and the readers
of its per-layer metrics, and the files of the hand kernels. Everything
that belongs to one configuration, traffic mix, cell, metric or kernel is a
file of its own; this module only looks
them up, so a new cell or metric needs new files and entries, never an
edit here."""
import importlib.util
import json
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]


class AttrDict(dict):
    """dict with attribute access, applied to nested dicts and lists (the
    shape the model builders read a yaml's config in)."""

    def __init__(self, d=None):
        super().__init__()
        for k, v in (d or {}).items():
            self[k] = v

    @staticmethod
    def _wrap(v):
        if isinstance(v, dict) and not isinstance(v, AttrDict):
            return AttrDict(v)
        if isinstance(v, (list, tuple)):
            return type(v)(AttrDict._wrap(x) for x in v)
        return v

    def __setitem__(self, k, v):
        super().__setitem__(k, AttrDict._wrap(v))

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError:
            raise AttributeError(k) from None


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_reader(path, kind='metric'):
    """A per-layer metric's module (``UNIT``, ``LAYER``, ``MOVES``,
    ``read(record)``), or a hand kernel's (``kind='kernel'``), loaded from
    its file."""
    spec = importlib.util.spec_from_file_location(f'{kind}_{path.stem}', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    """One workload of the benchmark of the checkout at ``repo``: its
    ``BENCHMARK.json`` and the files under its ``benchmark/``."""

    def __init__(self, workload, repo=REPO):
        repo = Path(repo)
        bench_file, bench_dir = repo / 'BENCHMARK.json', repo / 'benchmark'
        bench = load_json(bench_file)
        entries = {w['name']: w for w in bench['workloads']}
        if workload not in entries:
            raise KeyError(f'no workload {workload!r} in {bench_file}; '
                           f'there are {sorted(entries)}')
        self.name = workload
        self.entry = entries[workload]
        config = {c['name']: c for c in bench['configs']}[self.entry['config']]
        self.config = load_json(repo / config['file'])
        self.traffic = load_json(bench_dir / 'traffic' / f'{self.entry["traffic"]}.json')
        self.limits = load_json(bench_dir / 'limits' / f'{workload}.json')
        self.mode = self.traffic['mode']
        self.end_to_end = [m for m in bench['end_to_end'] if self._reports(m)]
        moves = {m['name'] for m in self.end_to_end}
        self.per_layer = [m for m in bench['per_layer']
                          if m['moves'] in moves and self._reports(m)]
        self.readers = {m['name']: load_reader(bench_dir / 'metrics' / f'{m["name"]}.py')
                        for m in self.per_layer}
        self.kernels = load_kernels(bench_dir)

    def _reports(self, metric):
        return 'workloads' not in metric or self.name in metric['workloads']

    @property
    def cfg(self):
        """The configuration as it is run (the yaml, resolved)."""
        return AttrDict(self.config['cfg'])

    @property
    def batch_size(self):
        b = self.traffic['batch']
        return int(self.config['cfg']['OPTIMIZATION']['BATCH_SIZE_PER_GPU']) \
            if b == 'yaml' else int(b)

    @property
    def level_caps(self):
        """One mode's level capacities (``select_mode_caps``'s rule), or
        None for the capacities derived from the voxel cap."""
        rule = self.traffic['level_caps']
        caps = self.config['cfg']['MODEL']['BACKBONE_3D'].get('LEVEL_CAPACITIES')
        if rule == 'derived' or not caps:
            return None
        if 'train' in caps or 'test' in caps:
            return caps.get({'yaml_train': 'train', 'yaml_test': 'test'}[rule])
        return caps


def load_kernels(bench_dir):
    """{name: module} of every hand kernel's file under ``kernels/``: the
    program's module of its entry points (``PROGRAM``), the entry points
    (``ENTRIES``), its device functions as a trace names them
    (``DEVICE_NAMES``) and ``bound(call)``: (seconds for its bytes, seconds
    for its operations) of one captured call."""
    return {p.stem: load_reader(p, 'kernel')
            for p in sorted((Path(bench_dir) / 'kernels').glob('*.py'))}


def kernel_of(kernels, device_op_name):
    """The hand kernel a device operation of a trace belongs to, or None."""
    for name, k in kernels.items():
        if any(n in device_op_name for n in k.DEVICE_NAMES):
            return name
    return None


def dataset_meta(cfg, voxel_cap):
    """The static sizes a model is built from (the rule of
    ``fv2p_torch.datasets.dataset_meta_from_cfg``): grid and voxel size,
    range, point features, the voxel cap and points a voxel."""
    data = cfg['DATA_CONFIG']
    pc_range = np.array(data['POINT_CLOUD_RANGE'], np.float32)
    proc = next(p for p in data['DATA_PROCESSOR']
                if p['NAME'] == 'transform_points_to_voxels')
    voxel = np.array(proc['VOXEL_SIZE'], np.float32)
    grid = np.round((pc_range[3:6] - pc_range[0:3]) / voxel).astype(int)
    return {'grid_size': tuple(int(g) for g in grid),
            'voxel_size': tuple(float(v) for v in voxel),
            'point_cloud_range': tuple(float(v) for v in pc_range),
            'num_point_features': len(data['POINT_FEATURE_ENCODING']['used_feature_list']),
            'voxel_capacity': int(voxel_cap),
            'max_points_per_voxel': int(proc['MAX_POINTS_PER_VOXEL'])}
