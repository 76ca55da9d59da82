"""The port's demo (``python -m fv2p_torch.tools.demo``) against the JAX
package's ``tools/demo.py`` (imported by path) on the CPU, on a tiny FV2P
(``TINY_FV2P_CFG``, raw points kept) and a tiny MGAF-3DSSD
(``TINY_MODEL_CFG``), each written to a yaml with the tiny data config:

* ``load_points``: the seeded synthetic scan, a ``.bin`` and a ``.npy``
  scan, equal to JAX's;
* the batch: JAX's ``main`` runs with a stand-in model that records the
  batch it is given (``jax.jit`` made the identity, so the stand-in sees
  arrays), and the port's ``build_batch`` gives the same arrays, dtypes
  and shapes (no rulebooks: both build their tables in the forward);
* the printed lines: the stand-in hands JAX's ``main`` the port's
  detections, and JAX prints the lines the port prints;
* the detections: JAX's weights (flax init, BatchNorms perturbed; MGAF's
  offset convs and heat-map output as ``tests/test_torch_mgaf.py`` sets
  them) carried across by ``load_flax_variables``, the port's f32 forward
  against JAX's ``model.apply`` on the same batch: valid flags and labels
  exact, boxes and scores at ``assert_close``'s 1e-4;
* ``main(['--device', 'cpu', ...])`` runs and prints; without a card the
  default device raises; ``--vis`` exits with its reason.
"""
import importlib.util
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import fv2p_tpu.config as jax_config
import fv2p_tpu.models as jax_models
from tests.jitu import japply, jinit
from tests.test_fv2p_model import TINY_FV2P_CFG
from tests.test_mgaf_model import TINY_DATA_CFG, TINY_MODEL_CFG
from tests.test_torch_device_mode import roomy
from tests.test_torch_dcn import perturb_offset_conv
from tests.test_torch_model import assert_close, assert_equal, perturb_bn

from fv2p_torch.config import EasyDict, cfg_from_yaml_file
from fv2p_torch.datasets import dataset_meta_from_cfg
from fv2p_torch.tools import demo
from fv2p_torch.weights import load_flax_variables
from tests.test_torch_model import one_torch_thread  # noqa: F401 (an autouse fixture)

REPO = Path(__file__).resolve().parent.parent
RAW_POINTS_CAP = 512
MODELS = {'fv2p': TINY_FV2P_CFG, 'mgaf': TINY_MODEL_CFG}


def _jax_demo():
    spec = importlib.util.spec_from_file_location('jax_demo', REPO / 'tools' / 'demo.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _plain(d):
    return json.loads(json.dumps(d))


def write_cfg(tmp_path, name):
    """A yaml: the tiny data config (raw points kept for FV2P) and a tiny
    model whose level capacities hold the whole scan."""
    data = _plain(TINY_DATA_CFG)
    if name == 'fv2p':
        data.update(KEEP_RAW_POINTS=True, MAX_POINTS_PER_SCAN=RAW_POINTS_CAP)
    cfg = {'CLASS_NAMES': ['Car'], 'DATA_CONFIG': data, 'MODEL': _plain(roomy(MODELS[name]))}
    path = tmp_path / f'{name}.yaml'
    path.write_text(yaml.safe_dump(cfg))
    return path


def _args(path, data_path=None):
    return type('Args', (), {'cfg_file': str(path), 'data_path': data_path})()


def _cfg(path):
    cfg = EasyDict()
    cfg_from_yaml_file(str(path), cfg)
    return cfg


@pytest.mark.parametrize('kind', ['synthetic', 'bin', 'npy'])
def test_load_points_matches_jax(tmp_path, kind):
    path = write_cfg(tmp_path, 'fv2p')
    cfg = _cfg(path)
    data_path = None
    if kind == 'bin':
        data_path = str(REPO / 'data' / 'kitti' / 'training' / 'velodyne' / '000032.bin')
    elif kind == 'npy':
        data_path = str(tmp_path / 'scan.npy')
        np.save(data_path, np.random.RandomState(5).rand(300, 5).astype(np.float32))
    ref = _jax_demo().load_points(_args(path, data_path), cfg)
    got = demo.load_points(_args(path, data_path), cfg)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def run_jax_demo(monkeypatch, capsys, argv, preds):
    """JAX's ``main`` with a stand-in model: returns the batch it built and
    the lines it printed for ``preds`` (numpy, a leading batch axis)."""
    seen = {}

    class StandIn:
        def init(self, rngs, batch, train):
            return {'params': {}}

        def apply(self, variables, batch, train):
            seen.update({k: np.asarray(v) for k, v in batch.items()})
            return {k: jnp.asarray(v) for k, v in preds.items()}

    monkeypatch.delenv('FV2P_PLATFORM', raising=False)
    monkeypatch.setattr(jax_config, 'cfg', jax_config.EasyDict())
    monkeypatch.setattr(jax_models, 'build_network', lambda *a, **k: StandIn())
    monkeypatch.setattr(jax, 'jit', lambda f, *a, **k: f)
    monkeypatch.setattr(sys, 'argv', ['demo.py'] + argv)
    capsys.readouterr()
    _jax_demo().main()
    return seen, capsys.readouterr().out.splitlines()


def _jax_weights(cfg, batch):
    jmodel = jax_models.build_network(cfg.MODEL, num_class=1, class_names=['Car'],
                                      dataset_meta=dataset_meta_from_cfg(cfg.DATA_CONFIG, 'test'))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jinit(jmodel, jax.random.PRNGKey(0), dict(jb))
    rng = np.random.RandomState(1)
    vnp = perturb_bn(jax.tree_util.tree_map(np.asarray, dict(variables)), rng)
    if 'hm_out' in vnp['params'].get('dense_head', {}):
        vnp['params'] = perturb_offset_conv(vnp['params'], rng)
        hm_out = vnp['params']['dense_head']['hm_out']
        hm_out['bias'][:] = 0.0
        hm_out['kernel'] = np.abs(rng.randn(*hm_out['kernel'].shape)).astype(np.float32)
    else:
        vnp['params']['dense_head']['conv_cls']['bias'][:] = 0.0
    out = japply(jmodel, jax.tree_util.tree_map(jnp.asarray, vnp), dict(jb))
    return vnp, out


@pytest.mark.parametrize('name', sorted(MODELS))
def test_demo_matches_jax(tmp_path, monkeypatch, capsys, name):
    """The synthetic scan (18000 points; FV2P keeps the first 512 as its
    raw points)."""
    path = write_cfg(tmp_path, name)
    argv = ['--cfg_file', str(path)]
    args, cfg = demo.parse_config(argv + ['--device', 'cpu'])
    points = demo.load_points(args, cfg)
    batch = demo.build_batch(points, cfg)
    assert 'rulebooks' not in batch
    assert sorted(batch) == sorted(
        ['voxels', 'voxel_coords', 'voxel_num_points', 'voxel_valid']
        + (['points', 'points_valid'] if name == 'fv2p' else []))

    # the port's f32 forward from JAX's weights against JAX's apply
    vnp, out = _jax_weights(cfg, batch)
    model = load_flax_variables(demo.build_model(cfg, 'cpu', compute_dtype=None), vnp)
    dets, _ = demo.detect(model, batch)
    valid = np.asarray(out['pred_valid'])[0]
    assert valid.sum() > 0
    assert dets['pred_scores'].shape[0] == valid.sum()
    assert_equal(dets['pred_labels'], np.asarray(out['pred_labels'])[0][valid])
    assert_close(torch.from_numpy(dets['pred_boxes']), np.asarray(out['pred_boxes'])[0][valid])
    assert_close(torch.from_numpy(dets['pred_scores']),
                 np.asarray(out['pred_scores'])[0][valid])

    # JAX's main on the same arguments: its batch, and its lines for the
    # port's detections
    k = dets['pred_scores'].shape[0]
    preds = {'pred_boxes': dets['pred_boxes'][None], 'pred_scores': dets['pred_scores'][None],
             'pred_labels': dets['pred_labels'][None], 'pred_valid': np.ones((1, k), bool)}
    jbatch, jlines = run_jax_demo(monkeypatch, capsys, argv, preds)
    assert sorted(jbatch) == sorted(batch)
    for key, ref in jbatch.items():
        assert batch[key].dtype == ref.dtype, key
        np.testing.assert_array_equal(batch[key], ref, err_msg=key)
    assert jlines == [f'loaded {points.shape[0]} points'] + demo.detection_lines(
        dets, cfg.CLASS_NAMES)


def test_main_on_cpu_prints_and_returns(tmp_path, capsys):
    path = write_cfg(tmp_path, 'fv2p')
    rec = demo.main(['--cfg_file', str(path), '--device', 'cpu'])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == 'loaded 18000 points'
    assert lines[1] == f'detections: {rec["detections"]["pred_scores"].shape[0]}'
    assert len(lines) == 2 + rec['detections']['pred_scores'].shape[0]
    assert rec['batch']['points'].shape == (1, RAW_POINTS_CAP, 4)
    assert rec['setup_s'] > 0 and rec['forward_ms'] > 0


def test_main_needs_a_card_by_default(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        demo.main(['--cfg_file', str(write_cfg(tmp_path, 'mgaf'))])


def test_vis_is_refused_with_its_reason(capsys):
    with pytest.raises(SystemExit):
        demo.parse_config(['--vis', 'bev.png'])
    assert 'matplotlib' in capsys.readouterr().err
