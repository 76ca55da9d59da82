"""Multi-GPU data parallelism of the port (``fv2p_torch/parallel``) against
the JAX package, on the CPU: ranks over gloo in spawned processes
(``tests/ddp_worker.py``), JAX on two of the tests' eight virtual devices.

* One data-parallel train step of the tiny MGAF-3DSSD and of the tiny FV2P:
  JAX's ``make_dp_train_step`` over ``make_mesh(jax.devices()[:2])``
  against the port's ``TrainStep`` over two DDP ranks, from one set of
  flax variables and one global batch of two scans (one a device, one a
  rank). The loss terms (the devices' mean), ``grad_norm``, the updated
  parameters and the averaged running statistics agree; both ranks end
  with the same state. The RoI sampling of FV2P draws from JAX's pinned
  key on each device, and each rank is fed the same draws, as
  ``tests/test_torch_train.py`` does for one device.
* ``global_batch_slice`` is JAX's sample-axis sharding; ``stride_shard``
  followed by ``interleave`` restores dataset order, as JAX's
  ``_interleave`` does; the dry run's tiny models are the tests' own.
* Two data-parallel steps of the tiny MGAF-3DSSD and of the tiny PointRCNN
  (``tests/test_torch_pointrcnn.py``'s): the second step runs (DDP finds
  every gradient of the first reduced), the terms are finite, and the
  ranks stay replicated.

``tests/test_torch_ddp_runner.py`` holds the rest: world size 1, the
sampler, the runners and the dry run.

Tolerance: 1e-4 max|ref| + 1e-6 in f32 for every float compared with JAX.
Adam's first step moves a parameter by about lr * sign(g), so where the
port's gradient is rounding noise (at most twice the gradient tolerance of
the one-device train tests, exact zeros included: JAX's side of those is
not known) each side is held to a move of at most lr instead.
"""
import copy
import datetime
import pickle
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import yaml

from fv2p_tpu import parallel as jax_parallel
from fv2p_tpu.config import StaticConfig
from fv2p_tpu.models import build_network as jax_build_network
from fv2p_tpu.models.roi_heads import iouguided_roi_head as jax_roi
from fv2p_tpu.ops import pointops as jax_pointops
from fv2p_tpu.train_utils import optimization as jax_optim
from fv2p_tpu.train_utils import train_state as jax_train_state
from tests import ddp_worker
from tests import test_torch_pointrcnn_train as prcnn
from tests.jitu import japply, jinit
from tests.test_fv2p_model import TINY_FV2P_CFG
from tests.test_mgaf_model import TINY_DATA_CFG, TINY_MODEL_CFG
from tests.test_torch_mgaf_train import MGAF_YAML, _tiny_variables, _yaml
from tests.test_torch_model import (_three_nn_interpolate_pallas, make_rulebook_batches,
                                    perturb_bn, to_jax)
from tests.test_torch_runner import _plain as plain
from tests.test_torch_train import (SAMPLING_KEY, _kitti_optim_cfg, flat_paths,
                                    jax_sampling_draws)

from fv2p_torch import parallel
from fv2p_torch.parallel import dryrun
from tests.test_torch_model import one_torch_thread  # noqa: F401 (an autouse fixture)

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / 'tools'))
from eval_utils import eval_utils as jax_eval_utils  # noqa: E402

WORLD = 2
TOTAL = 100
# the spawned ranks' limits: a stuck gloo rendezvous or collective fails its
# test within LAUNCH_TIMEOUT, a launch that hangs otherwise within LAUNCH_WALL
LAUNCH_TIMEOUT = datetime.timedelta(seconds=120)
LAUNCH_WALL = 600


@pytest.fixture(scope='module', autouse=True)
def launch_limits():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(parallel, 'TIMEOUT', LAUNCH_TIMEOUT)
        mp.setattr(parallel, 'WALL', LAUNCH_WALL)
        yield


def close(actual, ref, what=''):
    """|actual - ref| <= 1e-4 max|ref| + 1e-6, elementwise."""
    a, r = np.asarray(actual, np.float64), np.asarray(ref, np.float64)
    assert a.shape == r.shape, (what, a.shape, r.shape)
    tol = 1e-4 * (float(np.abs(r).max()) if r.size else 0.0) + 1e-6
    err = float(np.abs(a - r).max()) if r.size else 0.0
    assert err <= tol, f'{what}: max abs error {err} > {tol}'


def zero_by_construction(path):
    """The sparse residual blocks' conv biases: a train-mode BatchNorm
    follows each, so their true gradient is 0 and both sides give noise."""
    return path.startswith('backbone_3d/res') and '/conv' in path and path.endswith('/bias')


# ------------------------------------------------------- the setups

def mgaf_setup():
    """The tiny MGAF, its variables and batch as
    ``tests/test_torch_mgaf_train.py`` builds them (gt moved off three of
    JAX's decoded boxes a scan)."""
    jax_np, torch_np, meta = make_rulebook_batches()
    jax_np['gt_boxes'] = np.zeros((2, 10, 8), np.float32)
    jmodel = jax_build_network(TINY_MODEL_CFG, num_class=1, class_names=['Car'],
                               dataset_meta=meta)
    vnp = _tiny_variables(jmodel, to_jax(jax_np))
    first, _ = japply(jmodel, jax.tree_util.tree_map(jnp.asarray, vnp),
                      dict(to_jax(jax_np)), train=True, mutable=['batch_stats'])
    boxes = np.asarray(first['head_ret']['batch_box_preds'])
    shift = np.array([[0.1, -0.1, 0.05, 0.1, 0.05, -0.05, 0.1],
                      [0.25, 0.2, -0.1, -0.2, 0.1, 0.05, -0.2],
                      [-0.4, 0.3, 0.1, 0.3, -0.1, 0.1, 0.3]], np.float32)
    gt = np.zeros((2, 10, 8), np.float32)
    for b in range(2):
        gt[b, :3, :7] = boxes[b, [0, 2, 5]] + shift
        gt[b, :3, 7] = 1
    jax_np['gt_boxes'] = torch_np['gt_boxes'] = gt
    return {'cfg': TINY_MODEL_CFG, 'jmodel': jmodel, 'vnp': vnp, 'meta': meta,
            'jax_np': jax_np, 'torch_np': torch_np, 'optim': _yaml(MGAF_YAML).OPTIMIZATION,
            'draws': None}


def fv2p_setup():
    """The tiny FV2P (DP_RATIO 0), its variables and batch as
    ``tests/test_torch_train.py`` builds them (gt at three of each scan's
    proposals, the RPN's box conv scaled so that proposals differ in
    size); the RoI draws of one scan on SAMPLING_KEY."""
    cfg = copy.deepcopy(TINY_FV2P_CFG)
    cfg.ROI_HEAD.DP_RATIO = 0.0
    jax_np, torch_np, meta = make_rulebook_batches()
    jax_np['gt_boxes'] = np.zeros((2, 10, 8), np.float32)
    jmodel = jax_build_network(cfg, num_class=1, class_names=['Car'], dataset_meta=meta)
    variables = jinit(jmodel, {'params': jax.random.PRNGKey(0),
                               'sampling': jax.random.PRNGKey(1),
                               'dropout': jax.random.PRNGKey(2)}, dict(to_jax(jax_np)))
    vnp = perturb_bn(jax.tree_util.tree_map(np.asarray, dict(variables)),
                     np.random.RandomState(0))
    vnp['params']['dense_head']['conv_box']['kernel'] = (
        vnp['params']['dense_head']['conv_box']['kernel'] * 40.0)
    first, _ = japply(jmodel, jax.tree_util.tree_map(jnp.asarray, vnp), dict(to_jax(jax_np)),
                      train=True, mutable=['batch_stats'],
                      rngs={'sampling': jax.random.PRNGKey(3), 'dropout': jax.random.PRNGKey(4)})
    rois, _, _, roi_valid = jax_roi.proposal_layer(
        first['batch_box_preds'], first['batch_cls_preds'], cfg.ROI_HEAD.NMS_CONFIG.TRAIN)
    gt = np.zeros((2, 10, 8), np.float32)
    for b in range(2):
        picks = np.flatnonzero(np.asarray(roi_valid[b]))[[0, 4, 8]]
        gt[b, :3, :7] = np.asarray(rois[b])[picks]
        gt[b, :3, 7] = 1
    jax_np['gt_boxes'] = torch_np['gt_boxes'] = gt
    tcfg = cfg.ROI_HEAD.TARGET_CONFIG
    draws = jax_sampling_draws(SAMPLING_KEY, 2 // WORLD,
                               int(cfg.ROI_HEAD.NMS_CONFIG.TRAIN.NMS_POST_MAXSIZE),
                               int(tcfg.ROI_PER_IMAGE))
    return {'cfg': cfg, 'jmodel': jmodel, 'vnp': vnp, 'meta': meta, 'jax_np': jax_np,
            'torch_np': torch_np, 'optim': _kitti_optim_cfg(),
            'draws': {k: v.numpy() for k, v in draws.items()}}


def pointrcnn_setup():
    """The tiny PointRCNN, its variables and batch as
    ``tests/test_torch_pointrcnn.py`` builds them for its train step, with
    each scan's gt at three of the proposals that a rank holding that scan
    alone makes (from a forward over the scan twice: the same batch
    statistics), so that both ranks sample foreground RoIs; the port's own
    RoI draws."""
    cfg = prcnn._train_cfg('cls')
    batch_np, meta = prcnn.tiny_batch()
    jmodel, jb, vnp = prcnn.jax_setup(cfg, batch_np, meta, seed=prcnn.TRAIN_SEED)
    gt = []
    for b in range(WORLD):
        twice = {k: v[[b, b]] for k, v in batch_np.items()}
        alone, _ = prcnn.train_batch(cfg, jmodel, {k: jnp.asarray(v) for k, v in twice.items()},
                                     vnp, twice)
        gt.append(alone['gt_boxes'][0])
    batch_np = dict(batch_np, gt_boxes=np.stack(gt))
    return {'cfg': cfg, 'vnp': vnp, 'meta': meta, 'torch_np': batch_np,
            'optim': _kitti_optim_cfg(), 'draws': None}


def write_spec(s, path, batch_size, steps=1):
    spec = {'cfg': plain(s['cfg']), 'meta': s['meta'], 'variables': s['vnp'],
            'batch': s['torch_np'], 'batch_size': batch_size, 'optim': plain(s['optim']),
            'total': TOTAL, 'draws': s['draws'], 'steps': steps}
    path.write_bytes(pickle.dumps(spec))
    return path


@pytest.fixture(scope='module', params=['mgaf', 'fv2p'])
def dp_run(request, tmp_path_factory):
    """One data-parallel step of both packages from the same variables and
    global batch."""
    s = {'mgaf': mgaf_setup, 'fv2p': fv2p_setup}[request.param]()
    mesh = jax_parallel.make_mesh(jax.devices()[:WORLD])
    tx = jax_optim.build_optimizer(StaticConfig(s['optim']), TOTAL)
    state = jax_train_state.create_train_state(
        s['jmodel'], jax.tree_util.tree_map(jnp.asarray, s['vnp']), tx)
    orig_assign = jax_roi.assign_targets
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_pointops, 'three_nn_interpolate', _three_nn_interpolate_pallas)
        mp.setattr(jax_roi, 'assign_targets',
                   lambda key, bd, tcfg: orig_assign(SAMPLING_KEY, bd, tcfg))
        new_state, metrics = jax_parallel.make_dp_train_step(s['jmodel'], mesh)(
            state, jax_parallel.shard_batch(mesh, to_jax(s['jax_np'])))
    spec = write_spec(s, tmp_path_factory.mktemp('ddp') / 'spec.pkl', 2)
    ranks = parallel.launch(ddp_worker.dp_step, WORLD, (str(spec),), 'cpu',
                            result_path=spec.with_name('result.pkl'))
    lr0 = float(jax_optim.one_cycle_lr_schedule(
        float(s['optim'].LR), float(s['optim'].DIV_FACTOR), float(s['optim'].PCT_START),
        TOTAL)(0))
    return {'name': request.param, 'ranks': ranks,
            'metrics': {k: float(v) for k, v in metrics.items()},
            'params': flat_paths(jax.tree_util.tree_map(np.asarray, new_state.params)),
            'stats': flat_paths(jax.tree_util.tree_map(np.asarray, new_state.batch_stats)),
            'params0': flat_paths(s['vnp']['params']), 'lr0': lr0,
            'weight_decay': float(s['optim'].WEIGHT_DECAY)}


def test_dp_step_losses_match_jax(dp_run):
    got, ref = dp_run['ranks'][0]['metrics'], dp_run['metrics']
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        close(got[k], v, k)
        assert np.isfinite(v)
    assert ref['loss'] > 0 and ref['grad_norm'] > 0


def test_dp_step_running_stats_match_jax(dp_run):
    got = flat_paths(dp_run['ranks'][0]['variables']['batch_stats'])
    assert sorted(got) == sorted(dp_run['stats'])
    for k, ref in dp_run['stats'].items():
        close(got[k], ref, k)


def test_dp_step_updated_params_match_jax(dp_run):
    s = dp_run
    got_all = flat_paths(s['ranks'][0]['variables']['params'])
    grads = flat_paths(s['ranks'][0]['grads']['params'])
    lr, wd = s['lr0'], s['weight_decay']
    assert sorted(got_all) == sorted(s['params'])
    n_noise = n_all = 0
    for k, ref in s['params'].items():
        got, g, p0 = got_all[k], grads[k], s['params0'][k]
        # (the port's gradient alone is known: an exact 0 there may be JAX's
        # 1e-9, which Adam turns into a move of a sizeable part of lr)
        noise = np.abs(g) <= 2 * (1e-4 * np.abs(g).max() + 1e-7)
        if zero_by_construction(k):
            noise[:] = True
        close(np.where(noise, 0.0, got), np.where(noise, 0.0, ref), k)
        for side in (got, ref):
            move = np.abs(side - p0 + lr * wd * p0)[noise]
            assert not move.size or float(move.max()) <= lr * (1 + 1e-4), k
        n_noise += int(noise.sum())
        n_all += noise.size
    assert n_noise < 0.02 * n_all, (n_noise, n_all)


def test_dp_step_leaves_the_ranks_replicated(dp_run):
    """Both ranks end the step with the same parameters and statistics."""
    a, b = (flat_paths(r['variables']) for r in dp_run['ranks'])
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ------------------------------------------------------------ splits

@pytest.mark.parametrize('batch_size,world', [(2, 2), (4, 2), (8, 4)])
def test_global_batch_slice_is_jax_sharding(batch_size, world):
    mesh = jax_parallel.make_mesh(jax.devices()[:world])
    x = np.arange(batch_size * 3, dtype=np.float32).reshape(batch_size, 3)
    sharded = jax_parallel.shard_batch(mesh, {'x': jnp.asarray(x)})['x']
    for shard in sharded.addressable_shards:
        r = mesh.devices.tolist().index(shard.device)
        np.testing.assert_array_equal(np.asarray(shard.data),
                                      x[parallel.global_batch_slice(batch_size, r, world)])
    with pytest.raises(ValueError, match='does not split'):
        parallel.global_batch_slice(batch_size + 1, 0, world)


@pytest.mark.parametrize('n,world', [(7, 3), (24, 2), (5, 5), (2, 4)])
def test_stride_shard_and_interleave_restore_dataset_order(n, world):
    parts = [[f'scan{i}' for i in parallel.stride_shard(n, r, world)] for r in range(world)]
    assert sorted(sum(parts, [])) == sorted(f'scan{i}' for i in range(n))
    merged = parallel.interleave(parts)
    assert merged == [f'scan{i}' for i in range(n)] == jax_eval_utils._interleave(parts)


# ------------------------------------------------------------ dry run

def test_dryrun_models_are_the_tests_tiny_configs():
    models = yaml.safe_load(dryrun.MODELS.read_text())
    assert models == {'DATA_CONFIG': plain(TINY_DATA_CFG), 'MGAF': plain(TINY_MODEL_CFG),
                      'FV2P': plain(TINY_FV2P_CFG)}
