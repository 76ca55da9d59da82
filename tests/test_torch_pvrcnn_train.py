"""PV-RCNN and Voxel R-CNN training in the PyTorch port against the JAX
package on the CPU (split from ``tests/test_torch_pvrcnn.py``, which holds
the ball query, the eval forwards and the yamls): one train step of the
tiny ``PVRCNN_CFG`` and ``VOXELRCNN_CFG`` (loss terms, gradients by flax
path, batch statistics, updated parameters) with JAX's RoI draws and
``DP_RATIO`` 0, and five PV-RCNN train steps through the port's
``TrainStep`` and JAX's train step, the running statistics and parameters
held after every step.

Tolerances: floats rtol 1e-4, gradients, statistics and parameters within
1e-4 max|ref| + 1e-7."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fv2p_tpu.config import StaticConfig
from fv2p_tpu.models.detectors import detector3d_template as jax_det
from fv2p_tpu.models.roi_heads import iouguided_roi_head as jax_roi
from fv2p_tpu.models.roi_heads import pvrcnn_head as jax_pvrcnn
from fv2p_tpu.models.roi_heads import voxelrcnn_head as jax_voxelrcnn
from fv2p_tpu.train_utils import optimization as jax_optim
from fv2p_tpu.train_utils import train_state as jax_train_state
from tests.jitu import japply, jgrad
from tests.test_torch_model import assert_close, assert_equal
from tests.test_torch_train import (SAMPLING_KEY, _kitti_optim_cfg, close_by_max, flat_paths,
                                    jax_sampling_draws)

from fv2p_torch.models.roi_heads import pvrcnn_head as torch_pvrcnn
from fv2p_torch.train_utils.train_state import TrainStep
from fv2p_torch.utils.synthetic import batch_to_torch
from fv2p_torch.weights import flax_variables, load_flax_variables

from tests.test_torch_pvrcnn import (CFGS, FIVE_STEPS_TOTAL, TRAIN_STEPS, jax_setup, pv_batch,
                                     torch_model)
from tests.test_torch_model import one_torch_thread  # noqa: F401 (an autouse fixture)


# ------------------------------------------------------------- training

def _train_cfg(name):
    cfg = copy.deepcopy(CFGS[name])
    cfg.ROI_HEAD.DP_RATIO = 0.0
    return cfg


@pytest.fixture(scope='module')
def pinned_draws():
    """JAX's RoI sampling on SAMPLING_KEY whatever key its head draws, and
    the port fed the same draws."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jax_pvrcnn, jax_voxelrcnn):
            mp.setattr(mod, 'assign_targets',
                       lambda key, bd, tcfg: jax_roi.assign_targets(SAMPLING_KEY, bd, tcfg))
        mp.setattr(torch_pvrcnn, 'draw_roi_sampling',
                   lambda b, r, n, gen, dev: jax_sampling_draws(SAMPLING_KEY, b, r, n))
        yield


def train_batch(cfg, jmodel, jb, vnp, batch_np):
    """The batch with gt at three of each scan's proposals, so that the
    sampled RoIs and the keypoints hold foreground."""
    first, _ = japply(jmodel, jax.tree_util.tree_map(jnp.asarray, vnp), dict(jb), train=True,
                      mutable=['batch_stats'], rngs={'sampling': jax.random.PRNGKey(3),
                                                     'dropout': jax.random.PRNGKey(4)})
    rois, _, _, roi_valid = jax_roi.proposal_layer(
        first['batch_box_preds'], first['batch_cls_preds'], cfg.ROI_HEAD.NMS_CONFIG.TRAIN)
    gt = np.zeros((2, 10, 8), np.float32)
    for b in range(2):
        picks = np.flatnonzero(np.asarray(roi_valid[b]))[[0, 3, 6]]
        gt[b, :3, :7] = np.asarray(rois[b])[picks]
        gt[b, :3, 7] = 1
    batch_np = dict(batch_np, gt_boxes=gt)
    return batch_np, {k: jnp.asarray(v) for k, v in batch_np.items()}


@pytest.fixture(scope='module', params=sorted(CFGS))
def train_run(request, pinned_draws):
    """One train step of both packages from the same variables and batch:
    value_and_grad with mutable batch statistics and the adam_onecycle
    update in JAX, ``TrainStep`` in the port."""
    name = request.param
    cfg = _train_cfg(name)
    batch_np, meta = pv_batch()
    jmodel, jb, vnp = jax_setup(cfg, batch_np, meta)
    batch_np, jb = train_batch(cfg, jmodel, jb, vnp, batch_np)
    ocfg = _kitti_optim_cfg()
    total = 100

    def loss_fn(params):
        out, mutated = jmodel.apply({'params': params, 'batch_stats': vnp['batch_stats']},
                                    dict(jb), train=True, mutable=['batch_stats'],
                                    rngs={'sampling': jax.random.PRNGKey(3),
                                          'dropout': jax.random.PRNGKey(4)})
        loss, tb = jax_det.compute_training_loss(jmodel, out)
        return loss, (tb, mutated['batch_stats'], out['roi_head_ret']['rcnn_cls_labels'],
                      out['anchor_head_ret']['box_cls_labels'])

    params = jax.tree_util.tree_map(jnp.asarray, vnp['params'])
    (loss, (tb, stats, roi_labels, rpn_labels)), grads = jgrad(loss_fn, params)
    tx = jax_optim.build_optimizer(StaticConfig(ocfg), total)
    upd, _ = tx.update(grads, tx.init(params), params)
    new_params = optax.apply_updates(params, upd)

    tmodel = torch_model(cfg, meta, vnp)
    step = TrainStep(tmodel, ocfg, total)
    tloss, tterms, tout = step.forward_loss(batch_to_torch(batch_np, 'cpu'))
    rcnn_point_grads = None
    if name == 'pvrcnn':
        # the RCNN loss alone, back to the point head (no stop on the scores)
        rcnn_point_grads = torch.autograd.grad(
            tterms['rcnn_loss'], list(tmodel.point_head.parameters()), retain_graph=True)
    step.backward(tloss)
    tgrads = flax_variables(tmodel, grads=True)
    tstats = flax_variables(tmodel)['batch_stats']
    step.update()
    lr0 = float(jax_optim.one_cycle_lr_schedule(
        float(ocfg.LR), float(ocfg.DIV_FACTOR), float(ocfg.PCT_START), total)(0))
    return {'name': name, 'tb': tb, 'loss': loss, 'grads': flat_paths(grads),
            'stats': flat_paths(stats), 'params': flat_paths(new_params),
            'params0': flat_paths(vnp['params']), 'lr0': lr0,
            'weight_decay': float(ocfg.WEIGHT_DECAY),
            'roi_labels': roi_labels, 'rpn_labels': rpn_labels, 'ttb': tterms,
            'tloss': tloss, 'tout': tout, 'tgrads': flat_paths(tgrads['params']),
            'tstats': flat_paths(tstats),
            'tparams': flat_paths(flax_variables(tmodel)['params']),
            'rcnn_point_grads': rcnn_point_grads}


def test_train_losses_match_jax(train_run):
    s = train_run
    assert_equal(s['tout']['anchor_head_ret']['box_cls_labels'], s['rpn_labels'])
    assert_close(s['tout']['roi_head_ret']['rcnn_cls_labels'], s['roi_labels'])
    assert sorted(s['ttb']) == sorted(s['tb'])
    for k, v in s['tb'].items():
        np.testing.assert_allclose(float(s['ttb'][k].detach()), float(v), rtol=1e-4, err_msg=k)
        assert np.isfinite(float(v))
    np.testing.assert_allclose(float(s['tloss'].detach()), float(s['loss']), rtol=1e-4)
    for k in ('rpn_loss_cls', 'rcnn_loss_cls', 'rcnn_loss_reg', 'rcnn_loss_corner') + (
            ('point_loss_cls',) if s['name'] == 'pvrcnn' else ()):
        assert float(s['tb'][k]) > 0, k


def test_train_gradients_match_jax(train_run):
    s = train_run
    assert sorted(s['tgrads']) == sorted(s['grads'])
    for k, ref in s['grads'].items():
        close_by_max(s['tgrads'][k], ref, k)
    nonzero = sum(float(np.abs(g).max()) > 0 for g in s['grads'].values())
    assert nonzero > 0.9 * len(s['grads'])


def test_train_batch_stats_match_jax(train_run):
    s = train_run
    assert sorted(s['tstats']) == sorted(s['stats'])
    for k, ref in s['stats'].items():
        close_by_max(s['tstats'][k], ref, k)


def test_train_updated_params_match_jax(train_run):
    """Adam's first step moves a parameter by about lr * sign(g): where |g|
    is within rounding noise (at most twice the gradient tolerance) and not
    exactly 0 on both sides (a structural 0, where Adam moves a parameter
    by its decay alone), the signs are noise and each side is held to a
    move of at most lr; everywhere else within 1e-4 * max|ref| + 1e-7."""
    s = train_run
    lr, wd = s['lr0'], s['weight_decay']
    assert sorted(s['tparams']) == sorted(s['params'])
    n_noise = n_all = 0
    for k, ref in s['params'].items():
        got, g, p0 = s['tparams'][k], s['grads'][k], s['params0'][k]
        noise = (np.abs(g) <= 2 * (1e-4 * np.abs(g).max() + 1e-7)) \
            & ((g != 0) | (s['tgrads'][k] != 0))
        close_by_max(np.where(noise, 0.0, got), np.where(noise, 0.0, ref), k)
        for side in (got, ref):
            move = np.abs(side - p0 + lr * wd * p0)[noise]
            assert not move.size or float(move.max()) <= lr * (1 + 1e-4), k
        n_noise += int(noise.sum())
        n_all += noise.size
    assert n_noise < 0.02 * n_all, (n_noise, n_all)


@pytest.mark.parametrize('train_run', ['pvrcnn'], indirect=True)
def test_pvrcnn_rcnn_loss_trains_the_point_head(train_run):
    """PV-RCNN weights the keypoint features by the point head's scores
    without a stop on the gradient: the RCNN loss alone reaches every
    parameter of the point head."""
    s = train_run
    for g in s['rcnn_point_grads']:
        assert float(g.abs().max()) > 0
    ref = {k: v for k, v in s['grads'].items() if k.startswith('point_head/')}
    assert ref and all(float(np.abs(v).max()) > 0 for v in ref.values())


# ------------------------------------------------- running statistics

def _adam_noise(g):
    """Gradient elements within rounding noise of 0: at most twice the
    gradient tolerance (1e-4 max|g| + 1e-7)."""
    return np.abs(g) <= 2 * (1e-4 * np.abs(g).max() + 1e-7)


@pytest.fixture(scope='module')
def five_steps(pinned_draws):
    """TRAIN_STEPS steps of the tiny PV-RCNN through JAX's jitted train
    step and through the port's ``TrainStep`` (adam_onecycle), from one set
    of variables on the same batch and RoI draws. Adam divides each
    gradient element by its own magnitude, so the ~1% of elements whose
    gradient is rounding noise move by up to lr with either sign on either
    side; left alone, the next forward carries those moves into every
    loss term (1e-3 of the loss after one step, while the port's loss from
    JAX's own state after each step agrees to 1e-7). So after each step the
    port takes JAX's parameters, and keeps its own running statistics and
    optimizer state: the statistics accumulate over all steps in the port
    alone. Returns per step JAX's and the port's loss, statistics and
    parameters, and the port's gradients."""
    cfg = _train_cfg('pvrcnn')
    batch_np, meta = pv_batch(seed=1)
    jmodel, jb, vnp = jax_setup(cfg, batch_np, meta, seed=1)
    batch_np, jb = train_batch(cfg, jmodel, jb, vnp, batch_np)
    ocfg = _kitti_optim_cfg()
    tx = jax_optim.build_optimizer(StaticConfig(ocfg), FIVE_STEPS_TOTAL)
    state = jax_train_state.create_train_state(
        jmodel, jax.tree_util.tree_map(jnp.asarray, vnp), tx)
    jstep = jax.jit(jax_train_state.make_train_step(jmodel))
    tmodel = torch_model(cfg, meta, vnp)
    step = TrainStep(tmodel, ocfg, FIVE_STEPS_TOTAL)
    tbatch = batch_to_torch(batch_np, 'cpu')
    ref, got = [], []
    for _ in range(TRAIN_STEPS):
        state, metrics = jstep(state, jb)
        params = jax.tree_util.tree_map(np.asarray, state.params)
        ref.append({'stats': flat_paths(state.batch_stats), 'params': flat_paths(params),
                    'loss': float(metrics['loss'])})
        loss, _, _ = step.forward_loss(tbatch)
        step.backward(loss)
        grads = flat_paths(flax_variables(tmodel, grads=True)['params'])
        step.update()
        v = flax_variables(tmodel)
        got.append({'stats': flat_paths(v['batch_stats']), 'params': flat_paths(v['params']),
                    'loss': float(loss.detach()), 'grads': grads})
        load_flax_variables(tmodel, {'params': params, 'batch_stats': v['batch_stats']})
    return ref, got, flat_paths(vnp['params'])


def test_five_train_steps_running_stats_match_jax(five_steps):
    """After each of five steps every BatchNorm's running mean and variance
    (the port's own, accumulated over the steps), within 1e-4 max|ref| +
    1e-7, and the loss within rtol 1e-4; the statistics move at every
    step."""
    ref, got, _ = five_steps
    for i, (r, g) in enumerate(zip(ref, got)):
        np.testing.assert_allclose(g['loss'], r['loss'], rtol=1e-4, err_msg=f'step {i}')
        assert sorted(g['stats']) == sorted(r['stats'])
        for k, v in r['stats'].items():
            close_by_max(g['stats'][k], v, f'step {i} {k}')
        if i:
            moved = [k for k, v in r['stats'].items()
                     if not np.array_equal(v, ref[i - 1]['stats'][k])]
            assert len(moved) == len(r['stats']), i


def test_five_train_steps_params_match_jax(five_steps):
    """After each of five steps from the same parameters, the updated
    parameters within 1e-4 max|ref| + 1e-7, except where the port's
    gradient is rounding noise (under 2% of the elements): there each
    side's move is held to lr (the one-step test's rule)."""
    ref, got, params0 = five_steps
    ocfg = _kitti_optim_cfg()
    wd = float(ocfg.WEIGHT_DECAY)
    schedule = jax_optim.one_cycle_lr_schedule(
        float(ocfg.LR), float(ocfg.DIV_FACTOR), float(ocfg.PCT_START), FIVE_STEPS_TOTAL)
    for i, (r, g) in enumerate(zip(ref, got)):
        prev = params0 if i == 0 else ref[i - 1]['params']
        lr = float(schedule(i))
        assert sorted(g['params']) == sorted(r['params'])
        n_noise = n_all = 0
        for k, v in r['params'].items():
            noise = _adam_noise(g['grads'][k])
            close_by_max(np.where(noise, 0.0, g['params'][k]), np.where(noise, 0.0, v),
                         f'step {i} {k}')
            for side in (g['params'][k], v):
                move = np.abs(side - prev[k] + lr * wd * prev[k])[noise]
                assert not move.size or float(move.max()) <= lr * (1 + 1e-4), (i, k)
            n_noise += int(noise.sum())
            n_all += noise.size
        assert n_noise < 0.02 * n_all, (i, n_noise, n_all)
