"""PointRCNN training in the PyTorch port against the JAX package on the CPU
(split from ``tests/test_torch_pointrcnn.py``, which holds the building
blocks, the eval forward and the yamls): one train step of the tiny
``POINTRCNN_CFG`` for ``CLS_SCORE_TYPE`` ``cls`` and ``rcnn_iou`` (loss
terms, the RCNN classification labels, gradients, batch statistics,
updated parameters) with JAX's RoI draws fed to the port.

Tolerances as there: integers exact, floats rtol 1e-4, gradients,
statistics and parameters within 1e-4 max|ref| + 1e-7, in f32."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from fv2p_tpu.config import EasyDict as JaxEasyDict
from fv2p_tpu.config import StaticConfig
from fv2p_tpu.models.detectors import detector3d_template as jax_det
from fv2p_tpu.models.roi_heads import iouguided_roi_head as jax_roi
from fv2p_tpu.models.roi_heads import pointrcnn_head as jax_prcnn
from fv2p_tpu.ops import pointops as jax_pointops
from fv2p_tpu.train_utils import optimization as jax_optim
from tests.jitu import japply, jgrad
from tests.test_model_zoo import POINTRCNN_CFG
from tests.test_torch_model import assert_close, assert_equal
from tests.test_torch_train import (SAMPLING_KEY, _kitti_optim_cfg, close_by_max, flat_paths,
                                    jax_sampling_draws)

from fv2p_torch.models.roi_heads import pointrcnn_head as torch_prcnn
from fv2p_torch.train_utils.train_state import TrainStep
from fv2p_torch.utils.synthetic import batch_to_torch
from fv2p_torch.weights import flax_variables

from tests.test_torch_pointrcnn import TRAIN_SEED, jax_setup, tiny_batch, torch_model
from tests.test_torch_model import one_torch_thread  # noqa: F401 (an autouse fixture)


# ------------------------------------------------------------- training

@pytest.fixture(scope='module')
def pinned_draws():
    """JAX's RoI sampling on SAMPLING_KEY whatever key its head draws, and
    the port fed the same draws."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_prcnn, 'assign_targets',
                   lambda key, bd, tcfg: jax_roi.assign_targets(SAMPLING_KEY, bd, tcfg))
        mp.setattr(torch_prcnn, 'draw_roi_sampling',
                   lambda b, r, n, gen, dev: jax_sampling_draws(SAMPLING_KEY, b, r, n))
        yield


def _train_cfg(score_type):
    cfg = copy.deepcopy(POINTRCNN_CFG)
    cfg.ROI_HEAD.TARGET_CONFIG.CLS_SCORE_TYPE = score_type
    if score_type == 'rcnn_iou':
        # soft labels between 0.25 and 0.7, as pointrcnn_iou.yaml sets them
        cfg.ROI_HEAD.TARGET_CONFIG.CLS_FG_THRESH = 0.7
        cfg.ROI_HEAD.TARGET_CONFIG.CLS_BG_THRESH = 0.25
    return JaxEasyDict(cfg)


def train_batch(cfg, jmodel, jb, vnp, batch_np):
    """The batch with gt at the three proposals of each scan that hold the
    most points (from a train forward without gt), grown by 5%, so that
    points and sampled RoIs hold foreground."""
    jb = dict(jb, gt_boxes=jnp.zeros((2, 10, 8), jnp.float32))
    first, _ = japply(jmodel, jax.tree_util.tree_map(jnp.asarray, vnp), jb, train=True,
                      mutable=['batch_stats'], rngs={'sampling': jax.random.PRNGKey(3),
                                                     'dropout': jax.random.PRNGKey(4)})
    rois, _, _, roi_valid = jax_roi.proposal_layer(
        first['batch_box_preds'], first['batch_cls_preds'], cfg.ROI_HEAD.NMS_CONFIG.TRAIN)
    gt = np.zeros((2, 10, 8), np.float32)
    for b in range(2):
        cand = np.asarray(rois[b])[np.asarray(roi_valid[b])]
        inside = jax_pointops.points_in_boxes_index(
            jnp.asarray(batch_np['points'][b, :, :3]), jnp.asarray(cand),
            jnp.ones(len(cand), bool))
        counts = np.bincount(np.asarray(inside)[np.asarray(inside) >= 0], minlength=len(cand))
        gt[b, :3, :7] = cand[np.argsort(-counts, kind='stable')[:3]]
        gt[b, :3, 3:6] *= 1.05
        gt[b, :3, 7] = 1
    batch_np = dict(batch_np, gt_boxes=gt)
    return batch_np, {k: jnp.asarray(v) for k, v in batch_np.items()}


@pytest.fixture(scope='module', params=['cls', 'rcnn_iou'])
def train_run(request, pinned_draws):
    """One train step of both packages from the same variables and batch:
    value_and_grad with mutable batch statistics and the adam_onecycle
    update in JAX, ``TrainStep`` in the port."""
    cfg = _train_cfg(request.param)
    batch_np, meta = tiny_batch()
    jmodel, jb, vnp = jax_setup(cfg, batch_np, meta, seed=TRAIN_SEED)
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
                      out['point_head_ret']['point_cls_labels'])

    params = jax.tree_util.tree_map(jnp.asarray, vnp['params'])
    (loss, (tb, stats, roi_labels, point_labels)), grads = jgrad(loss_fn, params)
    tx = jax_optim.build_optimizer(StaticConfig(ocfg), total)
    upd, _ = tx.update(grads, tx.init(params), params)
    new_params = optax.apply_updates(params, upd)

    tmodel = torch_model(cfg, meta, vnp)
    step = TrainStep(tmodel, ocfg, total)
    tloss, tterms, tout = step.forward_loss(batch_to_torch(batch_np, 'cpu'))
    step.backward(tloss)
    tgrads = flax_variables(tmodel, grads=True)
    tstats = flax_variables(tmodel)['batch_stats']
    step.update()
    lr0 = float(jax_optim.one_cycle_lr_schedule(
        float(ocfg.LR), float(ocfg.DIV_FACTOR), float(ocfg.PCT_START), total)(0))
    return {'score_type': request.param, 'tb': tb, 'loss': loss, 'grads': flat_paths(grads),
            'stats': flat_paths(stats), 'params': flat_paths(new_params),
            'params0': flat_paths(vnp['params']), 'lr0': lr0,
            'weight_decay': float(ocfg.WEIGHT_DECAY), 'roi_labels': roi_labels,
            'point_labels': point_labels, 'ttb': tterms, 'tloss': tloss, 'tout': tout,
            'tgrads': flat_paths(tgrads['params']), 'tstats': flat_paths(tstats),
            'tparams': flat_paths(flax_variables(tmodel)['params'])}


def test_train_losses_match_jax(train_run):
    s = train_run
    assert_equal(s['tout']['point_head_ret']['point_cls_labels'], s['point_labels'])
    assert sorted(s['ttb']) == sorted(s['tb'])
    for k, v in s['tb'].items():
        np.testing.assert_allclose(float(s['ttb'][k].detach()), float(v), rtol=1e-4, err_msg=k)
        assert np.isfinite(float(v))
    np.testing.assert_allclose(float(s['tloss'].detach()), float(s['loss']), rtol=1e-4)
    for k in ('point_loss_cls', 'point_loss_box', 'rcnn_loss_cls', 'rcnn_loss_reg',
              'rcnn_loss_corner'):
        assert float(s['tb'][k]) > 0, k


def test_train_rcnn_cls_labels_match_jax(train_run):
    """``cls``: hard labels of the sampled RoIs' IoU (-1 between the
    thresholds); ``rcnn_iou``: soft labels from the 3D IoU of the decoded
    refinement with its class's gt, strictly between 0 and 1 for some."""
    s = train_run
    got = s['tout']['roi_head_ret']['rcnn_cls_labels']
    assert_close(got, s['roi_labels'])
    ref = np.asarray(s['roi_labels'])
    assert (ref == 1).any() or ((ref > 0) & (ref < 1)).any()
    if s['score_type'] == 'rcnn_iou':
        assert ((ref > 0) & (ref < 1)).any() and ref.min() >= 0


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
    exactly 0 on both sides, each side is held to a move of at most lr;
    everywhere else within 1e-4 * max|ref| + 1e-7."""
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
