"""One whole train step of the tiny FV2P in the PyTorch port against the JAX
package on the CPU (``TINY_FV2P_CFG`` with ``DP_RATIO`` 0, split from
``tests/test_torch_train.py``, which holds the modules one by one): from
the same flax variables and batch, the targets, the loss terms, every
gradient, the batch statistics after the step and the parameters after the
optimizer step, compared by flax path, with the RoI sampling on JAX's
pinned key.

Tolerances: losses and targets rtol 1e-4; gradients, batch statistics and
updated parameters within ``1e-4 * max|ref| + 1e-7`` per tensor."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from fv2p_tpu.config import StaticConfig
from fv2p_tpu.models import build_network as jax_build_network
from fv2p_tpu.models.detectors import detector3d_template as jax_det
from fv2p_tpu.models.roi_heads import iouguided_roi_head as jax_roi
from fv2p_tpu.ops import pointops as jax_pointops
from fv2p_tpu.train_utils import optimization as jax_optim
from tests.jitu import japply, jgrad, jinit
from tests.test_torch_model import (_three_nn_interpolate_pallas, assert_close, assert_equal,
                                    make_rulebook_batches, perturb_bn, to_jax)

import fv2p_torch.models as torch_models
from fv2p_torch.models.roi_heads import iouguided_roi_head as torch_roi
from fv2p_torch.train_utils.train_state import TrainStep
from fv2p_torch.utils.synthetic import batch_to_torch
from fv2p_torch.weights import flax_variables, load_flax_variables

from tests.test_torch_train import (SAMPLING_KEY, _kitti_optim_cfg, _train_cfg,
                                    _zero_by_construction, close_by_max, flat_paths,
                                    jax_sampling_draws)
from tests.test_torch_model import one_torch_thread  # noqa: F401 (an autouse fixture)


@pytest.fixture(scope='module')
def train_step():
    """One tiny FV2P train step in JAX (value_and_grad, mutable batch
    statistics, then the adam_onecycle update) and in the port, from the
    same variables and batch, with the RoI sampling on JAX's pinned key."""
    cfg = _train_cfg()
    jax_np, torch_np, meta = make_rulebook_batches()
    from tests.test_fv2p_model import make_fv2p_batch
    jax_np['gt_boxes'] = np.asarray(make_fv2p_batch()[0]['gt_boxes'])
    jmodel = jax_build_network(cfg, num_class=1, class_names=['Car'], dataset_meta=meta)
    variables = jinit(jmodel, {'params': jax.random.PRNGKey(0),
                               'sampling': jax.random.PRNGKey(1),
                               'dropout': jax.random.PRNGKey(2)}, dict(to_jax(jax_np)))
    # the BatchNorm perturbation's seed is 1: with seed 0 one element of
    # decode_x_conv3's residual sum lies 6e-7 from its ReLU's edge, and the
    # port's summation order on 2 intra-op threads puts it on the other side
    # from JAX's, which moves that block's BatchNorm gradients by 1.8% of
    # their largest element. Seed 1 agrees with JAX on 1, 2, 3, 4 and 8
    # threads.
    vnp = perturb_bn(jax.tree_util.tree_map(np.asarray, dict(variables)),
                     np.random.RandomState(1))
    # box residuals of ~0.3 in place of the init's ~0.01: the proposals then
    # differ in size, so the corner-geometry stream's batch statistics are
    # not those of near-copies of one box (where a train-mode BatchNorm
    # divides rounding noise by a variance of ~1e-6)
    vnp['params']['dense_head']['conv_box']['kernel'] = (
        vnp['params']['dense_head']['conv_box']['kernel'] * 40.0)
    ocfg = _kitti_optim_cfg()
    total = 100
    orig_assign = jax_roi.assign_targets
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_pointops, 'three_nn_interpolate', _three_nn_interpolate_pallas)
        mp.setattr(jax_roi, 'assign_targets',
                   lambda key, bd, tcfg: orig_assign(SAMPLING_KEY, bd, tcfg))
        # gt: three of each scan's proposals, so the sampled RoIs hold
        # foreground and every RCNN loss term has a gradient
        first, _ = japply(jmodel, jax.tree_util.tree_map(jnp.asarray, vnp),
                          dict(to_jax(jax_np)), train=True, mutable=['batch_stats'],
                          rngs={'sampling': jax.random.PRNGKey(3),
                                'dropout': jax.random.PRNGKey(4)})
        rois, _, _, roi_valid = jax_roi.proposal_layer(
            first['batch_box_preds'], first['batch_cls_preds'], cfg.ROI_HEAD.NMS_CONFIG.TRAIN)
        gt = np.zeros((2, 10, 8), np.float32)
        for b in range(2):
            picks = np.flatnonzero(np.asarray(roi_valid[b]))[[0, 4, 8]]
            gt[b, :3, :7] = np.asarray(rois[b])[picks]
            gt[b, :3, 7] = 1
        jax_np['gt_boxes'] = gt
        torch_np['gt_boxes'] = gt
        jb = to_jax(jax_np)

        def loss_fn(params):
            out, mutated = jmodel.apply(
                {'params': params, 'batch_stats': vnp['batch_stats']}, dict(jb),
                train=True, mutable=['batch_stats'],
                rngs={'sampling': jax.random.PRNGKey(3), 'dropout': jax.random.PRNGKey(4)})
            loss, tb = jax_det.compute_training_loss(jmodel, out)
            return loss, (tb, mutated['batch_stats'], out['roi_head_ret']['rois'],
                          out['anchor_head_ret']['box_cls_labels'],
                          out['point_head_ret']['point_cls_labels'])

        params = jax.tree_util.tree_map(jnp.asarray, vnp['params'])
        (loss, (tb, stats, rois, rpn_labels, pt_labels)), grads = jgrad(loss_fn, params)
    tx = jax_optim.build_optimizer(StaticConfig(ocfg), total)
    upd, _ = tx.update(grads, tx.init(params), params)
    new_params = optax.apply_updates(params, upd)

    tmodel = torch_models.build_network(cfg, 1, ['Car'], meta, device='cpu')
    load_flax_variables(tmodel, vnp)
    step = TrainStep(tmodel, ocfg, total)
    tcfg = cfg.ROI_HEAD.TARGET_CONFIG
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch_roi, 'draw_roi_sampling',
                   lambda b, r, n, gen, dev: jax_sampling_draws(SAMPLING_KEY, b, r, n))
        tloss, tterms, tout = step.forward_loss(batch_to_torch(torch_np, 'cpu'))
    step.backward(tloss)
    tgrads = flax_variables(tmodel, grads=True)
    tstats = flax_variables(tmodel)['batch_stats']
    grad_norm = step.update()
    lr0 = float(jax_optim.one_cycle_lr_schedule(
        float(ocfg.LR), float(ocfg.DIV_FACTOR), float(ocfg.PCT_START), total)(0))
    return {'tb': tb, 'loss': loss, 'grads': flat_paths(grads),
            'params0': flat_paths(vnp['params']), 'lr0': lr0,
            'weight_decay': float(ocfg.WEIGHT_DECAY),
            'stats': flat_paths(stats), 'params': flat_paths(new_params),
            'rois': rois, 'rpn_labels': rpn_labels, 'pt_labels': pt_labels,
            'ttb': tterms, 'tloss': tloss, 'tgrads': flat_paths(tgrads['params']),
            'tstats': flat_paths(tstats), 'tparams': flat_paths(flax_variables(tmodel)['params']),
            'tout': tout, 'grad_norm': grad_norm,
            'ref_grad_norm': optax.global_norm(grads)}


def test_train_step_targets_match_jax(train_step):
    s = train_step
    assert_equal(s['tout']['anchor_head_ret']['box_cls_labels'], s['rpn_labels'])
    assert_equal(s['tout']['point_head_ret']['point_cls_labels'], s['pt_labels'])
    assert_close(s['tout']['roi_head_ret']['rois'], s['rois'])
    assert (np.asarray(s['rpn_labels']) > 0).any()


def test_train_step_losses_match_jax(train_step):
    s = train_step
    assert sorted(s['ttb']) == sorted(s['tb'])
    for k, v in s['tb'].items():
        np.testing.assert_allclose(float(s['ttb'][k].detach()), float(v), rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(float(s['tloss'].detach()), float(s['loss']), rtol=1e-4)
    np.testing.assert_allclose(float(s['grad_norm']), float(s['ref_grad_norm']), rtol=1e-4)
    for k in ('rpn_loss_cls', 'rpn_loss_loc', 'point_loss_cls', 'rcnn_loss_cls',
              'rcnn_loss_reg', 'rcnn_loss_corner'):
        assert float(s['tb'][k]) > 0, k


def test_train_step_gradients_match_jax(train_step):
    s = train_step
    assert sorted(s['tgrads']) == sorted(s['grads'])
    for k, ref in s['grads'].items():
        if _zero_by_construction(k):
            # noise below 1e-5 of the same conv's kernel gradient, both sides
            scale = float(np.abs(s['grads'][k[:-len('bias')] + 'kernel']).max())
            assert float(np.abs(ref).max()) <= 1e-5 * scale, k
            assert float(np.abs(s['tgrads'][k]).max()) <= 1e-5 * scale, k
            continue
        close_by_max(s['tgrads'][k], ref, k)
    nonzero = sum(float(np.abs(g).max()) > 0 for g in s['grads'].values())
    assert nonzero > 0.9 * len(s['grads'])


def test_train_step_batch_stats_match_jax(train_step):
    s = train_step
    assert sorted(s['tstats']) == sorted(s['stats'])
    for k, ref in s['stats'].items():
        close_by_max(s['tstats'][k], ref, k)


def test_train_step_updated_params_match_jax(train_step):
    """Adam's first step moves a parameter by lr * (g / (|g| + 1e-8) + wd p):
    about lr * sign(g). Where |g| is within rounding noise of 0 (at most
    twice the gradient tolerance), the two sides' signs are noise, so each
    side is held to a move of at most lr there; everywhere else the updated
    parameters agree within 1e-4 * max|ref| + 1e-7."""
    s = train_step
    lr, wd = s['lr0'], s['weight_decay']
    assert sorted(s['tparams']) == sorted(s['params'])
    n_noise = n_all = 0
    for k, ref in s['params'].items():
        got, g, p0 = s['tparams'][k], s['grads'][k], s['params0'][k]
        noise = np.abs(g) <= 2 * (1e-4 * np.abs(g).max() + 1e-7)
        if _zero_by_construction(k):
            noise[:] = True
        close_by_max(np.where(noise, 0.0, got), np.where(noise, 0.0, ref), k)
        for side in (got, ref):
            step = np.abs(side - p0 + lr * wd * p0)[noise]
            assert not step.size or float(step.max()) <= lr * (1 + 1e-4), k
        n_noise += int(noise.sum())
        n_all += noise.size
    assert n_noise < 0.02 * n_all, (n_noise, n_all)
