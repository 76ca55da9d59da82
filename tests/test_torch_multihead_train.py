"""One train step of the three tiny multihead models of
``tests/test_torch_multihead.py`` (which holds their eval forwards) in the
PyTorch port against the JAX package on the CPU: targets, loss terms,
gradients and the parameters after one ``adam_onecycle`` update.

Tolerances as ``tests/test_torch_multihead.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from fv2p_tpu.config import StaticConfig
from fv2p_tpu.models.detectors import detector3d_template as jax_det
from fv2p_tpu.train_utils import optimization as jax_optim
from tests.jitu import jgrad
from tests.test_torch_model import assert_close, assert_equal
from tests.test_torch_train import _zero_by_construction, close_by_max, flat_paths

from fv2p_torch.train_utils.train_state import TrainStep
from fv2p_torch.utils.synthetic import batch_to_torch
from fv2p_torch.weights import flax_variables

from tests.test_torch_multihead import (  # noqa: F401 (case: a fixture)
    OPTIM, TOTAL_STEPS, _torch_model, case)
from tests.test_torch_model import one_torch_thread  # noqa: F401 (an autouse fixture)


@pytest.fixture(scope='module')
def train_run(case):
    """One train step in both packages from the same variables: the loss
    and gradients, then one adam_onecycle update. With a pillar encoder the
    reference gradients are JAX's eager ones (``tests/test_torch_zoo.py``
    says why: ties of the PFN max among exact zeros move under jit)."""
    name, cfg, batch_np, jmodel, jb, vnp, meta = case
    tmodel = _torch_model(cfg, meta, vnp)

    def loss_fn(params):
        o, _ = jmodel.apply({'params': params, 'batch_stats': vnp['batch_stats']},
                            dict(jb), train=True, mutable=['batch_stats'])
        loss, tb = jax_det.compute_training_loss(jmodel, o)
        return loss, (tb, o['anchor_head_ret']['box_cls_labels'],
                      o['anchor_head_ret']['box_reg_targets'])

    params = jax.tree_util.tree_map(jnp.asarray, vnp['params'])
    if name.startswith('pillar'):
        (loss, (tb, labels, targets)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
    else:
        (loss, (tb, labels, targets)), grads = jgrad(loss_fn, params)
    tx = jax_optim.build_optimizer(StaticConfig(OPTIM), TOTAL_STEPS)
    upd, _ = tx.update(grads, tx.init(params), params)
    new_params = optax.apply_updates(params, upd)

    step = TrainStep(tmodel, OPTIM, TOTAL_STEPS)
    tloss, tterms, tout = step.forward_loss(batch_to_torch(batch_np, 'cpu'))
    step.backward(tloss)
    tgrads = flat_paths(flax_variables(tmodel, grads=True)['params'])
    step.update()
    lr0 = float(jax_optim.one_cycle_lr_schedule(
        float(OPTIM.LR), float(OPTIM.DIV_FACTOR), float(OPTIM.PCT_START), TOTAL_STEPS)(0))
    return {'tb': tb, 'loss': loss, 'labels': labels, 'targets': targets,
            'grads': flat_paths(grads), 'params': flat_paths(new_params),
            'params0': flat_paths(vnp['params']), 'lr0': lr0,
            'ttb': tterms, 'tloss': tloss, 'tout': tout, 'tgrads': tgrads,
            'tparams': flat_paths(flax_variables(tmodel)['params'])}


def test_train_targets_and_losses_match_jax(train_run):
    s = train_run
    tret = s['tout']['anchor_head_ret']
    assert_equal(tret['box_cls_labels'], s['labels'])
    assert_close(tret['box_reg_targets'], s['targets'])
    labels = np.asarray(s['labels'])
    assert len(set(labels[labels > 0].tolist())) == 3
    assert sorted(s['ttb']) == sorted(s['tb'])
    for k, v in s['tb'].items():
        np.testing.assert_allclose(float(s['ttb'][k].detach()), float(v), rtol=1e-4, err_msg=k)
        assert float(v) > 0, k
    np.testing.assert_allclose(float(s['tloss'].detach()), float(s['loss']), rtol=1e-4)


def test_train_gradients_match_jax(train_run):
    s = train_run
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


def test_train_updated_params_match_jax(train_run):
    s = train_run
    lr, wd = s['lr0'], float(OPTIM.WEIGHT_DECAY)
    assert sorted(s['tparams']) == sorted(s['params'])
    n_noise = n_all = 0
    for k, ref in s['params'].items():
        got, g, p0 = s['tparams'][k], np.asarray(s['grads'][k]), s['params0'][k]
        # an exact 0 is no noise: Adam then moves a parameter by its decay alone
        noise = (np.abs(g) <= 2 * (1e-4 * np.abs(g).max() + 1e-7)) & (g != 0)
        if _zero_by_construction(k):
            noise[:] = True
        close_by_max(np.where(noise, 0.0, got), np.where(noise, 0.0, np.asarray(ref)), k)
        for side in (got, np.asarray(ref)):
            step = np.abs(side - p0 + lr * wd * p0)[noise]
            assert not step.size or float(step.max()) <= lr * (1 + 1e-4), k
        n_noise += int(noise.sum())
        n_all += noise.size
    assert n_noise < 0.02 * n_all, (n_noise, n_all)


# ------------------------------------------------------------- full width
