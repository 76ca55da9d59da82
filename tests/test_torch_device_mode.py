"""FV2P and MGAF-3DSSD with device-built rulebooks, the port against the
JAX package on the CPU.

Without a ``rulebooks`` key in the batch both packages build the sparse
tables in the forward from the voxels as the loader leaves them
(unsorted): every level is one batch-flat array, and FV2P's decoder
searches each level for every sample with the other samples' rows masked
(``residual_v2p_decoder.py:69-75``, kernel B3's batch-mixed call site).
The tiny models of ``tests/test_fv2p_model.py`` and
``tests/test_mgaf_model.py`` run from the same flax variables and batch:
eval forwards end to end, and one FV2P train step (loss terms and
gradients, the inverse tables carrying its backward).

The tiny batch's random voxels dilate more than lidar surfaces: at the
derived batch-flat capacities (``level_capacities(B * cap)``) JAX's
x_conv3 drops rows, and JAX then builds x_conv4 from the occupancy bits of
the rows it dropped too, which the port does not copy (it raises where it
would drop, ``tests/test_torch_rulebook.py``). So the models here set
``LEVEL_CAPACITIES`` that hold the whole batch in both packages (JAX reads
them for the batch, the port for each sample), and the levels are compared
on their valid rows, which come first in both.

Tolerances as ``tests/test_torch_model.py`` (eval, rtol 1e-4; integers
exact) and ``tests/test_torch_train.py`` (loss terms rtol 1e-4, gradients
within 1e-4 max|ref| + 1e-7), with an absolute floor of 1e-7 on the loss
terms as on the gradients: with the gt placed on proposals the RCNN corner
loss is ~2e-4, and its last digits round differently in the two packages.

The train step runs on the tiny batch of seed 1 (``TRAIN_SEED``). On seed
0's batch one pre-activation of ``decode_x_conv3``'s ReLU lies 1e-6 from
zero: there the port's own host and device layouts of the same arithmetic
(the rows summed in another order) flip that gate apart and part by 1.4%
of the decoder's x_conv3 and x_conv4 gradients, so at that knife edge
neither package is wrong and the comparison says nothing.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fv2p_tpu.models import build_network as jax_build_network
from fv2p_tpu.models.detectors import detector3d_template as jax_det
from fv2p_tpu.models.roi_heads import iouguided_roi_head as jax_roi
from fv2p_tpu.ops import pointops as jax_pointops
from fv2p_tpu.ops.pallas.three_nn import three_nn_pallas
from tests.jitu import japply, jgrad, jinit
from tests.test_fv2p_model import make_fv2p_batch
from tests.test_mgaf_model import TINY_MODEL_CFG as TINY_MGAF_CFG
from tests.test_torch_dcn import perturb_offset_conv
from tests.test_torch_model import (_three_nn_interpolate_pallas, assert_close,
                                    assert_equal, perturb_bn)
from tests.test_torch_train import (SAMPLING_KEY, _train_cfg, _zero_by_construction,
                                    close_by_max, flat_paths, jax_sampling_draws)

import fv2p_torch.models as torch_models
from fv2p_torch.models.roi_heads import iouguided_roi_head as torch_roi
from fv2p_torch.ops import pointops
from fv2p_torch.train_utils.train_state import TrainStep
from fv2p_torch.utils.synthetic import batch_to_torch
from fv2p_torch.weights import flax_variables, load_flax_variables
from tests.test_torch_model import one_torch_thread  # noqa: F401 (an autouse fixture)

LEVELS = ('x_conv1', 'x_conv2', 'x_conv3', 'x_conv4')
TRAIN_SEED = 1
ROOMY_CAPS = {'x_conv2': 1200, 'x_conv3': 1200, 'x_conv4': 1200, 'out': 1200}


def roomy(cfg):
    """A copy of a tiny config whose level capacities hold the whole batch."""
    cfg = copy.deepcopy(cfg)
    cfg.BACKBONE_3D.LEVEL_CAPACITIES = dict(ROOMY_CAPS)
    return cfg


def device_batch(seed=0):
    """The tiny FV2P batch as the loader leaves it in device mode: voxels
    unsorted, no rulebooks. Returns (numpy batch, meta)."""
    batch, meta = make_fv2p_batch(seed=seed)
    return {k: np.asarray(v) for k, v in batch.items()}, meta


def _init(jmodel, batch_np):
    variables = jinit(jmodel, {'params': jax.random.PRNGKey(0),
                               'sampling': jax.random.PRNGKey(1),
                               'dropout': jax.random.PRNGKey(2)},
                      {k: jnp.asarray(v) for k, v in batch_np.items()})
    return perturb_bn(jax.tree_util.tree_map(np.asarray, dict(variables)),
                      np.random.RandomState(0))


@pytest.fixture(scope='module')
def fv2p_eval():
    from tests.test_fv2p_model import TINY_FV2P_CFG
    cfg = roomy(TINY_FV2P_CFG)
    batch_np, meta = device_batch()
    batch_np.pop('gt_boxes')
    jmodel = jax_build_network(cfg, num_class=1, class_names=['Car'],
                               dataset_meta=meta)
    vnp = _init(jmodel, batch_np)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_pointops, 'three_nn_interpolate', _three_nn_interpolate_pallas)
        out = japply(jmodel, jax.tree_util.tree_map(jnp.asarray, vnp),
                     {k: jnp.asarray(v) for k, v in batch_np.items()})
    tmodel = torch_models.build_network(cfg, 1, ['Car'], meta, device='cpu')
    load_flax_variables(tmodel, vnp)
    tout = tmodel(batch_to_torch(batch_np, 'cpu'))
    return out, tout


def test_fv2p_device_levels_match_jax(fv2p_eval):
    """Every sparse level: batch-flat, the same keys in the same rows, the
    same features; nothing dropped (JAX's capacity is the yaml's number,
    the port's that number a sample)."""
    out, tout = fv2p_eval
    levels = [(out['multi_scale_3d_features'][lvl], tout['multi_scale_3d_features'][lvl])
              for lvl in LEVELS]
    levels.append((out['encoded_spconv_tensor'], tout['encoded_spconv_tensor']))
    for ref, got in levels:
        assert got.sample_cap == 0 and ref.sample_cap == 0
        rv = np.asarray(ref.valid_mask())
        n = int(rv.sum())
        assert rv[:n].all() and not rv[n:].any() and n < len(rv)
        assert_equal(got.valid_mask()[:n], rv[:n])
        assert int(got.valid_mask().sum()) == n
        assert_equal(got.keys[:n], np.asarray(ref.keys)[:n].astype(np.int64))
        assert_close(got.features[:n], np.asarray(ref.features)[:n])
    assert tout['rulebook_overflow'].tolist() == [0, 0, 0, 0]


def test_fv2p_device_decoder_matches_jax(fv2p_eval):
    """The decoder's batch-mixed levels: keypoints and point features."""
    out, tout = fv2p_eval
    assert_equal(tout['point_coords'], out['point_coords'])
    assert_close(tout['point_features'], out['point_features'])


def test_fv2p_device_predictions_match_jax(fv2p_eval):
    out, tout = fv2p_eval
    for key in ('batch_cls_preds', 'batch_box_preds', 'batch_iouscore_preds'):
        assert_close(tout[key], out[key])
    assert_equal(tout['pred_valid'], out['pred_valid'])
    assert_equal(tout['pred_labels'], out['pred_labels'])
    assert_close(tout['pred_boxes'], out['pred_boxes'])
    assert_close(tout['pred_scores'], out['pred_scores'])
    assert np.asarray(out['pred_valid']).sum() > 0


def test_batch_mixed_three_nn_matches_masked_vmap():
    """B3 on a batch-flat level: the whole level for every sample, other
    samples' rows masked, against JAX's vmap of the masked Pallas search
    (interpret mode). Duplicate centers make distance ties; the indices
    (rows of the level) must agree, the lower row first, and so must the
    interpolated features."""
    rng = np.random.RandomState(4)
    b, n, m = 3, 96, 40
    centers = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    centers[50:60] = centers[10:20]                 # ties across rows
    sample = np.sort(rng.randint(0, b, n))          # contiguous, as in key order
    valid = rng.rand(n) > 0.2
    feats = rng.randn(n, 5).astype(np.float32)
    query = rng.uniform(-2, 2, (b, m, 3)).astype(np.float32)
    own = valid[None] & (sample[None] == np.arange(b)[:, None])

    def jax_one(v, q):
        return three_nn_pallas(jnp.asarray(centers), v, q, interpret=True)

    jd, ji = jax.vmap(jax_one)(jnp.asarray(own), jnp.asarray(query))
    td, ti = pointops.three_nn(torch.from_numpy(np.broadcast_to(centers, (b, n, 3)).copy()),
                               torch.from_numpy(own), torch.from_numpy(query))
    assert_equal(ti, np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-6)
    ref = jax.vmap(lambda v, q: _three_nn_interpolate_pallas(
        jnp.asarray(centers), v, jnp.asarray(feats), q))(jnp.asarray(own), jnp.asarray(query))
    got = pointops.three_nn_interpolate_flat(
        torch.from_numpy(centers).expand(b, n, 3), torch.from_numpy(own),
        torch.from_numpy(feats), torch.from_numpy(query))
    assert_close(got, ref)


def test_mgaf_device_eval_matches_jax():
    """The tiny MGAF-3DSSD (``hm_out`` raised so that detections survive,
    as ``tests/test_torch_mgaf.py``'s hm_bias_0 variant) end to end with
    device rulebooks."""
    cfg = roomy(TINY_MGAF_CFG)
    batch_np, meta = device_batch()
    for key in ('points', 'points_valid', 'gt_boxes'):
        batch_np.pop(key)
    jmodel = jax_build_network(cfg, num_class=1, class_names=['Car'],
                               dataset_meta=meta)
    variables = jinit(jmodel, jax.random.PRNGKey(0),
                      {k: jnp.asarray(v) for k, v in batch_np.items()})
    rng = np.random.RandomState(1)
    vnp = perturb_bn(jax.tree_util.tree_map(np.asarray, dict(variables)), rng)
    vnp['params'] = perturb_offset_conv(vnp['params'], rng)
    hm_out = vnp['params']['dense_head']['hm_out']
    hm_out['bias'][:] = 0.0
    hm_out['kernel'] = np.abs(rng.randn(*hm_out['kernel'].shape)).astype(np.float32)
    out = japply(jmodel, jax.tree_util.tree_map(jnp.asarray, vnp),
                 {k: jnp.asarray(v) for k, v in batch_np.items()})
    tmodel = torch_models.build_network(cfg, 1, ['Car'], meta, device='cpu')
    load_flax_variables(tmodel, vnp)
    tout = tmodel(batch_to_torch(batch_np, 'cpu'))
    assert_close(tout['spatial_features'], out['spatial_features'])
    for key in ('batch_box_preds', 'batch_cls_preds', 'batch_iouscore_preds'):
        assert_close(tout[key], out[key])
    assert_equal(tout['pred_valid'], out['pred_valid'])
    assert_equal(tout['pred_labels'], out['pred_labels'])
    assert_close(tout['pred_boxes'], out['pred_boxes'])
    assert_close(tout['pred_scores'], out['pred_scores'])
    assert np.asarray(out['pred_valid']).sum() > 0


@pytest.fixture(scope='module')
def fv2p_train_step():
    """One tiny FV2P train step with device rulebooks, in JAX
    (value_and_grad) and in the port, from the same variables and batch,
    the RoI sampling on JAX's pinned key, gt placed on proposals as
    ``tests/test_torch_train.py`` places them."""
    cfg = roomy(_train_cfg())
    batch_np, meta = device_batch(seed=TRAIN_SEED)
    jmodel = jax_build_network(cfg, num_class=1, class_names=['Car'], dataset_meta=meta)
    vnp = _init(jmodel, batch_np)
    vnp['params']['dense_head']['conv_box']['kernel'] = (
        vnp['params']['dense_head']['conv_box']['kernel'] * 40.0)
    orig_assign = jax_roi.assign_targets
    rngs = {'sampling': jax.random.PRNGKey(3), 'dropout': jax.random.PRNGKey(4)}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_pointops, 'three_nn_interpolate', _three_nn_interpolate_pallas)
        mp.setattr(jax_roi, 'assign_targets',
                   lambda key, bd, tcfg: orig_assign(SAMPLING_KEY, bd, tcfg))
        jb = {k: jnp.asarray(v) for k, v in batch_np.items()}
        first, _ = japply(jmodel, jax.tree_util.tree_map(jnp.asarray, vnp), dict(jb),
                          train=True, mutable=['batch_stats'], rngs=rngs)
        rois, _, _, roi_valid = jax_roi.proposal_layer(
            first['batch_box_preds'], first['batch_cls_preds'], cfg.ROI_HEAD.NMS_CONFIG.TRAIN)
        gt = np.zeros((2, 10, 8), np.float32)
        for b in range(2):
            picks = np.flatnonzero(np.asarray(roi_valid[b]))[[0, 4, 8]]
            gt[b, :3, :7] = np.asarray(rois[b])[picks]
            gt[b, :3, 7] = 1
        batch_np['gt_boxes'] = gt
        jb['gt_boxes'] = jnp.asarray(gt)

        def loss_fn(params):
            out, _ = jmodel.apply({'params': params, 'batch_stats': vnp['batch_stats']},
                                  dict(jb), train=True, mutable=['batch_stats'], rngs=rngs)
            loss, tb = jax_det.compute_training_loss(jmodel, out)
            return loss, tb

        params = jax.tree_util.tree_map(jnp.asarray, vnp['params'])
        (loss, tb), grads = jgrad(loss_fn, params)

    tmodel = torch_models.build_network(cfg, 1, ['Car'], meta, device='cpu')
    load_flax_variables(tmodel, vnp)
    from tests.test_torch_train import _kitti_optim_cfg
    step = TrainStep(tmodel, _kitti_optim_cfg(), 100)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch_roi, 'draw_roi_sampling',
                   lambda b, r, n, gen, dev: jax_sampling_draws(SAMPLING_KEY, b, r, n))
        tloss, tterms, tout = step.forward_loss(batch_to_torch(batch_np, 'cpu'))
    step.backward(tloss)
    return {'tb': tb, 'loss': loss, 'grads': flat_paths(grads), 'ttb': tterms,
            'tloss': tloss, 'tout': tout,
            'tgrads': flat_paths(flax_variables(tmodel, grads=True)['params'])}


def test_fv2p_device_train_losses_match_jax(fv2p_train_step):
    s = fv2p_train_step
    assert 'rulebooks' not in s['tout'] and s['tout']['rulebook_overflow'].sum() == 0
    assert sorted(s['ttb']) == sorted(s['tb'])
    for k, v in s['tb'].items():
        np.testing.assert_allclose(float(s['ttb'][k].detach()), float(v), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_allclose(float(s['tloss'].detach()), float(s['loss']), rtol=1e-4)
    for k in ('rpn_loss_cls', 'point_loss_cls', 'rcnn_loss_cls', 'rcnn_loss_reg'):
        assert float(s['tb'][k]) > 0, k


def test_fv2p_device_train_gradients_match_jax(fv2p_train_step):
    """Every gradient, the sparse trunk's through the device inverse tables
    (the residual blocks' conv biases, whose true gradient is 0, as noise
    on both sides)."""
    s = fv2p_train_step
    assert sorted(s['tgrads']) == sorted(s['grads'])
    for k, ref in s['grads'].items():
        if _zero_by_construction(k):
            scale = float(np.abs(s['grads'][k[:-len('bias')] + 'kernel']).max())
            assert float(np.abs(ref).max()) <= 1e-5 * scale, k
            assert float(np.abs(s['tgrads'][k]).max()) <= 1e-5 * scale, k
            continue
        close_by_max(s['tgrads'][k], ref, k)
    for k in ('backbone_3d/down2/conv/kernel', 'backbone_3d/conv_out/conv/kernel'):
        assert float(np.abs(s['grads'][k]).max()) > 0, k
