"""One train step of the tiny PartA2 and PartA2_free in the PyTorch port
against the JAX package on the CPU (``tests/test_torch_parta2.py`` holds
their modules and eval forwards): the loss terms, the part and RCNN
targets, every gradient by flax path and the running statistics after the
step, from the same flax variables and host-table batch, with
``DP_RATIO`` 0 and JAX's RoI draws fed to the port.

The batch's gt boxes are the two proposals of each scan that hold the most
voxel centres (from a train forward without gt), grown by 5%, so that the
part head has foreground points and the RoI sampling foreground RoIs.

Tolerances: integers exact; loss terms rtol 1e-4; targets rtol 1e-4
(``assert_close``); gradients and statistics within 1e-4 max|ref| + 1e-7
(``close_by_max``). A residual block's conv bias feeds a train-mode
BatchNorm, so its true gradient is 0 and both sides give rounding noise:
those are held to 1e-4 of the largest gradient of the model.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fv2p_tpu.config import EasyDict as JaxEasyDict
from fv2p_tpu.models.detectors import detector3d_template as jax_det
from fv2p_tpu.models.roi_heads import iouguided_roi_head as jax_roi
from fv2p_tpu.models.roi_heads import partA2_head as jax_parta2
from fv2p_tpu.ops import pointops as jax_pointops
from tests.jitu import japply, jgrad
from tests.test_torch_model import assert_close, assert_equal, to_jax
from tests.test_torch_parta2 import CFGS, jax_setup, model_batches, torch_model
from tests.test_torch_train import SAMPLING_KEY, close_by_max, flat_paths, jax_sampling_draws

from fv2p_torch.models.detectors.detector3d_template import compute_training_loss
from fv2p_torch.models.roi_heads import pvrcnn_head as torch_roi_fc
from fv2p_torch.utils.synthetic import batch_to_torch
from fv2p_torch.weights import flax_variables
from tests.test_torch_model import one_torch_thread  # noqa: F401 (an autouse fixture)

RNGS = {'sampling': jax.random.PRNGKey(3), 'dropout': jax.random.PRNGKey(4)}


def zero_by_construction(path):
    """The conv biases of the decoder's residual blocks (``up*_t``)."""
    return path.startswith('backbone_3d/up') and '_t/conv' in path and path.endswith('/bias')


@pytest.fixture(scope='module')
def pinned_draws():
    """JAX's RoI sampling on SAMPLING_KEY whatever key its head draws, and
    the port fed the same draws."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_parta2, 'assign_targets',
                   lambda key, bd, tcfg: jax_roi.assign_targets(SAMPLING_KEY, bd, tcfg))
        mp.setattr(torch_roi_fc, 'draw_roi_sampling',
                   lambda b, r, n, gen, dev: jax_sampling_draws(SAMPLING_KEY, b, r, n))
        yield


def gt_at_proposals(cfg, jmodel, vnp, jax_np):
    """(B, 10, 8) gt: each scan's two proposals over the most voxel
    centres, grown by 5%."""
    jb = dict(to_jax(jax_np), gt_boxes=jnp.zeros((2, 10, 8), jnp.float32))
    first, _ = japply(jmodel, jax.tree_util.tree_map(jnp.asarray, vnp), jb, train=True,
                      mutable=['batch_stats'], rngs=RNGS)
    rois, _, _, roi_valid = jax_roi.proposal_layer(
        first['batch_box_preds'], first['batch_cls_preds'], cfg.ROI_HEAD.NMS_CONFIG.TRAIN)
    gt = np.zeros((2, 10, 8), np.float32)
    for b in range(2):
        cand = np.asarray(rois[b])[np.asarray(roi_valid[b])]
        pts = np.asarray(first['point_coords'][b])[np.asarray(first['point_valid'][b])]
        inside = np.asarray(jax_pointops.points_in_boxes_index(
            jnp.asarray(pts), jnp.asarray(cand), jnp.ones(len(cand), bool)))
        counts = np.bincount(inside[inside >= 0], minlength=len(cand))
        gt[b, :2, :7] = cand[np.argsort(-counts, kind='stable')[:2]]
        gt[b, :2, 3:6] *= 1.05
        gt[b, :2, 7] = 1
    return gt


@pytest.fixture(scope='module', params=sorted(CFGS))
def train_run(request, pinned_draws):
    """value_and_grad of the loss with mutable batch statistics in JAX, one
    forward and backward in the port, from the same variables and batch."""
    cfg = JaxEasyDict(copy.deepcopy(dict(CFGS[request.param])))
    cfg.ROI_HEAD.DP_RATIO = 0.0
    jax_np, torch_np, meta = model_batches('host')
    jmodel, vnp = jax_setup(cfg, jax_np, meta)
    gt = gt_at_proposals(cfg, jmodel, vnp, jax_np)
    jb = dict(to_jax(jax_np), gt_boxes=jnp.asarray(gt))

    def loss_fn(params):
        out, mutated = jmodel.apply({'params': params, 'batch_stats': vnp['batch_stats']},
                                    dict(jb), train=True, mutable=['batch_stats'], rngs=RNGS)
        loss, tb = jax_det.compute_training_loss(jmodel, out)
        keep = {'roi': out['roi_head_ret'], 'point': out['point_head_ret']}
        return loss, (tb, mutated['batch_stats'], keep)

    params = jax.tree_util.tree_map(jnp.asarray, vnp['params'])
    (loss, (tb, stats, keep)), grads = jgrad(loss_fn, params)

    tmodel = torch_model(cfg, meta, vnp).train()
    tout = tmodel(batch_to_torch(dict(torch_np, gt_boxes=gt), 'cpu'))
    tloss, tterms = compute_training_loss(tmodel, tout)
    tloss.backward()
    return {'name': request.param, 'tb': tb, 'loss': loss, 'keep': keep,
            'grads': flat_paths(grads), 'stats': flat_paths(stats),
            'ttb': tterms, 'tloss': tloss, 'tout': tout,
            'tgrads': flat_paths(flax_variables(tmodel, grads=True)['params']),
            'tstats': flat_paths(flax_variables(tmodel)['batch_stats'])}


def test_train_losses_match_jax(train_run):
    s = train_run
    assert sorted(s['ttb']) == sorted(s['tb'])
    for k, v in s['tb'].items():
        np.testing.assert_allclose(float(s['ttb'][k].detach()), float(v), rtol=1e-4,
                                   err_msg=k)
        assert np.isfinite(float(v))
    np.testing.assert_allclose(float(s['tloss'].detach()), float(s['loss']), rtol=1e-4)
    for k in ('point_loss_cls', 'point_loss_part', 'rcnn_loss_cls', 'rcnn_loss_reg',
              'rcnn_loss_corner'):
        assert float(s['tb'][k]) > 0, k
    assert ('point_loss_box' in s['tb']) == (s['name'] == 'parta2_free')


def test_train_targets_match_jax(train_run):
    """The points' labels and part locations, the sampled RoIs' classification
    labels and regression mask."""
    s = train_run
    point, roi = s['tout']['point_head_ret'], s['tout']['roi_head_ret']
    assert_equal(point['point_cls_labels'], s['keep']['point']['point_cls_labels'])
    assert_close(point['point_part_labels'], s['keep']['point']['point_part_labels'])
    assert_close(roi['rcnn_cls_labels'], s['keep']['roi']['rcnn_cls_labels'])
    assert_equal(roi['reg_valid_mask'], s['keep']['roi']['reg_valid_mask'])
    assert int(np.asarray(s['keep']['roi']['reg_valid_mask']).sum()) > 0
    assert int((np.asarray(s['keep']['point']['point_cls_labels']) > 0).sum()) > 10


def test_train_gradients_match_jax(train_run):
    s = train_run
    assert sorted(s['tgrads']) == sorted(s['grads'])
    gmax = max(float(np.abs(g).max()) for g in s['grads'].values())
    for k, ref in s['grads'].items():
        if zero_by_construction(k):
            assert float(np.abs(s['tgrads'][k]).max()) <= 1e-4 * gmax, k
            continue
        close_by_max(s['tgrads'][k], ref, k)
    nonzero = sum(float(np.abs(g).max()) > 0 for g in s['grads'].values())
    assert nonzero > 0.9 * len(s['grads'])


def test_train_batch_stats_match_jax(train_run):
    s = train_run
    assert sorted(s['tstats']) == sorted(s['stats'])
    for k, ref in s['stats'].items():
        close_by_max(s['tstats'][k], ref, k)
