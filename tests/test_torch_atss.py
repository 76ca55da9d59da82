"""The port's ATSS target assigner (``atss_assign_targets_single`` and
``AnchorHeadSingle``'s dispatch on ``TARGET_ASSIGNER_CONFIG.NAME``) against
the JAX package's, on the CPU: seeded anchors and gt with exact distance
ties at the top-k boundary, gt rows with fewer than ``TOPK`` positives,
padded gt rows, two gt rows that share their best anchor, and
``MATCH_HEIGHT`` both ways; then one train step of the tiny SECOND with the
ATSS assigner (``tests/test_model_zoo.py::test_atss_assigner_second``'s
config) from JAX's weights.

Tolerances: labels and regression weights identical; regression targets
within 1e-6 absolute (the same f32 encode); loss terms within rtol 1e-4;
every gradient within 1e-4 max|ref| + 1e-7 by flax path."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fv2p_tpu.models.dense_heads import anchor_head as jax_anchor_head
from fv2p_tpu.models.detectors import detector3d_template as jax_det
from fv2p_tpu.utils import box_coder_utils as jax_box_coder_utils
from tests.jitu import jgrad
from tests.test_model_zoo import SECOND_CFG
from tests.test_torch_model import assert_equal
from tests.test_torch_train import close_by_max, flat_paths
from tests.test_torch_zoo import compact_batch, jax_setup, torch_model

import fv2p_torch.models as torch_models
from fv2p_torch.config import EasyDict
from fv2p_torch.datasets import dataset_meta_from_cfg
from fv2p_torch.models.dense_heads import anchor_head
from fv2p_torch.models.detectors.detector3d_template import compute_training_loss
from fv2p_torch.utils import box_coder_utils
from fv2p_torch.utils.synthetic import batch_to_torch
from fv2p_torch.weights import flax_variables
from tests.test_mgaf_model import TINY_DATA_CFG
from tests.test_torch_model import one_torch_thread  # noqa: F401 (an autouse fixture)

TOPK = 9
# one class, two rotations: the two anchors of a location share their centre,
# so the sorted distances come in exact pairs and an odd TOPK cuts a pair
ANCHOR_CFG = [{'class_name': 'Car', 'anchor_sizes': [[3.9, 1.6, 1.56]],
               'anchor_rotations': [0, 1.57], 'anchor_bottom_heights': [-1.78],
               'feature_map_stride': 4, 'matched_threshold': 0.6,
               'unmatched_threshold': 0.45}]
PC_RANGE = (0.0, -8.0, -3.0, 16.0, 8.0, 1.0)
GRID = (64, 64, 40)


def _anchors():
    return jax_anchor_head.generate_anchors(ANCHOR_CFG, GRID, PC_RANGE).reshape(-1, 7)


def _gt(seed):
    """Eight valid gt rows (classes 1 and 2) and four padding rows: row 0
    centred on an anchor location, row 1 midway between two locations (ties
    across locations), rows 2-5 seeded, rows 6 and 7 one box twice with
    two classes (they share their best anchor; the later row must win it)."""
    rng = np.random.RandomState(seed)
    anchors = _anchors()
    gt = np.zeros((12, 8), np.float32)
    loc = anchors[2 * 137]
    gt[0] = [loc[0], loc[1], loc[2], 3.9, 1.6, 1.56, 0.2, 1]
    nxt = anchors[2 * 138]
    gt[1] = [(loc[0] + nxt[0]) / 2, nxt[1] + 3.0, loc[2], 4.2, 1.7, 1.5, -1.1, 2]
    for i in range(2, 6):
        gt[i, :3] = [rng.uniform(2, 14), rng.uniform(-6, 6), rng.uniform(-1.5, -0.5)]
        gt[i, 3:6] = [rng.uniform(0.6, 4.5), rng.uniform(0.5, 2.0), rng.uniform(1.2, 1.9)]
        gt[i, 6] = rng.uniform(-np.pi, np.pi)
        gt[i, 7] = 1 + i % 2
    gt[6] = [9.0, 2.5, -1.0, 3.8, 1.6, 1.5, 0.4, 1]
    gt[7] = gt[6]
    gt[7, 7] = 2
    return gt


@pytest.mark.parametrize('match_height', [False, True], ids=['bev', 'match_height'])
@pytest.mark.parametrize('seed', [0, 1, 2])
def test_atss_assign_targets_single_matches_jax(seed, match_height):
    anchors, gt = _anchors(), _gt(seed)
    ref = jax_anchor_head.atss_assign_targets_single(
        jnp.asarray(anchors), jnp.asarray(gt[:, :7]), jnp.asarray(gt[:, 7].astype(np.int32)),
        TOPK, jax_box_coder_utils.ResidualCoder(), match_height=match_height)
    got = anchor_head.atss_assign_targets_single(
        torch.from_numpy(anchors), torch.from_numpy(gt[:, :7]),
        torch.from_numpy(gt[:, 7].astype(np.int32)), TOPK,
        box_coder_utils.ResidualCoder(), match_height=match_height)
    labels, targets, weights = (np.asarray(x) for x in ref)
    assert got[0].dtype == torch.int32
    np.testing.assert_array_equal(got[0].numpy(), labels)
    np.testing.assert_array_equal(got[2].numpy(), weights)
    np.testing.assert_allclose(got[1].numpy(), targets, rtol=0, atol=1e-6)

    # the cases are there: a tie at the top-k boundary, gt rows with fewer
    # than TOPK positives, and rows 6 and 7 on one anchor, won by row 7
    dist = np.linalg.norm(anchors[:, None, :3] - gt[None, :8, :3], axis=-1)
    srt = np.sort(dist, axis=0)
    assert (srt[TOPK - 1] == srt[TOPK]).all()
    per_gt = [(labels > 0)[np.argsort(dist[:, j], kind='stable')[:TOPK]].sum()
              for j in range(8)]
    assert min(per_gt) < TOPK
    forced = int(np.argmax(np.asarray(jax_iou(anchors, gt, match_height))[:, 6]))
    assert labels[forced] == 2


def jax_iou(anchors, gt, match_height):
    from fv2p_tpu.utils import iou3d as jax_iou3d
    fn = jax_iou3d.boxes_iou3d if match_height else jax_iou3d.boxes_iou_bev
    return fn(jnp.asarray(anchors), jnp.asarray(gt[:, :7]))


def _atss_cfg(name='ATSSTargetAssigner'):
    cfg = EasyDict(copy.deepcopy(dict(SECOND_CFG)))
    cfg.DENSE_HEAD['TARGET_ASSIGNER_CONFIG'] = {
        'NAME': name, 'TOPK': TOPK, 'MATCH_HEIGHT': False, 'BOX_CODER': 'ResidualCoder'}
    return cfg


def test_unknown_assigner_raises():
    """A NAME the head does not know raises at build time; it does not fall
    back to the axis-aligned assigner."""
    meta = dataset_meta_from_cfg(TINY_DATA_CFG, 'train')
    with pytest.raises(NotImplementedError, match='NoSuchAssigner'):
        torch_models.build_network(_atss_cfg('NoSuchAssigner'), 1, ['Car'], meta,
                                   device='cpu')


@pytest.fixture(scope='module')
def atss_step():
    """One train step of the tiny SECOND with the ATSS assigner, JAX's and
    the port's from the same weights and batch (two valid gt rows a scan,
    eight padding rows)."""
    cfg = _atss_cfg()
    batch_np, meta = compact_batch()
    jmodel, jb, vnp = jax_setup(cfg, ['Car'], batch_np, meta)

    def loss_fn(params):
        o, _ = jmodel.apply({'params': params, 'batch_stats': vnp['batch_stats']},
                            dict(jb), train=True, mutable=['batch_stats'])
        loss, tb = jax_det.compute_training_loss(jmodel, o)
        return loss, (tb, o['anchor_head_ret'])

    (loss, (tb, ret)), grads = jgrad(loss_fn, jax.tree_util.tree_map(jnp.asarray,
                                                                     vnp['params']))
    tmodel = torch_model(cfg, ['Car'], meta, vnp).train()
    assert tmodel.dense_head.assigner == 'ATSSTargetAssigner'
    tout = tmodel(batch_to_torch(batch_np, 'cpu'))
    tloss, tterms = compute_training_loss(tmodel, tout)
    tloss.backward()
    return {'loss': loss, 'tb': tb, 'ret': ret, 'grads': flat_paths(grads),
            'tloss': tloss, 'ttb': tterms, 'tret': tout['anchor_head_ret'],
            'tgrads': flat_paths(flax_variables(tmodel, grads=True)['params'])}


def test_atss_train_targets_match_jax(atss_step):
    s = atss_step
    assert_equal(s['tret']['box_cls_labels'], s['ret']['box_cls_labels'])
    assert_equal(s['tret']['reg_weights'], s['ret']['reg_weights'])
    np.testing.assert_allclose(s['tret']['box_reg_targets'].numpy(),
                               np.asarray(s['ret']['box_reg_targets']), rtol=0, atol=1e-6)
    labels = np.asarray(s['ret']['box_cls_labels'])
    assert (labels > 0).sum(axis=1).min() >= 2        # both gt cars of each scan


def test_atss_train_losses_match_jax(atss_step):
    s = atss_step
    assert sorted(s['ttb']) == sorted(s['tb'])
    for k, v in s['tb'].items():
        np.testing.assert_allclose(float(s['ttb'][k].detach()), float(v), rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(float(s['tloss'].detach()), float(s['loss']), rtol=1e-4)


def test_atss_train_gradients_match_jax(atss_step):
    s = atss_step
    assert sorted(s['tgrads']) == sorted(s['grads'])
    for k, ref in s['grads'].items():
        close_by_max(s['tgrads'][k], ref, k)
