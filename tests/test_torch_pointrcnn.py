"""PointRCNN in the PyTorch port against the JAX package on the CPU.

* ``PointResidualCoder`` encode and decode (per-class mean sizes and the
  raw form), ``assign_point_box_targets`` (foreground, ignore band,
  background), and ``farthest_point_sample_batch`` at the RoI head's row
  shapes (400 rows of 512 pooled points, 128 picks, then 128 -> 32), with
  rows of no valid point and rows with fewer valid points than picks.
* The tiny ``POINTRCNN_CFG`` of ``tests/test_model_zoo.py``, initialised in
  flax, BatchNorm statistics perturbed, carried across by
  ``load_flax_variables``: the eval forward (point features, proposals,
  refined boxes, detections), and one train step for the yaml's
  ``CLS_SCORE_TYPE`` ``cls`` and for ``rcnn_iou`` (loss terms, the RCNN
  classification labels, gradients, batch statistics, updated parameters)
  with JAX's RoI draws fed to the port.
* The three PointRCNN yamls build at full width with JAX's parameter
  counts; ``PartA2_free.yaml`` still raises ``NotImplementedError``.

Tolerances as the other model tests: integers exact, floats rtol 1e-4
(``assert_close``), gradients, statistics and parameters within
1e-4 max|ref| + 1e-7 (``close_by_max``), in f32.
"""
import copy
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fv2p_tpu.config import EasyDict as JaxEasyDict
from fv2p_tpu.config import StaticConfig
from fv2p_tpu.config import cfg_from_yaml_file as jax_cfg_from_yaml_file
from fv2p_tpu.datasets import dataset_meta_from_cfg as jax_meta_from_cfg
from fv2p_tpu.models import build_network as jax_build_network
from fv2p_tpu.models.dense_heads import point_head_box as jax_phb
from fv2p_tpu.models.detectors import detector3d_template as jax_det
from fv2p_tpu.models.roi_heads import iouguided_roi_head as jax_roi
from fv2p_tpu.models.roi_heads import pointrcnn_head as jax_prcnn
from fv2p_tpu.ops import pointops as jax_pointops
from fv2p_tpu.train_utils import optimization as jax_optim
from fv2p_tpu.utils import box_coder_utils as jax_coders
from tests.jitu import japply, jgrad, jinit
from tests.test_fv2p_model import make_fv2p_batch
from tests.test_model_zoo import POINTRCNN_CFG
from tests.test_torch_model import assert_close, assert_equal, perturb_bn
from tests.test_torch_train import (SAMPLING_KEY, _kitti_optim_cfg, close_by_max,
                                    flat_paths, jax_sampling_draws)

import fv2p_torch.models as torch_models
from fv2p_torch.config import EasyDict, cfg_from_yaml_file
from fv2p_torch.datasets import dataset_meta_from_cfg
from fv2p_torch.models.dense_heads.point_head_box import assign_point_box_targets
from fv2p_torch.models.roi_heads import pointrcnn_head as torch_prcnn
from fv2p_torch.ops import pointops
from fv2p_torch.train_utils.train_state import TrainStep
from fv2p_torch.utils import box_coder_utils
from fv2p_torch.utils.synthetic import batch_to_torch
from fv2p_torch.weights import flax_variables, load_flax_variables

REPO = Path(__file__).resolve().parent.parent
MEAN_SIZE = [[3.9, 1.6, 1.56], [0.8, 0.6, 1.73], [1.76, 0.6, 1.73]]
# The weights of the train step. Under weight seed 0 one pre-activation of
# the point head's cls_bn0 lies 3e-6 from 0, on opposite sides in the two
# packages (f32 rounding; the port in f64 agrees with the port in f32), and
# the ReLU's knife edge moves the backbone's gradients past 1e-4 of their
# max, as the device train step of tests/test_torch_device_mode.py meets.
TRAIN_SEED = 1
YAMLS = ('kitti_models/pointrcnn.yaml', 'kitti_models/pointrcnn_iou.yaml',
         'kitti_models/pointrcnn_iou_car.yaml')


def t(x):
    return torch.from_numpy(np.array(x))


def rand_boxes(rng, n):
    return np.concatenate([rng.uniform(-4, 4, (n, 2)), rng.uniform(-1.5, 0, (n, 1)),
                           rng.uniform(0.5, 4.5, (n, 3)), rng.uniform(-np.pi, np.pi, (n, 1))],
                          1).astype(np.float32)


# ------------------------------------------------------------ building blocks

@pytest.mark.parametrize('use_mean_size', [True, False])
def test_point_residual_coder_matches_jax(use_mean_size):
    rng = np.random.RandomState(3)
    n = 64
    boxes = rand_boxes(rng, n)
    boxes[:5, 3:6] = 0.0                             # clamped to 1e-5 on both sides
    points = (boxes[:, :3] + rng.uniform(-1, 1, (n, 3))).astype(np.float32)
    classes = rng.randint(1, 4, n).astype(np.int32)
    kw = {'use_mean_size': use_mean_size, 'mean_size': MEAN_SIZE}
    jc, tc = jax_coders.PointResidualCoder(**kw), box_coder_utils.PointResidualCoder(**kw)
    ref = np.asarray(jc.encode(jnp.asarray(boxes), jnp.asarray(points), jnp.asarray(classes)))
    got = tc.encode(t(boxes), t(points), t(classes))
    assert_close(got, ref)
    codes = rng.randn(2, n // 2, 8).astype(np.float32) * 0.5
    pts = points.reshape(2, n // 2, 3)
    cls = classes.reshape(2, n // 2)
    ref = np.asarray(jc.decode(jnp.asarray(codes), jnp.asarray(pts), jnp.asarray(cls)))
    assert_close(tc.decode(t(codes), t(pts), t(cls)), ref)


def test_point_residual_coder_refuses_nonpositive_mean_size():
    with pytest.raises(ValueError, match='mean_size'):
        box_coder_utils.PointResidualCoder(mean_size=[[1.0, 0.0, 1.0]])


def test_assign_point_box_targets_matches_jax():
    """Two scans of 300 points around three boxes: a third inside, a third
    0.1 m past a face (inside the boxes grown by 0.5 m: ignore), a third
    1 m past a face; padding gt rows."""
    rng = np.random.RandomState(5)
    gt = np.zeros((2, 4, 8), np.float32)
    pts = np.zeros((2, 300, 3), np.float32)
    for b in range(2):
        boxes = rand_boxes(rng, 3)
        boxes[:, 0] = [-6.0, 0.0, 6.0]
        gt[b, :3, :7] = boxes
        gt[b, :3, 7] = [1, 2, 3]
        for j, beyond in enumerate((None, 0.1, 1.0)):
            box = boxes[rng.randint(0, 3, 100)]
            local = rng.uniform(-0.45, 0.45, (100, 3)) * box[:, 3:6]
            if beyond is not None:                 # past one face, by `beyond` m
                axis = rng.randint(0, 3, 100)
                face = box[np.arange(100), 3 + axis] / 2 + beyond
                local[np.arange(100), axis] = np.where(rng.rand(100) < 0.5, -face, face)
            c, s = np.cos(box[:, 6]), np.sin(box[:, 6])
            rot = np.stack([local[:, 0] * c - local[:, 1] * s,
                            local[:, 0] * s + local[:, 1] * c, local[:, 2]], 1)
            pts[b, j * 100:(j + 1) * 100] = box[:, :3] + rot
    gt[1, 3] = 0.0
    kw = {'use_mean_size': True, 'mean_size': MEAN_SIZE}
    extra = (0.5, 0.5, 0.5)
    ref_l, ref_b = jax_phb.assign_point_box_targets(
        jnp.asarray(pts), jnp.asarray(gt), extra, 3, jax_coders.PointResidualCoder(**kw))
    got_l, got_b = assign_point_box_targets(t(pts), t(gt), extra,
                                            box_coder_utils.PointResidualCoder(**kw))
    assert_equal(got_l, ref_l)
    assert_close(got_b, ref_b)
    labels = np.asarray(ref_l)
    assert (labels > 0).sum() > 50 and (labels == -1).sum() > 20 and (labels == 0).sum() > 50
    assert set(labels[labels > 0].tolist()) == {1, 2, 3}


@pytest.mark.parametrize('rows,n,k', [(400, 512, 128), (512, 128, 32)])
def test_fps_at_roi_head_row_shapes_matches_jax(rows, n, k):
    """The RoI head's SA encoder rows: pooled points of one RoI each, some
    rows of empty RoIs (no valid point: every pick is index 0), some with
    fewer valid points than picks (wrapped around), ties from repeated
    points (the pooling repeats a RoI's points when it holds fewer than
    it samples)."""
    rng = np.random.RandomState(rows)
    pts = rng.randn(rows, n, 3).astype(np.float32)
    reps = rng.randint(1, n, rows)
    pts[::5] = pts[::5, :n // 8].repeat(8, axis=1)           # every point eight times
    valid = np.ones((rows, n), bool)
    valid[1::7] = False                                     # empty RoIs
    for r in range(3, rows, 11):
        valid[r, reps[r] % k:] = False                      # fewer valid than picks
    ref = np.asarray(jax_pointops.farthest_point_sample_batch(
        jnp.asarray(pts), jnp.asarray(valid), k))
    got = pointops.farthest_point_sample_batch(t(pts), t(valid), k)
    assert_equal(got, ref)
    assert (ref[1::7] == 0).all()


# ----------------------------------------------------------------- models

def jax_setup(cfg, batch_np, meta, seed=0):
    """The flax model, its batch and its perturbed variables (numpy)."""
    jmodel = jax_build_network(cfg, num_class=1, class_names=['Car'], dataset_meta=meta)
    jb = {k: jnp.asarray(v) for k, v in batch_np.items()}
    variables = jinit(jmodel, {'params': jax.random.PRNGKey(seed),
                               'sampling': jax.random.PRNGKey(1),
                               'dropout': jax.random.PRNGKey(2)},
                      {k: v for k, v in jb.items() if k != 'gt_boxes'})
    vnp = perturb_bn(jax.tree_util.tree_map(np.asarray, dict(variables)),
                     np.random.RandomState(seed))
    return jmodel, jb, vnp


def torch_model(cfg, meta, vnp):
    return load_flax_variables(torch_models.build_network(cfg, 1, ['Car'], meta,
                                                          device='cpu'), vnp)


def tiny_batch():
    batch, meta = make_fv2p_batch(batch_size=2, n_cap=128)
    return {k: np.asarray(batch[k]) for k in ('points', 'points_valid')}, meta


@functools.lru_cache(maxsize=None)
def eval_run():
    batch_np, meta = tiny_batch()
    jmodel, jb, vnp = jax_setup(POINTRCNN_CFG, batch_np, meta)
    out = japply(jmodel, jax.tree_util.tree_map(jnp.asarray, vnp), dict(jb))
    tout = torch_model(POINTRCNN_CFG, meta, vnp)(batch_to_torch(batch_np, 'cpu'))
    return out, tout


def test_eval_point_features_and_proposals_match_jax():
    out, tout = eval_run()
    assert_equal(tout['point_coords'], out['point_coords'])
    for key in ('point_features', 'point_cls_scores', 'rois', 'roi_scores'):
        assert_close(tout[key], out[key])
    assert_equal(tout['roi_valid'], out['roi_valid'])
    assert_equal(tout['roi_labels'], out['roi_labels'])
    assert float(np.abs(np.asarray(out['point_features'])).max()) > 0


def test_eval_detections_match_jax():
    """The RoI head's refined boxes and logits, then cls-score NMS."""
    out, tout = eval_run()
    for key in ('batch_cls_preds', 'batch_box_preds'):
        assert_close(tout[key], out[key])
    assert_equal(tout['pred_valid'], out['pred_valid'])
    assert_equal(tout['pred_labels'], out['pred_labels'])
    valid = np.asarray(out['pred_valid'])
    assert_close(tout['pred_boxes'][t(valid)], np.asarray(out['pred_boxes'])[valid])
    assert_close(tout['pred_scores'], out['pred_scores'])
    assert valid.sum() > 4


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


# ------------------------------------------------------------------ yamls

def _jax_param_count(path):
    cfg = JaxEasyDict()
    jax_cfg_from_yaml_file(str(path), cfg)
    meta = jax_meta_from_cfg(cfg.DATA_CONFIG, 'test')
    jmodel = jax_build_network(cfg.MODEL, num_class=len(cfg.CLASS_NAMES),
                               class_names=cfg.CLASS_NAMES, dataset_meta=meta)
    batch = {'points': jax.ShapeDtypeStruct((1, 256, 4), jnp.float32),
             'points_valid': jax.ShapeDtypeStruct((1, 256), jnp.bool_)}
    shapes = jax.eval_shape(lambda b: jmodel.init(jax.random.PRNGKey(0), b), batch)
    return sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes['params']))


@pytest.mark.parametrize('yaml_path', YAMLS)
def test_pointrcnn_yaml_builds_at_full_width(yaml_path):
    path = REPO / 'tools/cfgs' / yaml_path
    cfg = EasyDict()
    cfg_from_yaml_file(str(path), cfg)
    meta = dataset_meta_from_cfg(cfg.DATA_CONFIG, 'test')
    model = torch_models.build_network(cfg.MODEL, len(cfg.CLASS_NAMES), cfg.CLASS_NAMES,
                                       meta, device='cpu')
    assert type(model).__name__ == 'PointRCNN'
    assert model.backbone_3d.num_point_features == 128
    assert sum(p.numel() for p in model.parameters()) == _jax_param_count(path)


def test_parta2_free_yaml_still_raises():
    """PointRCNN's detector over PartA2's UNetV2 backbone and part head:
    those belong with PartA2 (ROADMAP.md, queue A)."""
    cfg = EasyDict()
    cfg_from_yaml_file(str(REPO / 'tools/cfgs/kitti_models/PartA2_free.yaml'), cfg)
    meta = dataset_meta_from_cfg(cfg.DATA_CONFIG, 'test')
    with pytest.raises(NotImplementedError, match='UNetV2 is not in fv2p_torch'):
        torch_models.build_network(cfg.MODEL, len(cfg.CLASS_NAMES), cfg.CLASS_NAMES, meta,
                                   device='cpu')
