"""The PyTorch port of FV2P training against the JAX package on the CPU.

Module by module (losses, the box encode, anchor, point and RoI targets,
the 3D IoU, both BatchNorms in training, the sparse conv's backward, the
optimizer), then one whole train step of the tiny FV2P (``TINY_FV2P_CFG``
with ``DP_RATIO`` 0) from the same flax variables and the same batch: the
loss terms, every gradient, the batch statistics after the step and the
parameters after the optimizer step, compared by flax path.

The RoI sampling draws its random numbers in the model. JAX's come from
``jax.random`` and the port's from a ``torch.Generator``, so the tests pin
JAX's key (a monkeypatch of ``iouguided_roi_head.assign_targets``) and feed
the port JAX's own draws (a monkeypatch of ``draw_roi_sampling``).

Tolerances: integer outputs (labels, sampled indices, masks) are exact;
losses and targets rtol 1e-4 (``assert_close`` of ``test_torch_model``);
gradients, batch statistics and updated parameters within
``1e-4 * max|ref| + 1e-7`` per tensor; the optimizer alone, given the same
gradients, rtol 1e-6.
"""
import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import flax.linen as fnn

from fv2p_tpu.config import StaticConfig
from fv2p_tpu.models import build_network as jax_build_network
from fv2p_tpu.models.detectors import detector3d_template as jax_det
from fv2p_tpu.models.dense_heads import anchor_head as jax_anchor
from fv2p_tpu.models.dense_heads import point_head_simple as jax_point
from fv2p_tpu.models.roi_heads import iouguided_roi_head as jax_roi
from fv2p_tpu.ops import pointops as jax_pointops
from fv2p_tpu.ops.sparse import conv as jax_conv
from fv2p_tpu.ops.sparse import host_rulebook as jax_host_rulebook
from fv2p_tpu.train_utils import optimization as jax_optim
from fv2p_tpu.utils import box_coder_utils as jax_coder
from fv2p_tpu.utils import iou3d as jax_iou3d
from fv2p_tpu.utils import loss_utils as jax_loss
from tests.jitu import japply, jgrad, jinit
from tests.test_fv2p_model import TINY_FV2P_CFG
from tests.test_torch_model import (_three_nn_interpolate_pallas, assert_close,
                                    assert_equal, make_rulebook_batches,
                                    perturb_bn, t, to_jax)

import fv2p_torch.models as torch_models
from fv2p_torch.config import EasyDict, cfg_from_yaml_file
from fv2p_torch.datasets import dataset_meta_from_cfg
from fv2p_torch.models import layers
from fv2p_torch.models.dense_heads import anchor_head as torch_anchor
from fv2p_torch.models.dense_heads import point_head_simple as torch_point
from fv2p_torch.models.detectors.detector3d_template import compute_training_loss
from fv2p_torch.models.roi_heads import iouguided_roi_head as torch_roi
from fv2p_torch.ops import pointops
from fv2p_torch.ops.sparse import conv as torch_conv
from fv2p_torch.ops.sparse import host_rulebook as torch_host_rulebook
from fv2p_torch.train_utils.optimization import build_optimizer
from fv2p_torch.train_utils.train_state import TrainStep, step_generators
from fv2p_torch.utils import box_coder_utils, iou3d, loss_utils
from fv2p_torch.utils.synthetic import batch_to_torch, synthetic_batch_np
from fv2p_torch.weights import flax_variables, load_flax_variables

REPO = Path(__file__).resolve().parent.parent
FV2P_YAML = REPO / 'tools/cfgs/kitti_models/FV2P/fv2p.yaml'
SAMPLING_KEY = jax.random.PRNGKey(21)


def close_by_max(actual, ref, what=''):
    """|actual - ref| <= 1e-4 * max|ref| + 1e-7, elementwise."""
    a = np.asarray(actual, np.float64)
    r = np.asarray(ref, np.float64)
    assert a.shape == r.shape, (what, a.shape, r.shape)
    tol = 1e-4 * (float(np.abs(r).max()) if r.size else 0.0) + 1e-7
    err = float(np.abs(a - r).max()) if r.size else 0.0
    assert err <= tol, f'{what}: max abs error {err} > {tol}'


def flat_paths(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if hasattr(v, 'items'):
            out.update(flat_paths(v, prefix + (k,)))
        else:
            out['/'.join(prefix + (k,))] = np.asarray(v)
    return out


def rand_boxes(rng, n, spread=3.0):
    return np.concatenate([
        rng.uniform(-spread, spread, (n, 2)), rng.uniform(-1.5, -0.5, (n, 1)),
        rng.uniform(1.0, 4.5, (n, 1)), rng.uniform(0.8, 2.0, (n, 2)),
        rng.uniform(-np.pi, np.pi, (n, 1))], 1).astype(np.float32)


# ----------------------------------------------------------------- losses

def test_losses_match_jax():
    rng = np.random.RandomState(0)
    logits = (rng.randn(3, 40, 2) * 4).astype(np.float32)
    targets = (rng.rand(3, 40, 2) < 0.3).astype(np.float32)
    w_anchor = rng.rand(3, 40).astype(np.float32)
    w_full = rng.rand(3, 40, 2).astype(np.float32)
    assert_close(loss_utils.sigmoid_ce_with_logits(t(logits), t(targets)),
                 jax_loss.sigmoid_ce_with_logits(logits, targets))
    for w in (w_anchor, w_full):
        assert_close(loss_utils.sigmoid_focal_loss(t(logits), t(targets), t(w)),
                     jax_loss.sigmoid_focal_loss(logits, targets, w))
    diff = (rng.randn(200) * 0.5).astype(np.float32)
    for beta in (1.0 / 9.0, 1.0, 0.0):
        assert_close(loss_utils.smooth_l1(t(diff), beta), jax_loss.smooth_l1(diff, beta))


def test_residual_coder_encode_matches_jax():
    rng = np.random.RandomState(1)
    boxes, anchors = rand_boxes(rng, 64), rand_boxes(rng, 64)
    boxes[:4, 3:6] = [0.0, -1.0, 1e-7]            # extents clamped to 1e-5
    anchors[4:8, 3] = 0.0
    ref = jax_coder.ResidualCoder().encode(jnp.asarray(boxes), jnp.asarray(anchors))
    got = box_coder_utils.ResidualCoder().encode(t(boxes), t(anchors))
    assert_close(got, ref)
    # decode(encode(b)) == b on ordinary boxes
    back = box_coder_utils.ResidualCoder().decode(got[8:], t(anchors[8:]))
    assert_close(back, boxes[8:])


# ------------------------------------------------------------ RPN targets

def _anchor_heads(meta):
    cfg = TINY_FV2P_CFG.DENSE_HEAD
    ch = int(sum(TINY_FV2P_CFG.BACKBONE_2D.NUM_UPSAMPLE_FILTERS))
    jhead = jax_anchor.AnchorHeadSingle(
        model_cfg=StaticConfig(cfg), input_channels=ch, num_class=1,
        class_names=('Car',), grid_size=tuple(meta['grid_size']),
        point_cloud_range=tuple(meta['point_cloud_range']))
    thead = torch_anchor.AnchorHeadSingle(cfg, ch, 1, tuple(meta['grid_size']),
                                          tuple(meta['point_cloud_range']))
    return jhead, thead


def _tiny_meta():
    from tests.test_fv2p_model import make_fv2p_batch
    return make_fv2p_batch(batch_size=1)[1]


def _rpn_gt():
    """gt (2, 6, 8): boxes on anchors and between them, at headings that
    swap the nearest axis-aligned rectangle, one sample with padding only
    after a single box."""
    gt = np.zeros((2, 6, 8), np.float32)
    gt[0, :5] = [[3.0, 0.0, -1.0, 3.7, 1.6, 1.5, 0.3, 1],
                 [1.5, -1.5, -1.0, 3.9, 1.6, 1.4, -0.5, 1],
                 [4.9, 2.2, -0.8, 3.9, 1.6, 1.56, 1.2, 1],
                 [0.8, 2.4, -1.2, 1.0, 0.6, 1.5, 2.9, 1],
                 [5.6, -2.6, -1.0, 4.2, 1.8, 1.5, -1.57, 1]]
    gt[1, 0] = [2.4, 0.8, -1.0, 3.9, 1.6, 1.56, 0.78, 1]
    return gt


def test_anchor_targets_match_jax():
    jhead, thead = _anchor_heads(_tiny_meta())
    gt = _rpn_gt()
    anchors = jnp.asarray(jhead._anchors().reshape(-1, 7))
    ref = jhead._assign_targets(jnp.asarray(gt), anchors)
    got = thead.assign_targets(t(gt))
    assert_equal(got['box_cls_labels'], ref['box_cls_labels'])
    assert_close(got['box_reg_targets'], ref['box_reg_targets'])
    assert_close(got['reg_weights'], ref['reg_weights'])
    labels = np.asarray(ref['box_cls_labels'])
    assert (labels > 0).sum() >= 4 and (labels == -1).any() and (labels == 0).any()
    # the axis-aligned overlap on its own
    rng = np.random.RandomState(2)
    a, b = rand_boxes(rng, 30), rand_boxes(rng, 9)
    assert_close(torch_anchor.boxes_nearest_bev_iou(t(a), t(b)),
                 jax_anchor.boxes_nearest_bev_iou(a, b))


def test_anchor_head_loss_matches_jax():
    jhead, thead = _anchor_heads(_tiny_meta())
    gt = _rpn_gt()
    anchors = jhead._anchors().reshape(-1, 7)
    targets = jhead._assign_targets(jnp.asarray(gt), jnp.asarray(anchors))
    rng = np.random.RandomState(3)
    na = anchors.shape[0]
    ret = {'cls_preds': rng.randn(2, na, 1).astype(np.float32) * 2,
           'box_preds': rng.randn(2, na, 7).astype(np.float32) * 0.3,
           'dir_cls_preds': rng.randn(2, na, 2).astype(np.float32)}
    ret.update({k: np.asarray(v) for k, v in targets.items()})
    ref_loss, ref_tb = jax_anchor.anchor_head_loss(
        StaticConfig(TINY_FV2P_CFG.DENSE_HEAD), {k: jnp.asarray(v) for k, v in ret.items()},
        jnp.asarray(anchors), 1)
    got_loss, got_tb = torch_anchor.anchor_head_loss(
        TINY_FV2P_CFG.DENSE_HEAD, {k: t(v) for k, v in ret.items()},
        t(anchors), 1)
    assert sorted(got_tb) == sorted(ref_tb)
    for k in ref_tb:
        assert_close(got_tb[k], ref_tb[k])
    assert_close(got_loss, ref_loss)


def test_three_class_anchor_targets_and_loss_match_jax():
    """The anchor targets and anchor_head_loss of the tiny FV2P with
    fv2p_3classes.yaml's three anchor classes (per-class thresholds), on gt
    of all three classes."""
    from tests.test_torch_model import three_class_cfg
    cfg, classes = three_class_cfg()
    meta = _tiny_meta()
    ch = int(sum(cfg.BACKBONE_2D.NUM_UPSAMPLE_FILTERS))
    jhead = jax_anchor.AnchorHeadSingle(
        model_cfg=StaticConfig(cfg.DENSE_HEAD), input_channels=ch, num_class=3,
        class_names=tuple(classes), grid_size=tuple(meta['grid_size']),
        point_cloud_range=tuple(meta['point_cloud_range']))
    thead = torch_anchor.AnchorHeadSingle(cfg.DENSE_HEAD, ch, 3, tuple(meta['grid_size']),
                                          tuple(meta['point_cloud_range']))
    gt = _rpn_gt()
    gt[0, 3, 7] = 2                                  # the 1.0 x 0.6 box: a pedestrian
    gt[0, 5] = [2.0, -2.2, -0.6, 1.76, 0.6, 1.73, 0.4, 3]
    gt[1, 1] = [4.4, 1.2, -0.6, 0.8, 0.6, 1.73, -1.0, 2]
    anchors = jhead._anchors().reshape(-1, 7)
    ref = jhead._assign_targets(jnp.asarray(gt), jnp.asarray(anchors))
    got = thead.assign_targets(t(gt))
    assert_equal(got['box_cls_labels'], ref['box_cls_labels'])
    assert_close(got['box_reg_targets'], ref['box_reg_targets'])
    assert_close(got['reg_weights'], ref['reg_weights'])
    labels = np.asarray(ref['box_cls_labels'])
    assert set(np.unique(labels[labels > 0]).tolist()) == {1, 2, 3}
    rng = np.random.RandomState(6)
    na = anchors.shape[0]
    ret = {'cls_preds': rng.randn(2, na, 3).astype(np.float32) * 2,
           'box_preds': rng.randn(2, na, 7).astype(np.float32) * 0.3,
           'dir_cls_preds': rng.randn(2, na, 2).astype(np.float32)}
    ret.update({k: np.asarray(v) for k, v in ref.items()})
    ref_loss, ref_tb = jax_anchor.anchor_head_loss(
        StaticConfig(cfg.DENSE_HEAD), {k: jnp.asarray(v) for k, v in ret.items()},
        jnp.asarray(anchors), 3)
    got_loss, got_tb = torch_anchor.anchor_head_loss(
        cfg.DENSE_HEAD, {k: t(v) for k, v in ret.items()}, t(anchors), 3)
    assert sorted(got_tb) == sorted(ref_tb)
    for k in ref_tb:
        assert_close(got_tb[k], ref_tb[k])
    assert_close(got_loss, ref_loss)


# ---------------------------------------------------------- point targets

@pytest.mark.parametrize('num_class', [1, 3])
def test_point_targets_and_loss_match_jax(num_class):
    rng = np.random.RandomState(4 + num_class)
    gt = _rpn_gt()
    if num_class == 3:
        gt[0, :5, 7] = [1, 2, 3, 2, 1]
    # points in, near and away from the boxes
    pts = []
    for b in range(2):
        boxes = gt[b][gt[b, :, 7] > 0]
        near = boxes[rng.randint(0, len(boxes), 300), :3] + rng.uniform(
            -2.2, 2.2, (300, 3)) * [1.0, 1.0, 0.6]
        far = rng.uniform([0, -3.2, -3], [6.4, 3.2, 1], (100, 3))
        pts.append(np.concatenate([near, far]).astype(np.float32))
    pts = np.stack(pts)
    extra = tuple(TINY_FV2P_CFG.POINT_HEAD.TARGET_CONFIG.GT_EXTRA_WIDTH)
    ref = jax_point.assign_point_targets(jnp.asarray(pts), jnp.asarray(gt), extra,
                                         num_class)
    got = torch_point.assign_point_targets(t(pts), t(gt), extra, num_class)
    assert_equal(got, ref)
    labels = np.asarray(ref)
    assert (labels > 0).sum() > 50 and (labels == -1).sum() > 5 and (labels == 0).sum() > 50
    if num_class == 3:
        assert set(np.unique(labels)) == {-1, 0, 1, 2, 3}
    for b in range(2):
        valid = gt[b, :, 7] > 0
        assert_equal(pointops.points_in_boxes_index(t(pts[b]), t(gt[b, :, :7]), t(valid)),
                     jax_pointops.points_in_boxes_index(pts[b], gt[b, :, :7], valid))
    logits = rng.randn(2, 400, num_class).astype(np.float32) * 2
    ref_loss, ref_tb = jax_point.point_head_loss(
        StaticConfig(TINY_FV2P_CFG.POINT_HEAD),
        {'point_cls_preds': jnp.asarray(logits), 'point_cls_labels': ref})
    got_loss, got_tb = torch_point.point_head_loss(
        TINY_FV2P_CFG.POINT_HEAD, {'point_cls_preds': t(logits), 'point_cls_labels': got})
    assert_close(got_loss, ref_loss)
    assert_close(got_tb['point_loss_cls'], ref_tb['point_loss_cls'])


def test_boxes_iou3d_matches_jax():
    rng = np.random.RandomState(6)
    a = rand_boxes(rng, 40, spread=2.0)
    b = np.concatenate([rand_boxes(rng, 20, spread=2.0), a[:5]])
    b[20:, 2] += [0.0, 0.5, 1.0, 1.4, 3.0]          # z overlaps down to none
    a[3, 3:6] = 0.0                                   # an empty box
    assert_close(iou3d.boxes_overlap_bev(t(a), t(b)), jax_iou3d.boxes_overlap_bev(a, b))
    ref = jax_iou3d.boxes_iou3d(a, b)
    assert_close(iou3d.boxes_iou3d(t(a), t(b)), ref)
    assert float(np.asarray(ref).max()) > 0.9


# ------------------------------------------------------------- RoI targets

def jax_sampling_draws(key, batch_size, num_rois, n_sample):
    """The draws JAX's sample_rois_single makes from ``key`` for each scan,
    as the port's ``draw_roi_sampling`` returns them."""
    rand, hr, er, fr = [], [], [], []
    for k in jax.random.split(key, batch_size):
        k1, k2, k3, k4 = jax.random.split(k, 4)
        rand.append(np.asarray(jax.random.uniform(k1, (num_rois,))))
        for out, kk in ((hr, k2), (er, k3), (fr, k4)):
            out.append(np.asarray(jax.random.randint(kk, (n_sample,), 0, 2 ** 30)))
    return {'rand': t(np.stack(rand)), 'hr': t(np.stack(hr)).long(),
            'er': t(np.stack(er)).long(), 'fr': t(np.stack(fr)).long()}


def _crafted_rois(rng, gt, n_rois, kinds):
    """RoIs around the gt boxes: 'fg' (small jitter), 'hard' (IoU between
    CLS_BG_THRESH_LO and the fg threshold), 'easy' (away from every box) and
    'pad' (invalid rows)."""
    boxes = gt[gt[:, 7] > 0]
    rois, valid = [], []
    for i in range(n_rois):
        kind = kinds[i % len(kinds)]
        g = boxes[i % len(boxes), :7].copy()
        if kind == 'fg':
            g[:3] += rng.uniform(-0.1, 0.1, 3)
            g[6] += rng.uniform(-0.05, 0.05) + (np.pi if i % 3 == 0 else 0.0)
        elif kind == 'hard':
            g[:2] += rng.choice([-1, 1], 2) * rng.uniform(0.9, 1.4, 2)
            g[6] += rng.uniform(-0.4, 0.4)
        elif kind == 'easy':
            g[:2] += [25.0 + i, -20.0]
        rois.append(g if kind != 'pad' else np.zeros(7, np.float32))
        valid.append(kind != 'pad')
    return np.stack(rois).astype(np.float32), np.asarray(valid)


@pytest.mark.parametrize('case', ['mixed', 'no_background', 'no_foreground'])
def test_sample_rois_and_assign_targets_match_jax(case):
    tcfg = TINY_FV2P_CFG.ROI_HEAD.TARGET_CONFIG
    rng = np.random.RandomState(7)
    gt = _rpn_gt()
    kinds = {'mixed': ['fg', 'hard', 'easy', 'fg', 'pad', 'hard'],
             'no_background': ['fg', 'fg', 'pad'],
             'no_foreground': ['hard', 'easy', 'easy', 'pad']}[case]
    r = 24
    rois, valid = zip(*(_crafted_rois(rng, gt[b], r, kinds) for b in range(2)))
    rois, valid = np.stack(rois), np.stack(valid)
    scores = rng.rand(2, r).astype(np.float32)
    labels = np.where(valid, 1, 0).astype(np.int32)
    bd = {'rois': rois, 'roi_scores': scores, 'roi_labels': labels,
          'roi_valid': valid, 'gt_boxes': gt}
    ref = jax_roi.assign_targets(SAMPLING_KEY, {k: jnp.asarray(v) for k, v in bd.items()},
                                 tcfg)
    draws = jax_sampling_draws(SAMPLING_KEY, 2, r, int(tcfg.ROI_PER_IMAGE))
    got = torch_roi.assign_targets({k: t(v) for k, v in bd.items()}, tcfg, draws)
    assert sorted(got) == sorted(ref)
    for k in ('roi_labels', 'reg_valid_mask'):
        assert_equal(got[k], ref[k])
    for k in ('rois', 'roi_scores', 'gt_iou_of_rois', 'gt_of_rois', 'gt_of_rois_src',
              'rcnn_cls_labels'):
        assert_close(got[k], ref[k])
    ious = np.asarray(ref['gt_iou_of_rois'])
    if case == 'mixed':
        assert (ious >= 0.55).any() and ((ious > 0.1) & (ious < 0.55)).any() \
            and (ious < 0.1).any()
    elif case == 'no_background':
        assert (ious >= 0.55).all()
    else:
        assert (ious < 0.55).all()


def test_roi_head_loss_matches_jax():
    tcfg = TINY_FV2P_CFG.ROI_HEAD.TARGET_CONFIG
    rng = np.random.RandomState(8)
    gt = _rpn_gt()
    rois, valid = zip(*(_crafted_rois(rng, gt[b], 24, ['fg', 'hard', 'easy', 'fg'])
                        for b in range(2)))
    bd = {'rois': np.stack(rois), 'roi_scores': rng.rand(2, 24).astype(np.float32),
          'roi_labels': np.ones((2, 24), np.int32), 'roi_valid': np.stack(valid),
          'gt_boxes': gt}
    ret = dict(jax_roi.assign_targets(SAMPLING_KEY,
                                      {k: jnp.asarray(v) for k, v in bd.items()}, tcfg))
    n = 2 * int(tcfg.ROI_PER_IMAGE)
    ret.update(rcnn_cls=rng.randn(n, 1).astype(np.float32),
               rcnn_reg=(rng.randn(n, 7) * 0.2).astype(np.float32),
               rcnn_iouscore=rng.uniform(-1, 1, (n, 1)).astype(np.float32),
               rois_sampled=np.asarray(ret['rois']))
    ref_loss, ref_tb = jax_roi.roi_head_loss(
        StaticConfig(TINY_FV2P_CFG.ROI_HEAD), {k: jnp.asarray(v) for k, v in ret.items()})
    got_loss, got_tb = torch_roi.roi_head_loss(
        TINY_FV2P_CFG.ROI_HEAD, {k: t(np.asarray(v)) for k, v in ret.items()})
    assert sorted(got_tb) == sorted(ref_tb)
    for k in ref_tb:
        assert_close(got_tb[k], ref_tb[k])
    assert_close(got_loss, ref_loss)
    assert float(np.asarray(ret['reg_valid_mask']).sum()) > 0


# ------------------------------------------------------------ BatchNorms

@pytest.mark.parametrize('shape', [(300, 24), (2, 5, 7, 16)])
def test_batchnorm_train_matches_flax(shape):
    rng = np.random.RandomState(9)
    c = shape[-1]
    # a mean far from 0 next to a small spread: the fast-variance formula
    x = (rng.randn(*shape) * 0.5 + rng.uniform(-3, 3, c)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.uniform(-0.3, 0.3, c).astype(np.float32)
    mean0 = rng.uniform(-0.1, 0.1, c).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.99, epsilon=1e-3)
    ref, upd = bn.apply({'params': {'scale': scale, 'bias': bias},
                         'batch_stats': {'mean': mean0, 'var': var0}},
                        jnp.asarray(x), mutable=['batch_stats'])
    tbn = layers.BatchNorm(c)
    with torch.no_grad():
        tbn.weight.copy_(t(scale))
        tbn.bias.copy_(t(bias))
        tbn.running_mean.copy_(t(mean0))
        tbn.running_var.copy_(t(var0))
    got = tbn.train()(t(x))
    assert_close(got, ref)
    assert_close(tbn.running_mean, upd['batch_stats']['mean'])
    assert_close(tbn.running_var, upd['batch_stats']['var'])
    # eval mode reads the running statistics and leaves them alone
    before = tbn.running_mean.clone()
    ref_eval = fnn.BatchNorm(use_running_average=True, momentum=0.99, epsilon=1e-3).apply(
        {'params': {'scale': scale, 'bias': bias}, 'batch_stats': upd['batch_stats']},
        jnp.asarray(x))
    assert_close(tbn.eval()(t(x)), ref_eval)
    assert torch.equal(before, tbn.running_mean)


def test_masked_batchnorm_train_matches_jax():
    rng = np.random.RandomState(10)
    x = (rng.randn(200, 12) * 0.7 + rng.uniform(-2, 2, 12)).astype(np.float32)
    mask = rng.rand(200) < 0.6
    x[~mask] = 0.0
    variables = {'params': {'scale': rng.uniform(0.5, 1.5, 12).astype(np.float32),
                            'bias': rng.uniform(-0.3, 0.3, 12).astype(np.float32)},
                 'batch_stats': {'mean': rng.uniform(-0.1, 0.1, 12).astype(np.float32),
                                 'var': rng.uniform(0.5, 1.5, 12).astype(np.float32)}}
    ref, upd = jax_conv.MaskedBatchNorm().apply(
        variables, jnp.asarray(x), jnp.asarray(mask), use_running_average=False,
        mutable=['batch_stats'])
    tbn = torch_conv.MaskedBatchNorm(12)
    with torch.no_grad():
        tbn.weight.copy_(t(variables['params']['scale']))
        tbn.bias.copy_(t(variables['params']['bias']))
        tbn.running_mean.copy_(t(variables['batch_stats']['mean']))
        tbn.running_var.copy_(t(variables['batch_stats']['var']))
    got = tbn.train()(t(x), t(mask))
    assert_close(got, ref)
    assert_close(tbn.running_mean, upd['batch_stats']['mean'])
    assert_close(tbn.running_var, upd['batch_stats']['var'])


# ------------------------------------------------- sparse conv backward

def _level_tables():
    """The tiny batch's host rulebooks: a subm table and a strided table
    with its inverse, both packages' own, as (B, K, cap) int arrays."""
    jax_np, torch_np, meta = make_rulebook_batches()
    jr, tr = jax_np['rulebooks'], torch_np['rulebooks']
    for k in ('subm_x_conv2', 'down_x_conv1->x_conv2', 'down_inv_x_conv1->x_conv2'):
        assert_equal(tr[k], jr[k])
    return tr


@pytest.mark.parametrize('kind', ['subm', 'strided'])
def test_sparse_conv_gradients_match_jax(kind):
    from fv2p_torch.models.backbones_3d.spconv_backbone import _global_table
    rb = _level_tables()
    b = rb['subm_x_conv2'].shape[0]
    # (B, K, cap) tables have one column per row of the level they fill
    cap1 = rb['down_inv_x_conv1->x_conv2'].shape[2]
    cap2 = rb['down_x_conv1->x_conv2'].shape[2]
    if kind == 'subm':
        nbr = _global_table(t(rb['subm_x_conv2']), cap2)
        inv = None                       # the port mirrors the taps itself
        n_in = b * cap2
    else:
        nbr = _global_table(t(rb['down_x_conv1->x_conv2']), cap1)
        inv = _global_table(t(rb['down_inv_x_conv1->x_conv2']), cap2)
        n_in = b * cap1
    k = nbr.shape[1]
    rng = np.random.RandomState(11)
    feats = rng.randn(n_in, 6).astype(np.float32)
    w = (rng.randn(k, 6, 5) * 0.2).astype(np.float32)
    dout = rng.randn(nbr.shape[0], 5).astype(np.float32)

    jinv = jnp.asarray((nbr.flip(1) if inv is None else inv).numpy().T)

    def jax_loss_fn(f, ww):
        out = jax_conv.sparse_conv_apply(f, jnp.asarray(nbr.numpy().T), ww, inv_idx=jinv)
        return jnp.sum(out * dout)

    ref_out = jax_conv.sparse_conv_apply(jnp.asarray(feats), jnp.asarray(nbr.numpy().T),
                                         jnp.asarray(w))
    ref_df, ref_dw = jax.grad(jax_loss_fn, argnums=(0, 1))(jnp.asarray(feats),
                                                          jnp.asarray(w))
    # XLA autodiff (a scatter-add) computes the same gradients
    auto_df, auto_dw = jax.grad(lambda f, ww: jnp.sum(jax_conv.sparse_conv_apply(
        f, jnp.asarray(nbr.numpy().T), ww) * dout), argnums=(0, 1))(
        jnp.asarray(feats), jnp.asarray(w))
    close_by_max(ref_df, auto_df, 'custom vs autodiff dfeat')

    tf = t(feats).requires_grad_()
    tw = t(w).requires_grad_()
    out = torch_conv.sparse_conv_apply(tf, nbr, tw, inv=inv)
    assert_close(out, ref_out)
    (out * t(dout)).sum().backward()
    close_by_max(tf.grad, ref_df, 'dfeat')
    close_by_max(tw.grad, ref_dw, 'dW')
    assert float(np.abs(np.asarray(ref_df)).max()) > 0


# ------------------------------------------------------------- optimizer

def _kitti_optim_cfg():
    cfg = EasyDict()
    cfg_from_yaml_file(str(FV2P_YAML), cfg)
    return cfg.OPTIMIZATION


@pytest.mark.parametrize('clip', [10.0, 0.05])
def test_adam_onecycle_matches_optax(clip):
    """Five steps from the same parameters and gradients; with clip 0.05
    every step's gradients are scaled down, with 10 none are."""
    ocfg = copy.deepcopy(_kitti_optim_cfg())
    ocfg.GRAD_NORM_CLIP = clip
    total = 50          # the first phase ends at step 20: steps cross no edge
    rng = np.random.RandomState(12)
    params = {'a': rng.randn(5, 4).astype(np.float32),
              'b': rng.randn(7).astype(np.float32)}
    grads = [{k: (rng.randn(*v.shape) * 0.3).astype(np.float32) for k, v in params.items()}
             for _ in range(5)]
    tx = jax_optim.build_optimizer(StaticConfig(ocfg), total)
    state = tx.init(jax.tree_util.tree_map(jnp.asarray, params))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = {k: torch.nn.Parameter(t(v)) for k, v in params.items()}
    opt = build_optimizer(tp.values(), ocfg, total)
    for g in grads:
        upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = t(g[k])
        norm = opt.clip_grads()
        opt.step()
        np.testing.assert_allclose(float(norm), float(optax.global_norm(g)), rtol=1e-6)
    for k in params:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-6,
                                   atol=1e-7)
    assert opt.count == 5


def test_one_cycle_schedules_match_jax():
    ocfg = _kitti_optim_cfg()
    from fv2p_torch.train_utils import optimization as topt
    lr = jax_optim.one_cycle_lr_schedule(float(ocfg.LR), float(ocfg.DIV_FACTOR),
                                         float(ocfg.PCT_START), 1000)
    mom = jax_optim.one_cycle_mom_schedule(tuple(ocfg.MOMS), float(ocfg.PCT_START), 1000)
    for step in (0, 1, 399, 400, 401, 999, 1000, 1200):
        np.testing.assert_allclose(
            topt.one_cycle_lr(step, float(ocfg.LR), float(ocfg.DIV_FACTOR),
                              float(ocfg.PCT_START), 1000), float(lr(step)), rtol=1e-6)
        np.testing.assert_allclose(
            topt.one_cycle_mom(step, tuple(ocfg.MOMS), float(ocfg.PCT_START), 1000),
            float(mom(step)), rtol=1e-6)


# --------------------------------------------------------- port-only parts

def test_dropout_draws_from_the_generator():
    x = torch.ones(20000)
    drop = layers.Dropout(0.3).train()
    a = drop(x, torch.Generator().manual_seed(5))
    b = drop(x, torch.Generator().manual_seed(5))
    c = drop(x, torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = a != 0
    assert abs(float(kept.float().mean()) - 0.7) < 0.02
    assert torch.allclose(a[kept], torch.full_like(a[kept], 1 / 0.7))
    assert torch.equal(drop.eval()(x, None), x)
    assert torch.equal(layers.Dropout(0.0).train()(x, None), x)


def test_step_generators_follow_the_step():
    g0, g0b, g1 = step_generators(0, 'cpu'), step_generators(0, 'cpu'), step_generators(1, 'cpu')
    draw = lambda g: torch.rand(4, generator=g)
    assert torch.equal(draw(g0['sampling']), draw(g0b['sampling']))
    assert not torch.equal(draw(g0b['sampling']), draw(g0b['dropout']))
    assert not torch.equal(draw(g1['sampling']), draw(step_generators(0, 'cpu')['sampling']))


def test_train_mode_never_calls_b4(monkeypatch):
    """A bf16 SA module of FV2P's shape takes kernel B4 in eval mode only;
    in training it groups with the differentiable gather path."""
    sa = torch_roi._SAModuleMSG((0.8, 1.6), (16, 16), ((64, 64), (64, 64)), 8, True,
                                torch.bfloat16)
    assert sa.eval().fused_ok()
    assert not sa.train().fused_ok()

    def refuse(*a, **k):
        raise AssertionError('B4 called in training')

    monkeypatch.setattr(torch_roi, 'sa_group_pool_fused', refuse)
    rng = np.random.RandomState(13)
    xyz = t(rng.randn(3, 40, 3).astype(np.float32))
    out = sa.train()(xyz, torch.ones(3, 40, dtype=torch.bool),
                     t(rng.randn(3, 40, 8).astype(np.float32)),
                     t(rng.randn(3, 27, 3).astype(np.float32) * 0.5))
    out.float().sum().backward()
    assert out.shape == (3, 27, 128)


def test_synthetic_train_batch():
    """gt 'bench' is the JAX bench batch's, the voxels stay draw for draw,
    'scan' gives each scan's six cars, and the dataset's padding keeps the
    scan's points first."""
    import __graft_entry__ as ge
    cfg = EasyDict()
    cfg_from_yaml_file(str(FV2P_YAML), cfg)
    meta = dataset_meta_from_cfg(cfg.DATA_CONFIG, 'train')
    ref = ge._synthetic_batch(meta, 2, 3000, 500, seed=3, host_rulebooks=True,
                              n_points=700, with_gt=True)
    got = synthetic_batch_np(meta, 2, 3000, 500, 700, seed=3, gt='bench')
    assert_equal(got['gt_boxes'], ref['gt_boxes'])
    for k in ('voxels', 'voxel_coords', 'points'):
        assert_equal(got[k], ref[k])
    cap = int(cfg.DATA_CONFIG.MAX_POINTS_PER_SCAN)
    pad = synthetic_batch_np(meta, 2, 3000, 500, cap, seed=3, gt='scan', pad_points=True)
    for k in ('voxels', 'voxel_coords', 'voxel_num_points', 'voxel_valid'):
        assert_equal(pad[k], got[k])
    assert pad['gt_boxes'].shape == (2, 50, 8)
    assert (pad['gt_boxes'][:, :6, 7] == 1).all() and (pad['gt_boxes'][:, 6:] == 0).all()
    for b in range(2):
        n = int(pad['points_valid'][b].sum())
        assert 0 < n < cap and pad['points_valid'][b, :n].all()
        assert (pad['points'][b, n:] == 0).all()
        # the cars are in the scan: some points lie inside each
        inside = iou3d.points_in_rotated_boxes(t(pad['points'][b, :n, :3]),
                                               t(pad['gt_boxes'][b, :6, :7]))
        assert int(inside.any(dim=1).sum()) >= 3


def test_flax_variables_round_trip():
    """The port's parameters and statistics, turned back into the flax tree,
    equal the tree they were loaded from."""
    jax_np, _, meta = make_rulebook_batches()
    jmodel = jax_build_network(TINY_FV2P_CFG, num_class=1, class_names=['Car'],
                               dataset_meta=meta)
    variables = jinit(jmodel, {'params': jax.random.PRNGKey(0),
                               'sampling': jax.random.PRNGKey(1),
                               'dropout': jax.random.PRNGKey(2)}, dict(to_jax(jax_np)))
    vnp = perturb_bn(jax.tree_util.tree_map(np.asarray, dict(variables)),
                     np.random.RandomState(0))
    tmodel = torch_models.build_network(TINY_FV2P_CFG, 1, ['Car'], meta, device='cpu')
    load_flax_variables(tmodel, vnp)
    back = flat_paths(flax_variables(tmodel))
    ref = flat_paths(vnp)
    assert sorted(back) == sorted(ref)
    for k in ref:
        assert_equal(back[k], ref[k])


# ------------------------------------------------- the whole train step

def _train_cfg():
    cfg = copy.deepcopy(TINY_FV2P_CFG)
    cfg.ROI_HEAD.DP_RATIO = 0.0
    return cfg


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
    vnp = perturb_bn(jax.tree_util.tree_map(np.asarray, dict(variables)),
                     np.random.RandomState(0))
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


def _zero_by_construction(path):
    """A bias that a train-mode BatchNorm normalises away (the sparse
    residual blocks' conv biases): its true gradient is 0, and both sides
    give rounding noise."""
    return path.startswith('backbone_3d/res') and path.endswith('/bias') \
        and '/conv' in path


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
