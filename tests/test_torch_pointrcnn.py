"""PointRCNN in the PyTorch port against the JAX package on the CPU.

* ``PointResidualCoder`` encode and decode (per-class mean sizes and the
  raw form), ``assign_point_box_targets`` (foreground, ignore band,
  background), and ``farthest_point_sample_batch`` at the RoI head's row
  shapes (400 rows of 512 pooled points, 128 picks, then 128 -> 32), with
  rows of no valid point and rows with fewer valid points than picks.
* The tiny ``POINTRCNN_CFG`` of ``tests/test_model_zoo.py``, initialised in
  flax, BatchNorm statistics perturbed, carried across by
  ``load_flax_variables``: the eval forward (point features, proposals,
  refined boxes, detections); its train steps are in
  ``tests/test_torch_pointrcnn_train.py``.
* The three PointRCNN yamls build at full width with JAX's parameter
  counts, and ``PartA2_free.yaml`` (PointRCNN's detector over PartA2's
  modules) builds at full width.

Tolerances as the other model tests: integers exact, floats rtol 1e-4
(``assert_close``), gradients, statistics and parameters within
1e-4 max|ref| + 1e-7 (``close_by_max``), in f32.
"""
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fv2p_tpu.config import EasyDict as JaxEasyDict
from fv2p_tpu.config import cfg_from_yaml_file as jax_cfg_from_yaml_file
from fv2p_tpu.datasets import dataset_meta_from_cfg as jax_meta_from_cfg
from fv2p_tpu.models import build_network as jax_build_network
from fv2p_tpu.models.dense_heads import point_head_box as jax_phb
from fv2p_tpu.ops import pointops as jax_pointops
from fv2p_tpu.utils import box_coder_utils as jax_coders
from tests.jitu import japply, jinit
from tests.test_fv2p_model import make_fv2p_batch
from tests.test_model_zoo import POINTRCNN_CFG
from tests.test_torch_model import assert_close, assert_equal, perturb_bn

import fv2p_torch.models as torch_models
from fv2p_torch.config import EasyDict, cfg_from_yaml_file
from fv2p_torch.datasets import dataset_meta_from_cfg
from fv2p_torch.models.dense_heads.point_head_box import assign_point_box_targets
from fv2p_torch.ops import pointops
from fv2p_torch.utils import box_coder_utils
from fv2p_torch.utils.synthetic import batch_to_torch
from fv2p_torch.weights import load_flax_variables
from tests.test_torch_model import one_torch_thread  # noqa: F401 (an autouse fixture)

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
    """PointRCNN's detector over PartA2's UNetV2 backbone and part head
    (ported since, with PartA2): the yaml builds at full width, the point
    head over UNetV2's 16 channels with its box branch, the RoI head over
    12^3 pooled cells of 128 channels. The name stays from when it raised;
    ``tests/test_torch_parta2.py`` holds its parameter count to JAX's."""
    cfg = EasyDict()
    cfg_from_yaml_file(str(REPO / 'tools/cfgs/kitti_models/PartA2_free.yaml'), cfg)
    meta = dataset_meta_from_cfg(cfg.DATA_CONFIG, 'test')
    model = torch_models.build_network(cfg.MODEL, len(cfg.CLASS_NAMES), cfg.CLASS_NAMES,
                                       meta, device='cpu')
    assert type(model).__name__ == 'PointRCNN'
    assert type(model.backbone_3d).__name__ == 'UNetV2'
    assert model.point_head.cls_fc0.in_features == 16 and model.point_head.coder is not None
    assert model.roi_head.shared_fc0.in_features == 12 ** 3 * 128
    assert not hasattr(model, 'dense_head')
