"""PartA2 in the PyTorch port against the JAX package on the CPU.

* The sparse functions PartA2 adds: ``SparseInverseConv3d`` (forward and
  both gradients, through a strided layer's tables swapped),
  ``sparse_maxpool`` and ``sparse_group``, on one seeded sparse tensor of
  two samples, with JAX's device tables transposed to the port's (N, K).
* ``roiaware_pool3d`` 'max' and 'avg' with an empty RoI, a zero-size box,
  a rotated box and points on the cells' borders and on the box's faces;
  ``assign_part_targets`` with padding gt rows.
* The tiny ``PARTA2_CFG`` and ``PARTA2_FREE_CFG`` of ``tests/test_parta2.py``
  on ``tests/test_torch_zoo.compact_batch`` (voxels of one 8-voxel cube a
  scan), initialised in flax, BatchNorm statistics perturbed, carried
  across by ``load_flax_variables``: UNetV2's ``multi_scale_3d_features``,
  ``point_features``, ``point_coords`` and ``point_valid`` on host and on
  device tables (on device tables the port's point rows are held to JAX's
  host-table ones: JAX's batch-flat reshape mixes the samples, ROADMAP C12),
  and the eval detections of both models on host tables.
* ``build_optimizer`` 'adam' and 'sgd' against optax's through JAX's
  ``build_optimizer``, three steps with GRAD_NORM_CLIP on, and
  ``decay_lr_schedule``.
* The four PartA2 yamls build at full width with JAX's parameter counts.

One train step of both models: ``tests/test_torch_parta2_train.py``.

Tolerances: integers exact; floats rtol 1e-4 (``assert_close``) or within
1e-4 max|ref| + 1e-6 (``close``), in f32; the optimizers rtol 1e-6.
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
from fv2p_tpu.models.dense_heads import point_intra_part_head as jax_part
from fv2p_tpu.ops import roiaware_pool as jax_pool
from fv2p_tpu.ops.sparse import conv as jax_conv
from fv2p_tpu.ops.sparse import host_rulebook as jax_host_rulebook
from fv2p_tpu.ops.sparse import rulebook as jax_rulebook
from fv2p_tpu.ops.sparse.sparse_tensor import from_coords as jax_from_coords
from fv2p_tpu.train_utils import optimization as jax_optim
from tests.jitu import japply, jinit
from tests.test_parta2 import PARTA2_CFG, PARTA2_FREE_CFG
from tests.test_torch_ddp import close
from tests.test_torch_model import (assert_close, assert_equal, perturb_bn, sparse_to_torch, t,
                                    to_jax)
from tests.test_torch_zoo import compact_batch

import fv2p_torch.models as torch_models
from fv2p_torch.config import EasyDict, cfg_from_yaml_file
from fv2p_torch.datasets import dataset_meta_from_cfg
from fv2p_torch.models.dense_heads.point_intra_part_head import assign_part_targets
from fv2p_torch.ops import roiaware_pool
from fv2p_torch.ops.sparse import conv as torch_conv
from fv2p_torch.ops.sparse import host_rulebook as torch_host_rulebook
from fv2p_torch.train_utils import optimization as torch_optim
from fv2p_torch.utils.synthetic import batch_to_torch
from fv2p_torch.weights import load_flax_variables
from tests.test_torch_model import one_torch_thread  # noqa: F401 (an autouse fixture)

REPO = Path(__file__).resolve().parent.parent
CFGS = {'parta2': PARTA2_CFG, 'parta2_free': PARTA2_FREE_CFG}
PARTA2_YAMLS = ('kitti_models/PartA2.yaml', 'kitti_models/PartA2_car.yaml',
                'kitti_models/PartA2_free.yaml', 'waymo_models/PartA2.yaml')


# ------------------------------------------------------ sparse functions

def sparse_case(seed=0, cin=8):
    """Two samples of 40 voxels in a (9, 16, 16) grid, their strided
    layer's output level (JAX's device tables) and seeded features of both
    levels, padding rows zero."""
    rng = np.random.RandomState(seed)
    shape, b, cap, n = (9, 16, 16), 2, 48, 40
    coords = np.zeros((b * cap, 4), np.int32)
    valid = np.zeros(b * cap, bool)
    for i in range(b):
        lin = rng.choice(np.prod(shape), n, replace=False)
        coords[i * cap:i * cap + n] = np.stack(
            [np.full(n, i), lin % 9, (lin // 9) % 16, lin // 144], 1)
        valid[i * cap:i * cap + n] = True
    feats = rng.randn(b * cap, cin).astype(np.float32)
    st = jax_from_coords(jnp.asarray(coords), jnp.asarray(feats), shape, b,
                         valid_mask=jnp.asarray(valid))
    out_st, nbr, inv = jax_rulebook.downsample_rulebook(st, 3, 2, 1, 640)
    down_valid = np.asarray(out_st.valid_mask())
    down_feats = rng.randn(640, cin).astype(np.float32) * down_valid[:, None]
    return st, out_st.replace(features=jnp.asarray(down_feats)), np.asarray(nbr), \
        np.asarray(inv), rng


def test_sparse_inverse_conv_matches_jax():
    """The inverse conv from the strided layer's output level back onto its
    source rows: forward, and the gradients of the features and the kernel
    for one seeded cotangent."""
    st, down, nbr, inv, rng = sparse_case()
    cout = 5
    w = rng.randn(27, 8, cout).astype(np.float32) * 0.3
    cot = rng.randn(st.capacity, cout).astype(np.float32)
    src_valid = np.asarray(st.valid_mask())

    def jax_fn(f, k):
        out = jax_conv.sparse_conv_apply(f, jnp.asarray(inv), k, inv_idx=jnp.asarray(nbr))
        return jnp.where(jnp.asarray(src_valid)[:, None], out, 0.0)

    ref, vjp = jax.vjp(jax_fn, down.features, jnp.asarray(w))
    ref_df, ref_dw = vjp(jnp.asarray(cot))

    conv = torch_conv.SparseInverseConv3d(8, cout)
    with torch.no_grad():
        conv.kernel.copy_(t(w))
    feats = t(down.features).requires_grad_(True)
    down_t = sparse_to_torch(down).replace(features=feats)
    out = conv(down_t, sparse_to_torch(st), t(inv.T).long(), t(nbr.T).long())
    out.features.backward(t(cot))
    close(out.features.detach(), ref, 'forward')
    close(feats.grad, ref_df, 'd features')
    close(conv.kernel.grad, ref_dw, 'd kernel')
    assert float(np.abs(np.asarray(ref)).max()) > 0 and src_valid.sum() == 80


def test_sparse_maxpool_and_group_match_jax():
    """Max pooling and grouping through the strided layer's gather table,
    on features below 0 where the max takes a negative value and on rows no
    input reaches (0)."""
    st, _, nbr, _, rng = sparse_case(seed=1)
    feats = np.asarray(st.features) - 1.0
    feats[~np.asarray(st.valid_mask())] = 0.0
    ref = np.asarray(jax_conv.sparse_maxpool(jnp.asarray(feats), jnp.asarray(nbr)))
    got = torch_conv.sparse_maxpool(t(feats), t(nbr.T).long())
    assert_equal(got, ref)
    assert (ref < 0).any() and (ref == 0).all(axis=1).any()
    ref_g = np.asarray(jax_conv.sparse_group(jnp.asarray(feats), jnp.asarray(nbr)))
    assert_equal(torch_conv.sparse_group(t(feats), t(nbr.T).long()), ref_g.transpose(1, 0, 2))


# --------------------------------------------------- RoI-aware pooling

def pool_case():
    """Points in and around six RoIs: axis-aligned (2, 2, 2) at the origin
    with points exactly on its cells' borders and faces, rotated, far from
    every point (empty), zero size, thin and long."""
    rng = np.random.RandomState(4)
    rois = np.array([[0, 0, 0, 2, 2, 2, 0], [0.3, -0.2, 0.1, 1.5, 2.5, 1.0, 0.7],
                     [20, 20, 0, 1, 1, 1, 0], [0.1, 0.1, 0.1, 0, 1, 1, 0],
                     [-0.5, 0.4, 0, 3, 0.4, 0.8, -1.2], [0, 0, 0, 1, 1, 1, 3.0]],
                    np.float32)
    grid = np.arange(-1.0, 1.01, 0.5, dtype=np.float32)     # cell borders at S = 4
    border = np.stack(np.meshgrid(grid, grid, grid[::2], indexing='ij'), -1).reshape(-1, 3)
    pts = np.concatenate([border, rng.uniform(-1.6, 1.6, (300, 3)).astype(np.float32)])
    feats = rng.randn(len(pts), 5).astype(np.float32)
    valid = rng.rand(len(pts)) > 0.1
    return pts, feats, valid, rois


@pytest.mark.parametrize('method', ['max', 'avg'])
def test_roiaware_pool3d_matches_jax(method):
    """Every cell of every RoI: 'max' exact, 'avg' within 1e-4 max|ref| +
    1e-6 (a sum in another order); empty cells exactly 0 in both; the empty
    and the zero-size RoI all 0; the batched form stacks the samples."""
    pts, feats, valid, rois = pool_case()
    ref = np.asarray(jax_pool.roiaware_pool3d(jnp.asarray(pts), jnp.asarray(feats),
                                              jnp.asarray(valid), jnp.asarray(rois), 4, method))
    got = roiaware_pool.roiaware_pool3d(t(pts), t(feats), t(valid), t(rois), 4, method)
    if method == 'max':
        assert_equal(got, ref)
    else:
        close(got, ref, method)
    assert_equal(got == 0, ref == 0)
    assert (ref[2] == 0).all() and (ref[3] == 0).all()
    assert (np.abs(ref[0]).sum(-1) > 0).sum() > 40
    both = roiaware_pool.roiaware_pool3d_batch(
        t(np.stack([pts, pts[::-1]])), t(np.stack([feats, feats[::-1]])),
        t(np.stack([valid, valid[::-1]])), t(np.stack([rois, rois[::-1]])), 4, method)
    ref_b = np.asarray(jax_pool.roiaware_pool3d_batch(
        jnp.asarray(np.stack([pts, pts[::-1]])), jnp.asarray(np.stack([feats, feats[::-1]])),
        jnp.asarray(np.stack([valid, valid[::-1]])), jnp.asarray(np.stack([rois, rois[::-1]])),
        4, method))
    close(both, ref_b, 'batch')


def test_assign_part_targets_matches_jax():
    """Points inside two boxes (one rotated), outside both, and gt padding
    rows: the first box's part location in [0, 1], 0 off the foreground."""
    rng = np.random.RandomState(6)
    gt = np.zeros((2, 4, 8), np.float32)
    gt[:, 0] = [1.0, 0.5, -0.5, 2.0, 1.0, 1.5, 0.4, 1]
    gt[:, 1] = [-1.5, -1.0, -0.5, 1.2, 2.0, 1.0, -1.0, 1]
    gt[1, 1, 7] = 0                                        # a padding row
    pts = rng.uniform(-3, 3, (2, 400, 3)).astype(np.float32)
    pts[..., 2] = rng.uniform(-1.5, 0.5, (2, 400))
    ref = np.asarray(jax_part.assign_part_targets(jnp.asarray(pts), jnp.asarray(gt)))
    got = assign_part_targets(t(pts), t(gt))
    close(got, ref)
    fg = (ref != 0).any(-1)
    assert fg[0].sum() > 20 and fg[1].sum() < fg[0].sum()
    assert ref.min() >= 0 and ref.max() <= 1


# ----------------------------------------------------------------- models

def gt_on_voxels(batch_np, meta):
    """Two gt cars a scan over its voxels' cube (PartA2's points are voxel
    centres), so that the part head has foreground."""
    vs = np.asarray(meta['voxel_size'], np.float32)
    r0 = np.asarray(meta['point_cloud_range'][:3], np.float32)
    gt = np.zeros_like(batch_np['gt_boxes'])
    for b in range(gt.shape[0]):
        n = int(batch_np['voxel_valid'][b].sum())
        xyz = (batch_np['voxel_coords'][b, :n, ::-1] + 0.5) * vs + r0
        c = xyz.mean(0)
        gt[b, 0] = [c[0] - 0.2, c[1], c[2], 0.5, 0.8, 0.9, 0.3, 1]
        gt[b, 1] = [c[0] + 0.3, c[1] + 0.2, c[2], 0.4, 0.5, 0.9, -0.6, 1]
    return gt


def model_batches(rulebooks):
    """(jax_np, torch_np, meta): the compact batch, with each package's own
    host tables for 'host'."""
    batch, meta = compact_batch()
    batch['gt_boxes'] = gt_on_voxels(batch, meta)
    jax_np, torch_np = copy.deepcopy(batch), copy.deepcopy(batch)
    if rulebooks == 'host':
        jax_host_rulebook.prepare_batch_rulebooks(jax_np, 'UNetV2', meta['grid_size'])
        torch_host_rulebook.prepare_batch_rulebooks(torch_np, 'UNetV2', meta['grid_size'])
    return jax_np, torch_np, meta


def jax_setup(cfg, jax_np, meta, seed=0):
    """The flax model and its perturbed variables (numpy)."""
    jmodel = jax_build_network(cfg, num_class=1, class_names=['Car'], dataset_meta=meta)
    ev = {k: v for k, v in to_jax(jax_np).items() if k != 'gt_boxes'}
    variables = jinit(jmodel, {'params': jax.random.PRNGKey(seed),
                               'sampling': jax.random.PRNGKey(1),
                               'dropout': jax.random.PRNGKey(2)}, ev)
    return jmodel, perturb_bn(jax.tree_util.tree_map(np.asarray, dict(variables)),
                              np.random.RandomState(seed))


def torch_model(cfg, meta, vnp):
    return load_flax_variables(torch_models.build_network(cfg, 1, ['Car'], meta,
                                                          device='cpu'), vnp)


@functools.lru_cache(maxsize=None)
def eval_run(name, rulebooks):
    """Both packages' eval outputs of one tiny model; for device tables the
    JAX run on the host tables too (the port's point rows' reference)."""
    cfg = CFGS[name]
    jax_np, torch_np, meta = model_batches(rulebooks)
    jmodel, vnp = jax_setup(cfg, jax_np, meta)
    ev = {k: v for k, v in to_jax(jax_np).items() if k != 'gt_boxes'}
    out = japply(jmodel, jax.tree_util.tree_map(jnp.asarray, vnp), ev)
    tout = torch_model(cfg, meta, vnp)(
        batch_to_torch({k: v for k, v in torch_np.items() if k != 'gt_boxes'}, 'cpu'))
    host = eval_run(name, 'host')[0] if rulebooks == 'device' else out
    return out, tout, host


@pytest.mark.parametrize('name,rulebooks', [('parta2', 'host'), ('parta2', 'device'),
                                            ('parta2_free', 'host')])
def test_unet_levels_match_jax(name, rulebooks):
    """Each level of ``multi_scale_3d_features`` (x_conv1..3 the decoder's
    outputs, x_conv4 the encoder's): keys exact, features within rtol 1e-4,
    in JAX's row order (per-sample blocks on host tables, batch-flat on
    device tables); PartA2_free has no encoded tensor."""
    out, tout, _ = eval_run(name, rulebooks)
    for lvl, ref in out['multi_scale_3d_features'].items():
        got = tout['multi_scale_3d_features'][lvl]
        assert_equal(got.keys, np.asarray(ref.keys).astype(np.int64))
        assert_close(got.features, ref.features)
        assert float(np.abs(np.asarray(ref.features)).max()) > 0, lvl
    assert ('encoded_spconv_tensor' in tout) == (name == 'parta2')


@pytest.mark.parametrize('name,rulebooks', [('parta2', 'host'), ('parta2', 'device'),
                                            ('parta2_free', 'host')])
def test_unet_point_outputs_match_jax(name, rulebooks):
    """``point_features`` (B, cap, 16), the voxel centres ``point_coords``
    (padding at 1e4) and ``point_valid`` in per-sample blocks, held to
    JAX's on host tables whatever tables the port ran on."""
    _, tout, host = eval_run(name, rulebooks)
    assert_equal(tout['point_valid'], host['point_valid'])
    assert_close(tout['point_coords'], host['point_coords'])
    assert_close(tout['point_features'], host['point_features'])
    valid = np.asarray(host['point_valid'])
    assert (valid.sum(1) == 64).all()
    assert (np.asarray(host['point_coords'])[~valid] == 1e4).all()


def test_jax_device_tables_mix_samples_in_point_rows():
    """ROADMAP C12: JAX's UNetV2 on device tables reshapes the batch-flat
    top level into (B, cap) as it stands, so that block 0 holds both
    samples' 64 voxels and block 1 none; the port keeps each sample's."""
    out, tout, _ = eval_run('parta2', 'device')
    assert np.asarray(out['point_valid']).sum(1).tolist() == [128, 0]
    assert tout['point_valid'].sum(1).tolist() == [64, 64]


@pytest.mark.parametrize('name', sorted(CFGS))
def test_eval_detections_match_jax(name):
    """The part offsets and segmentation scores, the proposals, the RCNN
    head's logits and refined boxes, then cls-score NMS."""
    out, tout, _ = eval_run(name, 'host')
    for key in ('point_cls_scores', 'point_part_offset', 'rois', 'roi_scores'):
        assert_close(tout[key], out[key])
    for key in ('roi_valid', 'roi_labels', 'pred_valid', 'pred_labels'):
        assert_equal(tout[key], out[key])
    for key in ('batch_cls_preds', 'batch_box_preds', 'pred_scores'):
        assert_close(tout[key], out[key])
    valid = np.asarray(out['pred_valid'])
    assert_close(tout['pred_boxes'][t(valid)], np.asarray(out['pred_boxes'])[valid])
    assert valid.sum() > 0 and np.asarray(out['roi_valid']).sum() > 4


# ------------------------------------------------------------- optimizers

def optim_cfg(name):
    return {'OPTIMIZER': name, 'LR': 0.01, 'WEIGHT_DECAY': 0.05, 'MOMENTUM': 0.85,
            'GRAD_NORM_CLIP': 1.0}


@pytest.mark.parametrize('name', ['adam', 'sgd'])
def test_adam_and_sgd_match_optax(name):
    """Three steps from the same parameters and gradients, the gradients'
    global norm above GRAD_NORM_CLIP each step (clipped) but the last;
    rtol 1e-6. The state of the port is what optax keeps."""
    rng = np.random.RandomState(7)
    shapes = [(4, 3), (5,), (2, 2, 2)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[rng.randn(*s).astype(np.float32) * scale for s in shapes]
             for scale in (2.0, 1.5, 0.1)]
    jcfg = JaxEasyDict(optim_cfg(name))
    tx = jax_optim.build_optimizer(StaticConfig(jcfg), 100)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(t(p)) for p in params]
    opt = torch_optim.build_optimizer(tp, EasyDict(optim_cfg(name)), 100)
    for g in grads:
        upd, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, x in zip(tp, g):
            p.grad = t(x)
        opt.clip_grads()
        opt.step()
        for a, r in zip(tp, jp):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(r), rtol=1e-6, atol=1e-7)
    assert opt.count == 3 and opt.hyperparams()[0] == 0.01
    assert sum(float(np.abs(np.asarray(r) - p).max()) for r, p in zip(jp, params)) > 0.01


def test_unknown_optimizer_raises():
    with pytest.raises(NotImplementedError, match='adam_onecycle, adam and sgd'):
        torch_optim.build_optimizer([], EasyDict(optim_cfg('lamb')), 10)


@pytest.mark.parametrize('warmup', [False, True])
def test_decay_lr_schedule_matches_jax(warmup):
    args = (0.01, [3, 5], 0.1, 2e-5, 10)
    ref = jax_optim.decay_lr_schedule(*args, warmup_epoch=2, warmup=warmup)
    got = torch_optim.decay_lr_schedule(*args, warmup_epoch=2, warmup=warmup)
    for step in (0, 1, 7, 19, 20, 29, 30, 49, 50, 80):
        assert got(step) == float(ref(step)), step
    assert got(60) == pytest.approx(0.01 * 0.1 * 0.1, rel=1e-6)


# ------------------------------------------------------------------ yamls

def _jax_param_count(path):
    """Parameters of the JAX model of a yaml, from an abstract init on the
    tiny compact batch with host tables (no parameter shape depends on the
    grid: the tiny grid's 40 z cells give KITTI's 256 BEV channels)."""
    cfg = JaxEasyDict()
    jax_cfg_from_yaml_file(str(path), cfg)
    meta = jax_meta_from_cfg(cfg.DATA_CONFIG, 'test')
    jax_np, _, tiny_meta = model_batches('host')
    v = jax_np['voxels']
    nf = meta['num_point_features']
    jax_np['voxels'] = np.pad(v, ((0, 0),) * 3 + ((0, nf - v.shape[-1]),))
    jmodel = jax_build_network(cfg.MODEL, num_class=len(cfg.CLASS_NAMES),
                               class_names=cfg.CLASS_NAMES,
                               dataset_meta=dict(tiny_meta, num_point_features=nf))
    ev = {k: v for k, v in to_jax(jax_np).items() if k != 'gt_boxes'}
    shapes = jax.eval_shape(lambda b: jmodel.init(jax.random.PRNGKey(0), b), ev)
    return sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes['params']))


@pytest.mark.parametrize('yaml_path', PARTA2_YAMLS)
def test_parta2_yaml_builds_at_full_width(yaml_path):
    """Each yaml builds on the CPU with the JAX model's parameter count, the
    RoI head's first FC over POOL_SIZE^3 x 128 channels-last inputs, and
    a UNetV2 that takes the loader's host rulebooks."""
    from fv2p_torch.models.backbones_3d import reads_host_tables
    path = REPO / 'tools/cfgs' / yaml_path
    cfg = EasyDict()
    cfg_from_yaml_file(str(path), cfg)
    meta = dataset_meta_from_cfg(cfg.DATA_CONFIG, 'test')
    model = torch_models.build_network(cfg.MODEL, len(cfg.CLASS_NAMES), cfg.CLASS_NAMES,
                                       meta, compute_dtype=torch.bfloat16, device='cpu')
    assert type(model).__name__ == ('PointRCNN' if 'free' in yaml_path else 'PartA2Net')
    assert sum(p.numel() for p in model.parameters()) == _jax_param_count(path)
    s = int(cfg.MODEL.ROI_HEAD.ROI_AWARE_POOL.POOL_SIZE)
    assert model.roi_head.shared_fc0.in_features == s ** 3 * 128
    assert model.backbone_3d.return_encoded == ('free' not in yaml_path)
    assert reads_host_tables(cfg.MODEL.BACKBONE_3D.NAME)
