"""The PyTorch port of FV2P inference against the JAX package on the CPU.

One tiny FV2P model (``TINY_FV2P_CFG``) is initialised in JAX, its
BatchNorm statistics perturbed so every affine map is exercised, and its
variables carried into ``fv2p_torch`` with ``load_flax_variables``. Each
port module then runs on the JAX module's own inputs and is held against
the JAX module's outputs; the whole slice runs end to end from the same
numpy batch.

Off the TPU, ``fv2p_tpu`` computes 3-NN distances by the matmul expansion,
whereas the Pallas kernel (and the port) use elementwise differences
(``pointops.py:199-228``). The JAX run here therefore routes
``three_nn_interpolate`` through ``three_nn_pallas(interpret=True)``, the
function the JAX package runs on its accelerator.

Tolerances: integer outputs (indices, valid flags, labels) are exact; float
outputs use rtol 1e-4 with atol 1e-4 scaled down to the output's own
magnitude where that is below 1 (``assert_close``).
"""
import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fv2p_tpu.config import StaticConfig
from fv2p_tpu.models import build_network as jax_build_network
from fv2p_tpu.models.dense_heads.anchor_head import AnchorHeadSingle as JaxAnchorHead
from fv2p_tpu.models.roi_heads import iouguided_roi_head as jax_roi
from fv2p_tpu.ops import pointops as jax_pointops
from fv2p_tpu.ops.pallas.three_nn import three_nn_pallas
from fv2p_tpu.ops.sparse import host_rulebook as jax_host_rulebook
from tests.jitu import japply, jinit
from tests.test_fv2p_model import TINY_FV2P_CFG, make_fv2p_batch

import fv2p_torch.models as torch_models
from fv2p_torch.config import EasyDict, cfg_from_yaml_file
from fv2p_torch.datasets import dataset_meta_from_cfg
from fv2p_torch.models.roi_heads import iouguided_roi_head as torch_roi
from fv2p_torch.ops.sparse import host_rulebook as torch_host_rulebook
from fv2p_torch.ops.sparse.sparse_tensor import SparseTensor
from fv2p_torch.utils.synthetic import batch_to_torch, synthetic_batch_np
from fv2p_torch.weights import load_flax_variables

REPO = Path(__file__).resolve().parent.parent
TOL = 1e-4
BACKBONE = 'VoxelResBackBone8x'


def assert_close(actual, ref, tol=TOL):
    """|actual - ref| <= tol * |ref| + tol * min(1, max |ref|)."""
    a = actual.detach().float().numpy() if torch.is_tensor(actual) \
        else np.asarray(actual, np.float32)
    r = np.asarray(ref, np.float32)
    assert a.shape == r.shape, (a.shape, r.shape)
    scale = min(1.0, float(np.abs(r).max())) if r.size else 1.0
    np.testing.assert_allclose(a, r, rtol=tol, atol=tol * scale)


def assert_equal(actual, ref):
    a = actual.numpy() if torch.is_tensor(actual) else np.asarray(actual)
    np.testing.assert_array_equal(a, np.asarray(ref))


def t(x):
    return torch.from_numpy(np.array(x))


def perturb_bn(tree, rng, path=()):
    """Nontrivial BatchNorm statistics and affines (a seeded numpy tree)."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, 'items'):
            out[k] = perturb_bn(v, rng, path + (k,))
            continue
        v = np.array(v)
        is_bn = any('bn' in p or 'BatchNorm' in p for p in path)
        if k == 'mean':
            v = v + rng.uniform(-0.05, 0.05, v.shape).astype(np.float32)
        elif k == 'var':
            v = v * rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k == 'scale':
            v = v * rng.uniform(0.8, 1.2, v.shape).astype(np.float32)
        elif k == 'bias' and is_bn:
            v = v + rng.uniform(-0.02, 0.02, v.shape).astype(np.float32)
        out[k] = v
    return out


def _three_nn_interpolate_pallas(src_xyz, src_valid, src_feats, query_xyz,
                                 **_):
    """``pointops.three_nn_interpolate``'s accelerator branch, with the
    Pallas kernel in interpret mode."""
    d, idx = three_nn_pallas(src_xyz, src_valid, query_xyz, interpret=True)
    w = 1.0 / (d + 1e-8)
    w = w / jnp.sum(w, axis=-1, keepdims=True)
    return jnp.sum(src_feats[idx] * w[..., None], axis=1)


def make_rulebook_batches(batch_size=2, seed=0):
    """The tiny FV2P numpy batch with host rulebooks, built once by each
    package's own host_rulebook copy. Returns (jax_np, torch_np, meta)."""
    batch, meta = make_fv2p_batch(batch_size=batch_size, seed=seed)
    base = {k: np.array(v) for k, v in batch.items() if k != 'gt_boxes'}
    jax_np, torch_np = copy.deepcopy(base), copy.deepcopy(base)
    jax_host_rulebook.prepare_batch_rulebooks(jax_np, BACKBONE, meta['grid_size'])
    torch_host_rulebook.prepare_batch_rulebooks(torch_np, BACKBONE,
                                                meta['grid_size'])
    return jax_np, torch_np, meta


def to_jax(batch_np):
    return {k: ({kk: jnp.asarray(vv) for kk, vv in v.items()}
                if isinstance(v, dict) else jnp.asarray(v))
            for k, v in batch_np.items()}


def sparse_to_torch(st):
    return SparseTensor(features=t(st.features),
                        keys=t(st.keys).to(torch.int64),
                        spatial_shape=st.spatial_shape,
                        batch_size=st.batch_size, sample_cap=st.sample_cap)


@pytest.fixture(scope='module')
def run():
    jax_np, torch_np, meta = make_rulebook_batches()
    jmodel = jax_build_network(TINY_FV2P_CFG, num_class=1, class_names=['Car'],
                               dataset_meta=meta)
    jb = to_jax(jax_np)
    variables = jinit(jmodel, {'params': jax.random.PRNGKey(0),
                               'sampling': jax.random.PRNGKey(1),
                               'dropout': jax.random.PRNGKey(2)}, dict(jb))
    vnp = perturb_bn(jax.tree_util.tree_map(np.asarray, dict(variables)),
                     np.random.RandomState(0))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_pointops, 'three_nn_interpolate',
                   _three_nn_interpolate_pallas)
        out = japply(jmodel, jax.tree_util.tree_map(jnp.asarray, vnp), dict(jb))

    tmodel = torch_models.build_network(TINY_FV2P_CFG, 1, ['Car'], meta,
                                        device='cpu')
    load_flax_variables(tmodel, vnp)
    tout = tmodel(batch_to_torch(torch_np, 'cpu'))
    return {'meta': meta, 'vars': vnp, 'out': out, 'tmodel': tmodel,
            'tout': tout, 'torch_np': torch_np, 'jax_np': jax_np}


def test_host_rulebooks_match(run):
    jr, tr = run['jax_np']['rulebooks'], run['torch_np']['rulebooks']
    assert sorted(jr) == sorted(tr)
    for k in jr:
        assert_equal(tr[k], jr[k])
    for k in ('voxels', 'voxel_coords', 'voxel_num_points'):
        assert_equal(run['torch_np'][k], run['jax_np'][k])


def test_synthetic_batch_matches_bench_builder():
    """The port's bench batch equals the JAX package's (``_synthetic_batch``
    as ``bench.py`` calls it) array for array, rulebooks included."""
    import __graft_entry__ as ge
    cfg = EasyDict()
    cfg_from_yaml_file(str(REPO / 'tools/cfgs/kitti_models/FV2P/fv2p.yaml'), cfg)
    meta = dataset_meta_from_cfg(cfg.DATA_CONFIG, 'train')
    ref = ge._synthetic_batch(meta, 2, 3000, 500, seed=3, host_rulebooks=True,
                              n_points=700)
    got = synthetic_batch_np(meta, 2, 3000, 500, 700, seed=3)
    assert sorted(got) == sorted(ref)
    assert sorted(got['rulebooks']) == sorted(ref['rulebooks'])
    for k, v in got.items():
        for kk, vv in (v.items() if isinstance(v, dict) else [(None, v)]):
            r = ref[k][kk] if kk else ref[k]
            assert_equal(vv, r)


def test_vfe_and_sparse_backbone(run):
    m = run['tmodel']
    bd = m.backbone_3d(m.vfe(batch_to_torch(run['torch_np'], 'cpu')))
    ref = run['out']['multi_scale_3d_features']
    for lvl in ('x_conv1', 'x_conv2', 'x_conv3', 'x_conv4'):
        got = bd['multi_scale_3d_features'][lvl]
        valid = np.array(ref[lvl].valid_mask())
        assert_equal(got.valid_mask(), valid)
        assert_equal(got.keys[t(valid)], np.asarray(ref[lvl].keys)[valid])
        assert_close(got.features, ref[lvl].features)
    assert_close(bd['encoded_spconv_tensor'].features,
                 run['out']['encoded_spconv_tensor'].features)


def test_height_compression(run):
    bd = {'encoded_spconv_tensor':
          sparse_to_torch(run['out']['encoded_spconv_tensor']),
          'encoded_spconv_tensor_stride': 8}
    bd = run['tmodel'].map_to_bev_module(bd)
    assert_close(bd['spatial_features'], run['out']['spatial_features'])


def test_bev_backbone(run):
    bd = run['tmodel'].backbone_2d(
        {'spatial_features': t(run['out']['spatial_features'])})
    assert_close(bd['spatial_features_2d'],
                 run['out']['spatial_features_before_head'])


def _jax_dense_head(run):
    meta = run['meta']
    head = JaxAnchorHead(
        model_cfg=StaticConfig(TINY_FV2P_CFG.DENSE_HEAD),
        input_channels=int(sum(TINY_FV2P_CFG.BACKBONE_2D.NUM_UPSAMPLE_FILTERS)),
        num_class=1, class_names=('Car',), grid_size=tuple(meta['grid_size']),
        point_cloud_range=tuple(meta['point_cloud_range']))
    return head.apply({'params': run['vars']['params']['dense_head']},
                      {'spatial_features_2d':
                       run['out']['spatial_features_before_head']})


def test_anchor_head(run):
    ref = _jax_dense_head(run)
    bd = run['tmodel'].dense_head(
        {'spatial_features_2d': t(run['out']['spatial_features_before_head'])})
    assert_close(bd['batch_cls_preds'], ref['batch_cls_preds'])
    assert_close(bd['batch_box_preds'], ref['batch_box_preds'])


def test_proposal_layer(run):
    ref_head = _jax_dense_head(run)
    nms_cfg = TINY_FV2P_CFG.ROI_HEAD.NMS_CONFIG.TEST
    ref = jax_roi.proposal_layer(ref_head['batch_box_preds'],
                                 ref_head['batch_cls_preds'], nms_cfg)
    got = torch_roi.proposal_layer(t(ref_head['batch_box_preds']),
                                   t(ref_head['batch_cls_preds']), nms_cfg)
    assert_equal(got[3], ref[3])              # keep_valid
    assert_equal(got[2], ref[2])              # labels
    assert_close(got[0], ref[0])              # rois
    assert_close(got[1], ref[1])              # scores
    assert bool(np.asarray(ref[3]).any())


def test_residual_v2p_decoder(run):
    out = run['out']
    bd = {'points': t(run['torch_np']['points']),
          'points_valid': t(run['torch_np']['points_valid']),
          'multi_scale_3d_features': {k: sparse_to_torch(v) for k, v in
                                      out['multi_scale_3d_features'].items()},
          'multi_scale_3d_strides': {k: int(v) for k, v in
                                     out['multi_scale_3d_strides'].items()}}
    bd = run['tmodel'].post_pfe(bd)
    assert_equal(bd['point_coords'], out['point_coords'])
    assert_close(bd['point_features'], out['point_features'])


def test_point_head(run):
    out = run['out']
    bd = run['tmodel'].point_head({'point_features': t(out['point_features']),
                                   'point_coords': t(out['point_coords'])})
    assert_close(bd['point_cls_scores'], out['point_cls_scores'])


def test_iouguided_roi_head(run):
    out = run['out']
    head = _jax_dense_head(run)
    bd = {k: t(out[k]) for k in ('point_coords', 'point_features',
                                 'point_cls_scores',
                                 'spatial_features_before_head')}
    bd.update(spatial_features_stride=8,
              batch_box_preds=t(head['batch_box_preds']),
              batch_cls_preds=t(head['batch_cls_preds']))
    bd = run['tmodel'].roi_head(bd)
    assert_equal(bd['roi_valid'], out['roi_valid'])
    assert_close(bd['rois'], out['rois'])
    assert_close(bd['batch_cls_preds'], out['batch_cls_preds'])
    assert_close(bd['batch_box_preds'], out['batch_box_preds'])
    assert_close(bd['batch_iouscore_preds'], out['batch_iouscore_preds'])


def test_full_slice_predictions(run):
    out, tout = run['out'], run['tout']
    assert_equal(tout['pred_valid'], out['pred_valid'])
    assert_equal(tout['pred_labels'], out['pred_labels'])
    assert_close(tout['pred_boxes'], out['pred_boxes'])
    assert_close(tout['pred_scores'], out['pred_scores'])
    assert np.asarray(out['pred_valid']).sum() > 0


def three_class_cfg():
    """TINY_FV2P_CFG with the three anchor classes of fv2p_3classes.yaml
    (Car, Pedestrian, Cyclist)."""
    full = EasyDict()
    cfg_from_yaml_file(str(REPO / 'tools/cfgs/kitti_models/FV2P/fv2p_3classes.yaml'), full)
    cfg = copy.deepcopy(TINY_FV2P_CFG)
    cfg.DENSE_HEAD.ANCHOR_GENERATOR_CONFIG = copy.deepcopy(
        full.MODEL.DENSE_HEAD.ANCHOR_GENERATOR_CONFIG)
    return cfg, list(full.CLASS_NAMES)


def test_three_class_fv2p_forward_matches_jax():
    """The tiny FV2P with three anchor classes, eval forward end to end:
    the RoI labels (the RPN's best class of each kept proposal) and the
    final labels exactly, boxes and scores at rtol 1e-4."""
    cfg, classes = three_class_cfg()
    jax_np, torch_np, meta = make_rulebook_batches()
    jmodel = jax_build_network(cfg, num_class=3, class_names=classes, dataset_meta=meta)
    jb = to_jax(jax_np)
    variables = jinit(jmodel, {'params': jax.random.PRNGKey(5),
                               'sampling': jax.random.PRNGKey(1),
                               'dropout': jax.random.PRNGKey(2)}, dict(jb))
    vnp = perturb_bn(jax.tree_util.tree_map(np.asarray, dict(variables)),
                     np.random.RandomState(5))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_pointops, 'three_nn_interpolate', _three_nn_interpolate_pallas)
        out = japply(jmodel, jax.tree_util.tree_map(jnp.asarray, vnp), dict(jb))
    tmodel = torch_models.build_network(cfg, 3, classes, meta, device='cpu')
    load_flax_variables(tmodel, vnp)
    tout = tmodel(batch_to_torch(torch_np, 'cpu'))
    assert_equal(tout['roi_valid'], out['roi_valid'])
    assert_equal(tout['roi_labels'], out['roi_labels'])
    assert_close(tout['rois'], out['rois'])
    for key in ('batch_cls_preds', 'batch_box_preds', 'batch_iouscore_preds'):
        assert_close(tout[key], out[key])
    assert_equal(tout['pred_valid'], out['pred_valid'])
    assert_equal(tout['pred_labels'], out['pred_labels'])
    assert_close(tout['pred_boxes'], out['pred_boxes'])
    assert_close(tout['pred_scores'], out['pred_scores'])
    labels = np.asarray(out['roi_labels'])[np.asarray(out['roi_valid'])]
    assert len(set(labels.tolist())) > 1
    assert np.asarray(out['pred_valid']).sum() > 0
