"""PV-RCNN and Voxel R-CNN in the PyTorch port against the JAX package on the
CPU.

* The bounded-memory ball query (``pointops.ball_query_rows`` +
  ``group_rows``) against JAX's dense ``ball_query_group`` (both its
  ``gather`` and ``onehot`` forms): per-sample point sets and the
  batch-flat masked form of a sparse level, with empty balls, balls with
  fewer hits than nsample, invalid rows inside a sample's range and an
  empty sample, at chunk sizes that split a sample's sources and its
  queries. Rows exact, grouped outputs equal.
* The tiny ``PVRCNN_CFG`` and ``VOXELRCNN_CFG`` of
  ``tests/test_model_zoo.py``, initialised in flax, BatchNorm statistics
  perturbed, carried across by ``load_flax_variables``: VSA's features per
  source, the pooled RoI-grid features and the eval predictions (their
  training: ``tests/test_torch_pvrcnn_train.py``).
* The five PV-RCNN and Voxel R-CNN yamls at full width, with JAX's
  parameter counts.

The batch is ``tests/test_torch_zoo.compact_batch`` (scattered voxels
dilate past the derived level capacities, where JAX drops rows) with raw
points drawn around its voxels. The RoI sampling draws from ``jax.random``
in JAX and from a ``torch.Generator`` in the port: the tests pin JAX's key
and feed the port JAX's draws, as ``tests/test_torch_train.py`` does.

Tolerances as there: integers exact, floats rtol 1e-4 (``assert_close``),
gradients, statistics and parameters within 1e-4 max|ref| + 1e-7.
"""
import copy
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fv2p_tpu.config import EasyDict as JaxEasyDict
from fv2p_tpu.models import build_network as jax_build_network
from fv2p_tpu.ops import pointops as jax_pointops
from tests.jitu import jinit
from tests.test_model_zoo import PVRCNN_CFG, VOXELRCNN_CFG
from tests.test_torch_model import assert_close, assert_equal, perturb_bn
from tests.test_torch_package import _jax_param_count
from tests.test_torch_zoo import compact_batch

import fv2p_torch.models as torch_models
from fv2p_torch.config import EasyDict, cfg_from_yaml_file
from fv2p_torch.datasets import dataset_meta_from_cfg
from fv2p_torch.ops import pointops
from fv2p_torch.utils.synthetic import batch_to_torch
from fv2p_torch.weights import init_random_, load_flax_variables
from tests.test_torch_model import one_torch_thread  # noqa: F401 (an autouse fixture)

REPO = Path(__file__).resolve().parent.parent
CFGS = {'pvrcnn': PVRCNN_CFG, 'voxelrcnn': VOXELRCNN_CFG}
TRAIN_STEPS = 5
FIVE_STEPS_TOTAL = 100          # the one-cycle schedule's length


def t(x):
    return torch.from_numpy(np.array(x))


# ------------------------------------------------------------- ball query

RADII, NSAMPLES = (0.3, 0.8), (4, 6)


def _ball_case(seed=0):
    """Three samples of 9, 0 and 23 sources around one center each (every
    fourth row invalid), 13 queries a sample: near the center (balls fuller
    than nsample), at its edge (fewer hits) and 10 m away (empty)."""
    rng = np.random.RandomState(seed)
    counts, m = (9, 0, 23), 13
    xyz, valid, feats, queries = [], [], [], []
    for b, n in enumerate(counts):
        center = rng.uniform(-5, 5, 3)
        xyz.append(center + rng.randn(n, 3) * 0.4)
        v = np.ones(n, bool)
        v[3::4] = False
        valid.append(v)
        feats.append(rng.randn(n, 5))
        q = center + rng.randn(m, 3) * 0.3
        q[8:11] += rng.randn(3, 3) * 0.9
        q[11:] += 10.0
        queries.append(q)
    f32 = lambda a: np.asarray(a, np.float32)
    return counts, f32(queries), [f32(x) for x in xyz], valid, [f32(x) for x in feats]


def _jax_ball(q, x, v, f, r, ns, via):
    """JAX's first-k rows and grouped outputs of one query set."""
    d2 = jnp.sum(jnp.square(q[:, None, :] - x[None, :, :]), axis=-1)
    rows = jax_pointops._first_k_hits((d2 < r * r) & v[None, :], ns)
    return np.asarray(rows), jax_pointops.ball_query_group(q, x, v, f, r, ns, via=via)


@pytest.mark.parametrize('max_pairs', [1, 7, 50, pointops.BALL_QUERY_PAIRS])
@pytest.mark.parametrize('via', ['gather', 'onehot'])
@pytest.mark.parametrize('layout', ['per_sample', 'batch_flat'])
def test_chunked_ball_query_matches_jax(layout, via, max_pairs):
    """``max_pairs`` 1 and 7 split each sample's sources into blocks whose
    first hits are appended; 50 splits the queries of the 23-row sample."""
    counts, queries, xyz, valid, feats = _ball_case()
    b, m = len(counts), queries.shape[1]
    if layout == 'per_sample':
        # each sample padded to 23 rows: the padding invalid
        n = max(counts)
        pad = lambda a, fill: np.stack([np.concatenate(
            [x, np.full((n - len(x),) + x.shape[1:], fill, x.dtype)]) for x in a])
        sx, sv, sf = pad(xyz, 0.0), pad(valid, False), pad(feats, 0.0)
        flat = (sx.reshape(-1, 3), sv.reshape(-1), sf.reshape(b * n, -1))
        bounds = [i * n for i in range(b + 1)]
        ref = [[_jax_ball(queries[i], sx[i], sv[i], sf[i], r, ns, via) for i in range(b)]
               for r, ns in zip(RADII, NSAMPLES)]
        offsets = bounds[:-1]
    else:
        # one batch-flat array, samples in order, 4 invalid rows at the tail;
        # JAX searches all rows for every sample with the others' masked
        tail = 4
        sx = np.concatenate(xyz + [queries[0, :tail]])        # junk near the queries
        sv = np.concatenate(valid + [np.zeros(tail, bool)])
        sf = np.concatenate(feats + [np.ones((tail, 5), np.float32)])
        bidx = np.concatenate([np.full(c, i) for i, c in enumerate(counts)]
                              + [np.zeros(tail, int)])
        flat = (sx, sv, sf)
        bounds = np.cumsum([0] + list(counts)).tolist()
        ref = [[_jax_ball(queries[i], sx, sv & (bidx == i), sf, r, ns, via) for i in range(b)]
               for r, ns in zip(RADII, NSAMPLES)]
        offsets = [0] * b
    rows = pointops.ball_query_rows(t(queries), t(flat[0]), t(flat[1]), bounds, RADII,
                                    NSAMPLES, max_pairs=max_pairs)
    counts_seen = set()
    for j, (r, ns) in enumerate(zip(RADII, NSAMPLES)):
        got = rows[j].numpy()
        assert got.shape == (b, m, ns)
        for i in range(b):
            ref_rows, (gx, gf, anyn) = ref[j][i]
            local = np.where(got[i] >= 0, got[i] - offsets[i], -1)
            assert_equal(local, ref_rows)
            counts_seen.update((ref_rows >= 0).sum(1).tolist())
        tx, tf, tany = pointops.group_rows(t(queries), t(flat[0]), t(flat[2]), rows[j])
        for i in range(b):
            _, (gx, gf, anyn) = ref[j][i]
            assert_equal(tx[i], gx)
            assert_equal(tf[i], gf)
            assert_equal(tany[i], anyn)
    # empty balls, partly filled and full ones all occur
    assert 0 in counts_seen and max(NSAMPLES) in counts_seen
    assert counts_seen & set(range(1, min(NSAMPLES)))


# ----------------------------------------------------------------- models

def pv_batch(seed=0, p_cap=256):
    """``compact_batch`` with each scan's raw points (``p_cap`` rows, the
    last 16 padding) drawn from its voxels' points and moved by up to
    0.3 m."""
    batch_np, meta = compact_batch(seed=seed)
    rng = np.random.RandomState(seed + 11)
    b = batch_np['voxels'].shape[0]
    pts = np.zeros((b, p_cap, 4), np.float32)
    pv = np.zeros((b, p_cap), bool)
    for i in range(b):
        cand = batch_np['voxels'][i][batch_np['voxel_valid'][i]].reshape(-1, 4)
        cand = cand[np.abs(cand[:, :3]).sum(1) > 0]
        n = p_cap - 16
        pick = cand[rng.randint(0, len(cand), n)]
        pick[:, :3] += rng.uniform(-0.3, 0.3, (n, 3))
        pts[i, :n], pv[i, :n] = pick, True
    batch_np.update(points=pts, points_valid=pv)
    return batch_np, meta


def jax_setup(cfg, batch_np, meta, seed=0):
    """The flax model, its batch and its perturbed variables (numpy); the
    anchor head's class bias at 0 so that proposals clear SCORE_THRESH."""
    jmodel = jax_build_network(cfg, num_class=1, class_names=['Car'], dataset_meta=meta)
    jb = {k: jnp.asarray(v) for k, v in batch_np.items()}
    variables = jinit(jmodel, {'params': jax.random.PRNGKey(seed),
                               'sampling': jax.random.PRNGKey(1),
                               'dropout': jax.random.PRNGKey(2)},
                      {k: v for k, v in jb.items() if k != 'gt_boxes'})
    vnp = perturb_bn(jax.tree_util.tree_map(np.asarray, dict(variables)),
                     np.random.RandomState(seed))
    vnp['params']['dense_head']['conv_cls']['bias'][:] = 0.0
    return jmodel, jb, vnp


def torch_model(cfg, meta, vnp):
    return load_flax_variables(torch_models.build_network(cfg, 1, ['Car'], meta,
                                                          device='cpu'), vnp)


def last_pool_bns(cfg):
    """The BatchNorm of each RoI-grid pooling MLP's last layer: the pooled
    features are the max of its ReLU over a ball's slots."""
    pool = cfg.ROI_GRID_POOL
    if cfg.NAME == 'PVRCNNHead':
        return [f'pool_bn{i}_{len(m) - 1}' for i, m in enumerate(pool.MLPS)]
    return [f'{s}_bn{i}_{len(m) - 1}' for s in pool.FEATURES_SOURCE
            for i, m in enumerate(pool.POOL_LAYERS[s].MLPS)]


@functools.lru_cache(maxsize=None)
def eval_run(name):
    """The eval forward of both packages from the same variables; the
    pooled RoI-grid features from the last pooling BatchNorms' outputs
    (captured intermediates in flax, forward hooks in the port); the port's
    ball-query rows per call."""
    cfg = CFGS[name]
    batch_np, meta = pv_batch()
    batch_np.pop('gt_boxes')
    jmodel, jb, vnp = jax_setup(cfg, batch_np, meta)
    bns = last_pool_bns(cfg.ROI_HEAD)
    fn = jax.jit(lambda v, b: jmodel.apply(
        v, b, capture_intermediates=lambda mdl, meth: meth == '__call__' and mdl.name in bns,
        mutable=['intermediates']))
    out, state = fn(jax.tree_util.tree_map(jnp.asarray, vnp), dict(jb))
    inter = state['intermediates']['roi_head']
    tmodel = torch_model(cfg, meta, vnp)
    pooled_t, hooks, ball_rows = {}, [], []
    for n in bns:
        hooks.append(getattr(tmodel.roi_head, n).register_forward_hook(
            lambda m, a, o, n=n: pooled_t.__setitem__(n, o)))
    orig = pointops.ball_query_rows

    def recording(*a, **k):
        ball_rows.append(orig(*a, **k))
        return ball_rows[-1]
    pointops.ball_query_rows = recording
    try:
        tout = tmodel(batch_to_torch(batch_np, 'cpu'))
    finally:
        pointops.ball_query_rows = orig
        for h in hooks:
            h.remove()
    pooled = {}
    for n in bns:
        got = pooled_t[n]                                   # (B, R * G, S, C)
        ref = np.asarray(inter[n]['__call__'][0]).reshape(got.shape)
        pooled[n] = (torch.relu(got).amax(dim=2), np.maximum(ref, 0).max(axis=2))
    return {'out': out, 'tout': tout, 'tmodel': tmodel, 'pooled': pooled,
            'ball_rows': ball_rows}


def test_vsa_features_match_jax():
    """PV-RCNN's keypoints, ``point_features_before_fusion`` source by
    source (bev, raw_points, x_conv3, x_conv4) and ``point_features``; most
    keypoints' balls hold points at every source and radius."""
    s = eval_run('pvrcnn')
    out, tout, pfe = s['out'], s['tout'], s['tmodel'].pfe
    assert_equal(tout['point_coords'], out['point_coords'])
    widths = [('bev', pfe.num_point_features_before_fusion - pfe.sa_rawpoints.out_channels
               - sum(getattr(pfe, f'sa_{n}').out_channels for n in pfe.levels)),
              ('raw_points', pfe.sa_rawpoints.out_channels)]
    widths += [(n, getattr(pfe, f'sa_{n}').out_channels) for n in pfe.levels]
    assert [w[0] for w in widths] == ['bev', 'raw_points', 'x_conv3', 'x_conv4']
    got, ref = tout['point_features_before_fusion'], np.asarray(out['point_features_before_fusion'])
    assert got.shape[-1] == sum(w for _, w in widths) == ref.shape[-1]
    c0 = 0
    for name, w in widths:
        assert_close(got[..., c0:c0 + w], ref[..., c0:c0 + w])
        assert float(np.abs(ref[..., c0:c0 + w]).max()) > 0, name
        c0 += w
    assert_close(tout['point_features'], out['point_features'])
    # VSA's three grouping calls (raw points, x_conv3, x_conv4), per radius
    for rows in s['ball_rows'][:3]:
        for r in rows:
            assert float((r[..., 0] >= 0).float().mean()) > 0.5


@pytest.mark.parametrize('name', sorted(CFGS))
def test_pooled_roi_grid_features_match_jax(name):
    s = eval_run(name)
    assert_close(s['tout']['rois'], s['out']['rois'])
    for n, (got, ref) in s['pooled'].items():
        assert_close(got, ref)
        assert float((ref > 0).mean()) > 0.1, n


@pytest.mark.parametrize('name', sorted(CFGS))
def test_eval_predictions_match_jax(name):
    """The RoI head's decoded boxes and class logits, then the cls-score
    post-processing: kept boxes, scores, labels, valid."""
    s = eval_run(name)
    out, tout = s['out'], s['tout']
    for key in ('batch_cls_preds', 'batch_box_preds'):
        assert_close(tout[key], out[key])
    assert_equal(tout['pred_valid'], out['pred_valid'])
    assert_equal(tout['pred_labels'], out['pred_labels'])
    valid = np.asarray(out['pred_valid'])
    assert_close(tout['pred_boxes'][t(valid)], np.asarray(out['pred_boxes'])[valid])
    assert_close(tout['pred_scores'], out['pred_scores'])
    assert valid.sum() > 4


# ------------------------------------------------------------ full width

PV_YAMLS = ('kitti_models/pv_rcnn.yaml', 'kitti_models/pv_rcnn_car.yaml',
            'waymo_models/pv_rcnn.yaml', 'kitti_models/voxel_rcnn/voxel_rcnn_car.yaml',
            'kitti_models/voxel_rcnn/voxel_rcnn_3classes.yaml')


@pytest.mark.parametrize('yaml_path', PV_YAMLS)
def test_pv_yaml_builds_at_full_width(yaml_path):
    """Each yaml builds on the CPU with the JAX model's parameter count;
    PV-RCNN's point head reads the channels before the fusion (640 on
    KITTI: bev 256, x_conv1..x_conv4 32 + 64 + 128 + 128, raw points 32;
    Waymo bev, x_conv3, x_conv4 and raw points: 544)."""
    cfg = EasyDict()
    cfg_from_yaml_file(str(REPO / 'tools/cfgs' / yaml_path), cfg)
    meta = dataset_meta_from_cfg(cfg.DATA_CONFIG, 'test')
    model = torch_models.build_network(cfg.MODEL, len(cfg.CLASS_NAMES), cfg.CLASS_NAMES,
                                       meta, compute_dtype=torch.bfloat16, device='cpu')
    init_random_(model, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    jcfg = JaxEasyDict(copy.deepcopy(dict(cfg.MODEL)))
    assert n_params == _jax_param_count(jcfg, cfg.CLASS_NAMES, meta['num_point_features'])
    if cfg.MODEL.NAME == 'PVRCNN':
        width = model.pfe.num_point_features_before_fusion
        assert model.point_head.cls_fc0.in_features == width
        assert width == (640 if yaml_path.startswith('kitti') else 544)
    assert float(model.roi_head.reg_out.weight.detach().std()) < 0.01
