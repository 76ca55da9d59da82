"""SECOND and PointPillar in the PyTorch port against the JAX package on the
CPU, and the port's ``model_nms_utils``.

The tiny configs of ``tests/test_model_zoo.py`` (``SECOND_CFG``,
``PILLAR_CFG``) are initialised in JAX, their BatchNorm statistics
perturbed and their classification bias raised to 0 (JAX's init puts every
anchor at sigmoid 0.01, under SCORE_THRESH 0.1, so nothing would reach the
NMS), and carried into ``fv2p_torch``: the eval forward with its cls-score
post-processing, the ``MULTI_CLASSES_NMS`` branch with three classes, and
the loss terms and gradients of one train step. SECOND's sparse backbone
builds its rulebooks on the device in both packages.

The batch is compact (each sample's voxels in one 8-voxel cube): scattered
random voxels dilate past the derived level capacities, where JAX drops
rows and builds the next level from the dropped ones too
(``tests/test_torch_device_mode.py``).

Tolerances as ``tests/test_torch_model.py`` and ``tests/test_torch_train.py``:
integers exact, floats rtol 1e-4, gradients within 1e-4 max|ref| + 1e-7.
"""
import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fv2p_tpu.config import EasyDict as JaxEasyDict
from fv2p_tpu.models import build_network as jax_build_network
from fv2p_tpu.models.detectors import detector3d_template as jax_det
from fv2p_tpu.models.model_utils import model_nms_utils as jax_nms_utils
from tests.jitu import japply, jgrad, jinit
from tests.test_mgaf_model import TINY_DATA_CFG
from tests.test_model_nms_utils import NMS_CFG, _boxes
from tests.test_model_zoo import PILLAR_CFG, SECOND_CFG
from tests.test_torch_model import assert_close, assert_equal, perturb_bn
from tests.test_torch_package import _jax_param_count
from tests.test_torch_train import close_by_max, flat_paths

import fv2p_torch.models as torch_models
from fv2p_torch.config import EasyDict, cfg_from_yaml_file
from fv2p_torch.datasets import dataset_meta_from_cfg
from fv2p_torch.models.detectors.detector3d_template import compute_training_loss
from fv2p_torch.models.model_utils import model_nms_utils
from fv2p_torch.utils.synthetic import batch_to_torch
from fv2p_torch.weights import flax_variables, init_random_, load_flax_variables
from tests.test_torch_model import one_torch_thread  # noqa: F401 (an autouse fixture)

REPO = Path(__file__).resolve().parent.parent
CFGS = {'second': SECOND_CFG, 'pointpillar': PILLAR_CFG}
THREE = ['Car', 'Pedestrian', 'Cyclist']


def compact_batch(batch_size=2, n_cap=128, seed=0, pillars=False):
    """The tiny data config's batch (``tests/test_mgaf_model.make_batch``'s
    layout) with each sample's voxels drawn from one cube of 8 voxels a
    side, and two gt cars near them; half the rows are padding. With ``pillars`` the voxels lie at z 0 in a 12 x 12 square,
    so that no two share a BEV cell, as pillars do not."""
    meta = dataset_meta_from_cfg(TINY_DATA_CFG, 'train')
    rng = np.random.RandomState(seed)
    nx, ny, nz = meta['grid_size']
    p = meta['max_points_per_voxel']
    voxels = np.zeros((batch_size, n_cap, p, 4), np.float32)
    coords = np.zeros((batch_size, n_cap, 3), np.int32)
    nums = np.zeros((batch_size, n_cap), np.int32)
    valid = np.zeros((batch_size, n_cap), bool)
    for b in range(batch_size):
        n = n_cap // 2
        lo = rng.randint(0, [nz - 12, ny - 12, nx - 12])
        if pillars:
            lin = rng.choice(12 ** 2, n, replace=False)
            coords[b, :n] = lo + np.stack([0 * lin - lo[0], lin % 12, lin // 12], 1)
        else:
            lin = rng.choice(8 ** 3, n, replace=False)
            coords[b, :n] = lo + np.stack([lin % 8, (lin // 8) % 8, lin // 64], 1)
        vs = np.asarray(meta['voxel_size'], np.float32)
        r0 = np.asarray(meta['point_cloud_range'][:3], np.float32)
        base = coords[b, :n, ::-1] * vs + r0                      # x, y, z corner
        voxels[b, :n, :, :3] = base[:, None] + rng.rand(n, p, 3) * vs
        voxels[b, :n, :, 3] = rng.rand(n, p)
        nums[b, :n] = rng.randint(1, p + 1, n)
        voxels[b, :n][np.arange(p)[None] >= nums[b, :n, None]] = 0.0
        valid[b, :n] = True
    gt = np.zeros((batch_size, 10, 8), np.float32)
    gt[:, 0] = [3.0, 0.0, -1.0, 3.7, 1.6, 1.5, 0.3, 1]
    gt[:, 1] = [1.5, -1.5, -1.0, 3.9, 1.6, 1.4, -0.5, 1]
    return {'voxels': voxels, 'voxel_coords': coords, 'voxel_num_points': nums,
            'voxel_valid': valid, 'gt_boxes': gt}, meta


def three_class(cfg, multi_classes_nms):
    """The tiny config with three anchor classes and, if asked, per-class
    NMS."""
    cfg = copy.deepcopy(cfg)
    base = cfg.DENSE_HEAD.ANCHOR_GENERATOR_CONFIG[0]
    cfg.DENSE_HEAD.ANCHOR_GENERATOR_CONFIG = [
        dict(base, class_name=name, anchor_sizes=[size])
        for name, size in zip(THREE, ([3.9, 1.6, 1.56], [0.8, 0.6, 1.73], [1.76, 0.6, 1.73]))]
    cfg.POST_PROCESSING.NMS_CONFIG.MULTI_CLASSES_NMS = multi_classes_nms
    return cfg


def jax_setup(cfg, classes, batch_np, meta, seed=0):
    jmodel = jax_build_network(cfg, num_class=len(classes), class_names=classes,
                               dataset_meta=meta)
    jb = {k: jnp.asarray(v) for k, v in batch_np.items()}
    variables = jinit(jmodel, jax.random.PRNGKey(seed), dict(jb))
    vnp = perturb_bn(jax.tree_util.tree_map(np.asarray, dict(variables)),
                     np.random.RandomState(seed))
    vnp['params']['dense_head']['conv_cls']['bias'][:] = 0.0
    return jmodel, jb, vnp


def torch_model(cfg, classes, meta, vnp):
    tmodel = torch_models.build_network(cfg, len(classes), classes, meta, device='cpu')
    return load_flax_variables(tmodel, vnp)


CASES = {'second': (SECOND_CFG, ['Car']), 'pointpillar': (PILLAR_CFG, ['Car']),
         'second_3cls': (three_class(SECOND_CFG, False), THREE),
         'second_multi_classes_nms': (three_class(SECOND_CFG, True), THREE),
         'pointpillar_multi_classes_nms': (three_class(PILLAR_CFG, True), THREE)}


@pytest.fixture(scope='module', params=sorted(CASES))
def eval_run(request):
    cfg, classes = CASES[request.param]
    batch_np, meta = compact_batch(pillars=request.param.startswith('pointpillar'))
    batch_np.pop('gt_boxes')
    jmodel, jb, vnp = jax_setup(cfg, classes, batch_np, meta)
    out = japply(jmodel, jax.tree_util.tree_map(jnp.asarray, vnp), dict(jb))
    tmodel = torch_model(cfg, classes, meta, vnp)
    tout = tmodel(batch_to_torch(batch_np, 'cpu'))
    return request.param, cfg, out, tout


def test_eval_features_match_jax(eval_run):
    """The BEV map, the head's predictions and their decode."""
    name, _, out, tout = eval_run
    for key in ('spatial_features', 'spatial_features_2d', 'batch_cls_preds',
                'batch_box_preds'):
        assert_close(tout[key], out[key])
    if name.startswith('second'):
        assert int(tout['rulebook_overflow'].sum()) == 0


def test_post_processing_matches_jax(eval_run):
    """cls-score NMS (per class with MULTI_CLASSES_NMS): kept boxes, scores
    and labels; shapes (B, post) or (B, C * post)."""
    name, cfg, out, tout = eval_run
    post = int(cfg.POST_PROCESSING.NMS_CONFIG.NMS_POST_MAXSIZE)
    n_cls = len(cfg.DENSE_HEAD.ANCHOR_GENERATOR_CONFIG)
    lanes = n_cls if cfg.POST_PROCESSING.NMS_CONFIG.MULTI_CLASSES_NMS else 1
    assert tuple(tout['pred_boxes'].shape) == (2, lanes * post, 7)
    assert_equal(tout['pred_valid'], out['pred_valid'])
    assert_equal(tout['pred_labels'], out['pred_labels'])
    valid = np.asarray(out['pred_valid'])
    assert_close(tout['pred_boxes'][torch.from_numpy(valid)],
                 np.asarray(out['pred_boxes'])[valid])
    assert_close(tout['pred_scores'], out['pred_scores'])
    assert valid.sum() > 0
    if lanes > 1:
        assert len(set(np.asarray(out['pred_labels'])[valid].tolist())) > 1


@pytest.fixture(scope='module', params=['second', 'pointpillar'])
def train_run(request):
    """One train step's loss terms and gradients. For PointPillar's pillar
    encoder (``vfe/*``) the reference gradients are JAX's eager
    ``jax.grad``, not its jitted ones: the PFN layer's max over a pillar's
    points ties among exact zeros after the ReLU, and under jit XLA fuses
    the BatchNorm before it into other roundings, so the tie set and with
    it the max's gradient move between slots (jitted and eager JAX differ
    there by up to half the gradient's size). Eager JAX rounds op by op,
    as the port does. Every other gradient is held to the jitted one, as in
    the other tests."""
    cfg, classes = CASES[request.param]
    pillars = request.param == 'pointpillar'
    batch_np, meta = compact_batch(pillars=pillars)
    jmodel, jb, vnp = jax_setup(cfg, classes, batch_np, meta)

    def loss_fn(params):
        o, _ = jmodel.apply({'params': params, 'batch_stats': vnp['batch_stats']},
                            dict(jb), train=True, mutable=['batch_stats'])
        loss, tb = jax_det.compute_training_loss(jmodel, o)
        return loss, (tb, o['anchor_head_ret']['box_cls_labels'])

    params = jax.tree_util.tree_map(jnp.asarray, vnp['params'])
    (loss, (tb, labels)), grads = jgrad(loss_fn, params)
    grads = flat_paths(grads)
    if pillars:
        _, eager = jax.value_and_grad(loss_fn, has_aux=True)(params)
        grads.update({k: v for k, v in flat_paths(eager).items() if k.startswith('vfe/')})
    tmodel = torch_model(cfg, classes, meta, vnp).train()
    tout = tmodel(batch_to_torch(batch_np, 'cpu'))
    tloss, tterms = compute_training_loss(tmodel, tout)
    tloss.backward()
    return {'tb': tb, 'loss': loss, 'labels': labels, 'grads': grads,
            'ttb': tterms, 'tloss': tloss, 'tout': tout,
            'tgrads': flat_paths(flax_variables(tmodel, grads=True)['params'])}


def test_train_losses_match_jax(train_run):
    s = train_run
    assert_equal(s['tout']['anchor_head_ret']['box_cls_labels'], s['labels'])
    assert (np.asarray(s['labels']) > 0).any()
    assert sorted(s['ttb']) == sorted(s['tb'])
    for k, v in s['tb'].items():
        np.testing.assert_allclose(float(s['ttb'][k].detach()), float(v), rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(float(s['tloss'].detach()), float(s['loss']), rtol=1e-4)


def test_train_gradients_match_jax(train_run):
    s = train_run
    assert sorted(s['tgrads']) == sorted(s['grads'])
    for k, ref in s['grads'].items():
        close_by_max(s['tgrads'][k], ref, k)
    nonzero = sum(float(np.abs(g).max()) > 0 for g in s['grads'].values())
    assert nonzero > 0.9 * len(s['grads'])


# ------------------------------------------------------- model_nms_utils

def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize('thresh', [None, 0.5])
def test_class_agnostic_nms_matches_jax(thresh):
    boxes = _boxes(32)
    scores = np.linspace(0.9, 0.1, 32).astype(np.float32)
    ref = jax_nms_utils.class_agnostic_nms(jnp.asarray(scores), jnp.asarray(boxes),
                                           NMS_CFG, score_thresh=thresh)
    got = model_nms_utils.class_agnostic_nms(_t(scores), _t(boxes), NMS_CFG,
                                             score_thresh=thresh)
    assert_equal(got[2], ref[2])
    assert_equal(got[0][got[2]], np.asarray(ref[0])[np.asarray(ref[2])])
    assert_close(got[1], ref[1])


def test_class_agnostic_nms_withfgscore_matches_jax():
    boxes = _boxes(16, seed=1)
    fg = np.full(16, 0.9, np.float32)
    fg[::2] = 0.01
    loc = np.linspace(0.1, 0.8, 16).astype(np.float32)
    ref = jax_nms_utils.class_agnostic_nms_withfgscore(
        jnp.asarray(fg), jnp.asarray(loc), jnp.asarray(boxes), NMS_CFG, fgscore_thresh=0.5)
    got = model_nms_utils.class_agnostic_nms_withfgscore(
        _t(fg), _t(loc), _t(boxes), NMS_CFG, fgscore_thresh=0.5)
    assert_equal(got[2], ref[2])
    assert_equal(got[0][got[2]], np.asarray(ref[0])[np.asarray(ref[2])])
    assert_close(got[1], ref[1])
    assert (got[0][got[2]] % 2 == 1).all()


@pytest.mark.parametrize('per_class_boxes', [False, True])
def test_multi_classes_nms_matches_jax(per_class_boxes):
    boxes = _boxes(24, seed=2)
    if per_class_boxes:
        boxes = np.stack([boxes, _boxes(24, seed=5), _boxes(24, seed=6)], 1)
    cls = np.random.RandomState(3).rand(24, 3).astype(np.float32)
    ref = jax_nms_utils.multi_classes_nms(jnp.asarray(cls), jnp.asarray(boxes), NMS_CFG,
                                          score_thresh=0.3)
    got = model_nms_utils.multi_classes_nms(_t(cls), _t(boxes), NMS_CFG, score_thresh=0.3)
    valid = np.asarray(ref[3])
    assert_equal(got[3], valid)
    assert_equal(got[2], ref[2])
    assert_close(got[0][_t(valid)], np.asarray(ref[0])[valid])
    assert_close(got[1], ref[1])
    assert valid.sum() > 0


# ---------------------------------------------------------- full width

ZOO_YAMLS = ('kitti_models/second.yaml', 'kitti_models/pointpillar.yaml',
             'waymo_models/second.yaml')


@pytest.mark.parametrize('yaml_path', ZOO_YAMLS)
def test_zoo_yaml_builds_at_full_width(yaml_path):
    """Each yaml builds with the JAX model's parameter count; SECOND's
    backbone builds its own rulebooks (it takes no host tables)."""
    from fv2p_torch.models.backbones_3d import reads_host_tables
    cfg = EasyDict()
    cfg_from_yaml_file(str(REPO / 'tools/cfgs' / yaml_path), cfg)
    meta = dataset_meta_from_cfg(cfg.DATA_CONFIG, 'test')
    model = torch_models.build_network(cfg.MODEL, len(cfg.CLASS_NAMES), cfg.CLASS_NAMES,
                                       meta, compute_dtype=torch.bfloat16, device='cpu')
    init_random_(model, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    jcfg = JaxEasyDict(copy.deepcopy(dict(cfg.MODEL)))
    assert n_params == _jax_param_count(jcfg, cfg.CLASS_NAMES, meta['num_point_features'])
    if 'BACKBONE_3D' in cfg.MODEL:
        assert not reads_host_tables(cfg.MODEL.BACKBONE_3D.NAME)
    nx, ny, _ = meta['grid_size']
    stride = cfg.MODEL.DENSE_HEAD.ANCHOR_GENERATOR_CONFIG[0]['feature_map_stride']
    assert model.dense_head.anchors_flat.shape[0] == (nx // stride) * (ny // stride) * 6


# ------------------------------------------------- PointPillar's pillars

@pytest.mark.parametrize('training', [False, True], ids=['test', 'train'])
def test_pointpillar_samples_match_jax(training):
    """pointpillar.yaml's data pipeline on the fixture's scans (0.16 x 0.16
    x 4 m pillars, 32 points a pillar, the 16000 / 40000 caps) through the
    port's voxel generator against JAX's, array for array; in training with
    the augmentation's draws from the same seed, for Car and Pedestrian (the
    fixture's gt database has no Cyclist, on which JAX's gt sampler
    fails)."""
    from fv2p_tpu.config import cfg_from_yaml_file as jax_cfg_from_yaml_file
    from fv2p_tpu.datasets.kitti.kitti_dataset import KittiDataset as JaxKittiDataset
    from fv2p_torch.datasets.kitti.kitti_dataset import KittiDataset
    from tests.test_torch_data import KITTI, _assert_samples_equal
    yaml_path = str(REPO / 'tools/cfgs/kitti_models/pointpillar.yaml')
    jcfg, tcfg = JaxEasyDict(), EasyDict()
    jax_cfg_from_yaml_file(yaml_path, jcfg)
    cfg_from_yaml_file(yaml_path, tcfg)
    classes = ['Car', 'Pedestrian']
    jds = JaxKittiDataset(jcfg.DATA_CONFIG, classes, training=training, root_path=KITTI)
    tds = KittiDataset(tcfg.DATA_CONFIG, classes, training=training, root_path=KITTI)
    assert tds.data_processor.max_voxels == (16000 if training else 40000)
    for index in (0, 5):
        np.random.seed(3 + index)
        tds.rng = np.random.RandomState(3 + index)
        ref, got = jds[index], tds[index]
        _assert_samples_equal(got, ref)
        assert got['voxels'].shape[1:] == (32, 4)
        assert int(got['voxel_valid'].sum()) > 1000
    meta = dataset_meta_from_cfg(tcfg.DATA_CONFIG, 'test')
    assert meta['grid_size'] == (432, 496, 1)
