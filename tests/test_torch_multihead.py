"""The multihead anchor head (``AnchorHeadMulti``) in the PyTorch port
against the JAX package on the CPU, and the downsampling deblock of the BEV
backbone.

The box coder with sincos and velocity columns, the multihead anchors, and
three tiny models carried from flax into the port: the CBGS layout of
``tests/test_multihead.py`` (SECONDNet, separate regression branches,
9-dim boxes with velocities), its 1x1-head variant (KITTI's
``second_multihead.yaml``: no separate regression, 7-dim code) and a
PointPillar multihead whose BEV backbone downsamples its first level
(``cbgs_pp_multihead.yaml``'s UPSAMPLE_STRIDES [0.5, 1, 2]). For each: the
head's predictions and anchors row for row, the decode, the multi-class
NMS; then one train step's targets, loss terms, gradients and the
parameters after one ``adam_onecycle`` update. The class convs start at
bias 0 here (JAX's -log 99 puts every anchor under SCORE_THRESH). Last,
the four multihead yamls build at full width with the JAX model's
parameter counts.

Tolerances as ``tests/test_torch_train.py``: integers exact, floats rtol
1e-4, gradients and updated parameters within 1e-4 max|ref| + 1e-7 (a
parameter whose gradient is within that noise of 0 moves by at most lr on
either side: Adam's first step is ~lr sign(g); the sparse residual blocks'
conv biases feed train-mode BatchNorms, so their true gradient is 0 and
both sides give noise).
"""
import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fv2p_tpu.config import EasyDict as JaxEasyDict
from fv2p_tpu.config import StaticConfig
from fv2p_tpu.models import build_network as jax_build_network
from fv2p_tpu.models.backbones_2d.base_bev_backbone import BaseBEVBackbone as JaxBEV
from fv2p_tpu.models.dense_heads import anchor_head_multi as jax_multi
from fv2p_tpu.models.detectors import detector3d_template as jax_det
from fv2p_tpu.train_utils import optimization as jax_optim
from fv2p_tpu.utils import box_coder_utils as jax_coder
from tests.jitu import japply, jgrad, jinit
from tests.test_model_zoo import PILLAR_CFG
from tests.test_multihead import MULTIHEAD_CFG
from tests.test_torch_model import assert_close, assert_equal, perturb_bn
from tests.test_torch_package import _jax_param_count
from tests.test_torch_train import _zero_by_construction, close_by_max, flat_paths
from tests.test_torch_zoo import compact_batch

import fv2p_torch.models as torch_models
from fv2p_torch.config import EasyDict, cfg_from_yaml_file
from fv2p_torch.datasets import dataset_meta_from_cfg
from fv2p_torch.models.backbones_2d.base_bev_backbone import BaseBEVBackbone
from fv2p_torch.models.dense_heads import anchor_head_multi
from fv2p_torch.train_utils.train_state import TrainStep
from fv2p_torch.utils import box_coder_utils
from fv2p_torch.utils.synthetic import batch_to_torch
from fv2p_torch.weights import flax_variables, init_random_, load_flax_variables

REPO = Path(__file__).resolve().parent.parent
CLASSES = ['car', 'truck', 'pedestrian']
OPTIM = EasyDict({'OPTIMIZER': 'adam_onecycle', 'LR': 0.003, 'WEIGHT_DECAY': 0.01,
                  'MOMENTUM': 0.9, 'MOMS': [0.95, 0.85], 'PCT_START': 0.4,
                  'DIV_FACTOR': 10, 'GRAD_NORM_CLIP': 10})
TOTAL_STEPS = 100


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ------------------------------------------------------------- the coder

@pytest.mark.parametrize('sincos,ndim', [(True, 9), (False, 9), (False, 7), (True, 7)])
def test_residual_coder_matches_jax(sincos, ndim):
    """encode and decode against JAX, and decode(encode(g)) == g."""
    rng = np.random.RandomState(4)
    n = 64
    anchors = np.zeros((n, ndim), np.float32)
    anchors[:, :3] = rng.uniform(-20, 20, (n, 3))
    anchors[:, 3:6] = rng.uniform(0.4, 6, (n, 3))
    anchors[:, 6] = rng.choice([0.0, 1.57], n)
    boxes = anchors + rng.normal(0, 0.3, anchors.shape).astype(np.float32)
    boxes[:, 3:6] = np.abs(boxes[:, 3:6]) + 0.1
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, n)
    code = ndim + (1 if sincos else 0)
    jc = jax_coder.ResidualCoder(code_size=code - int(sincos), encode_angle_by_sincos=sincos)
    tc = box_coder_utils.ResidualCoder(code_size=code - int(sincos),
                                       encode_angle_by_sincos=sincos)
    assert tc.code_size == jc.code_size == code
    enc = tc.encode(_t(boxes), _t(anchors))
    assert_close(enc, jc.encode(jnp.asarray(boxes), jnp.asarray(anchors)))
    dec = tc.decode(enc, _t(anchors))
    assert_close(dec, jc.decode(jnp.asarray(np.asarray(enc)), jnp.asarray(anchors)))
    back = dec.numpy().copy()
    back[:, 6] = np.arctan2(np.sin(back[:, 6]), np.cos(back[:, 6]))
    want = boxes.copy()
    if not sincos:
        back[:, 6], want[:, 6] = np.sin(back[:, 6]), np.sin(want[:, 6])
    np.testing.assert_allclose(back, want, rtol=1e-4, atol=1e-4)


def test_generate_anchors_multihead_matches_jax():
    cfg = EasyDict()
    cfg_from_yaml_file(str(REPO / 'tools/cfgs/nuscenes_models/cbgs_second_multihead.yaml'),
                       cfg)
    grid = (128, 96, 40)
    pr = tuple(cfg.DATA_CONFIG.POINT_CLOUD_RANGE)
    ref = jax_multi.generate_anchors_multihead(cfg.MODEL.DENSE_HEAD.ANCHOR_GENERATOR_CONFIG,
                                               grid, pr)
    got = anchor_head_multi.generate_anchors_multihead(
        cfg.MODEL.DENSE_HEAD.ANCHOR_GENERATOR_CONFIG, grid, pr)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)
    assert got[0].shape == (10 * 2 * 12 * 16, 7)


# -------------------------------------------------- the downsampling deblock

@pytest.mark.parametrize('size', [(16, 16), (15, 13)], ids=['even', 'odd'])
def test_downsampling_deblock_matches_jax(size):
    """UPSAMPLE_STRIDES [0.5, 1, 2] on a (B, H, W, 8) map: the strided Conv
    of deblock0 (flax 'SAME' padding: none at even sizes, the odd pixel at
    the end otherwise) and the concatenated output."""
    cfg = EasyDict({'NAME': 'BaseBEVBackbone', 'LAYER_NUMS': [1, 1], 'LAYER_STRIDES': [1, 2],
                    'NUM_FILTERS': [8, 16], 'UPSAMPLE_STRIDES': [0.5, 1],
                    'NUM_UPSAMPLE_FILTERS': [8, 8]})
    h, w = size
    x = np.random.RandomState(1).randn(2, h, w, 8).astype(np.float32)
    jmod = JaxBEV(model_cfg=StaticConfig(JaxEasyDict(dict(cfg))), input_channels=8)
    variables = jmod.init(jax.random.PRNGKey(0), {'spatial_features': jnp.asarray(x)})
    vnp = perturb_bn(jax.tree_util.tree_map(np.asarray, dict(variables)),
                     np.random.RandomState(2))
    ref = jmod.apply(jax.tree_util.tree_map(jnp.asarray, vnp),
                     {'spatial_features': jnp.asarray(x)})['spatial_features_2d']
    tmod = BaseBEVBackbone(cfg, 8).eval()
    load_flax_variables(tmod, vnp)
    assert tuple(tmod.deblock0.Conv_0.weight.shape) == (8, 8, 2, 2)
    with torch.no_grad():
        got = tmod({'spatial_features': _t(x)})['spatial_features_2d']
    assert got.shape[1:3] == (-(-h // 2), -(-w // 2))
    assert_close(got, ref)


# ------------------------------------------------------- the tiny models

def _sep_cfg():
    return copy.deepcopy(MULTIHEAD_CFG)


def _conv1x1_cfg():
    """second_multihead.yaml's head: 1x1 convs, the 7-dim code, smooth L1."""
    cfg = copy.deepcopy(MULTIHEAD_CFG)
    del cfg.DENSE_HEAD['SEPARATE_REG_CONFIG']
    cfg.DENSE_HEAD.TARGET_ASSIGNER_CONFIG = {
        'NAME': 'AxisAlignedTargetAssigner', 'POS_FRACTION': -1.0, 'SAMPLE_SIZE': 512,
        'NORM_BY_NUM_EXAMPLES': False, 'MATCH_HEIGHT': False, 'BOX_CODER': 'ResidualCoder'}
    cfg.DENSE_HEAD.LOSS_CONFIG = {'LOSS_WEIGHTS': {
        'cls_weight': 1.0, 'loc_weight': 2.0, 'dir_weight': 0.2, 'code_weights': [1.0] * 7}}
    return cfg


def _pillar_cfg():
    """A PointPillar multihead whose first level is downsampled."""
    cfg = copy.deepcopy(MULTIHEAD_CFG)
    cfg.NAME = 'PointPillar'
    del cfg['BACKBONE_3D']
    cfg.VFE = copy.deepcopy(PILLAR_CFG.VFE)
    cfg.MAP_TO_BEV = copy.deepcopy(PILLAR_CFG.MAP_TO_BEV)
    cfg.BACKBONE_2D = JaxEasyDict({
        'NAME': 'BaseBEVBackbone', 'LAYER_NUMS': [1, 1, 1], 'LAYER_STRIDES': [2, 2, 2],
        'NUM_FILTERS': [16, 32, 32], 'UPSAMPLE_STRIDES': [0.5, 1, 2],
        'NUM_UPSAMPLE_FILTERS': [16, 16, 16]})
    cfg.DENSE_HEAD.ANCHOR_GENERATOR_CONFIG = [
        dict(a, feature_map_stride=4) for a in cfg.DENSE_HEAD.ANCHOR_GENERATOR_CONFIG]
    return cfg


CASES = {'separate_reg': _sep_cfg, 'conv1x1': _conv1x1_cfg, 'pillar_downsample': _pillar_cfg}


def _gt(ndim):
    """Each scan's three objects, one per class, near its voxel cube; with
    ndim 9 the rows carry velocities."""
    rows = [[3.0, 0.0, -1.0, 4.6, 1.9, 1.7, 0.3, 0.5, -0.2, 1],
            [1.5, -1.5, -1.0, 6.9, 2.5, 2.8, -0.5, 0.0, 0.3, 2],
            [2.5, 1.0, -1.0, 0.7, 0.7, 1.8, 0.1, 0.0, 0.0, 3]]
    gt = np.zeros((2, 10, ndim + 1), np.float32)
    for i, r in enumerate(rows):
        gt[:, i, :ndim] = r[:ndim]
        gt[:, i, ndim] = r[-1]
    return gt


def _setup(name):
    cfg = CASES[name]()
    batch_np, meta = compact_batch(pillars=name.startswith('pillar'))
    sincos = 'BOX_CODER_CONFIG' in cfg.DENSE_HEAD.TARGET_ASSIGNER_CONFIG
    batch_np['gt_boxes'] = _gt(9 if sincos else 7)
    jmodel = jax_build_network(cfg, num_class=3, class_names=CLASSES, dataset_meta=meta)
    jb = {k: jnp.asarray(v) for k, v in batch_np.items()}
    variables = jinit(jmodel, jax.random.PRNGKey(0), dict(jb))
    vnp = perturb_bn(jax.tree_util.tree_map(np.asarray, dict(variables)),
                     np.random.RandomState(0))
    for key, sub in vnp['params']['dense_head'].items():
        if key.endswith('_cls_out'):
            sub['bias'][:] = 0.0
    return cfg, batch_np, jmodel, jb, vnp, meta


def _torch_model(cfg, meta, vnp):
    tmodel = torch_models.build_network(cfg, 3, CLASSES, meta, device='cpu')
    return load_flax_variables(tmodel, vnp)


@pytest.fixture(scope='module', params=sorted(CASES))
def case(request):
    """(name, the JAX model with its variables and the batch), shared by
    the eval and the train fixture."""
    return (request.param,) + _setup(request.param)


@pytest.fixture(scope='module')
def eval_run(case):
    name, cfg, batch_np, jmodel, jb, vnp, meta = case
    tmodel = _torch_model(cfg, meta, vnp)
    ev = {k: v for k, v in jb.items() if k != 'gt_boxes'}
    out = japply(jmodel, jax.tree_util.tree_map(jnp.asarray, vnp), dict(ev))
    tout = tmodel(batch_to_torch({k: v for k, v in batch_np.items() if k != 'gt_boxes'},
                                 'cpu'))
    return name, cfg, out, tout, tmodel


def test_eval_predictions_match_jax(eval_run):
    """The anchors and the head's packed predictions row for row (the -1e9
    columns included), then the decode."""
    name, cfg, out, tout, tmodel = eval_run
    a_np, a_cls, m_t, u_t = jax_multi.generate_anchors_multihead(
        cfg.DENSE_HEAD.ANCHOR_GENERATOR_CONFIG, tmodel.dataset_meta['grid_size'],
        tmodel.dataset_meta['point_cloud_range'])
    head = tmodel.dense_head
    assert_equal(head.anchors_flat[:, :7], a_np)
    assert not head.anchors_flat[:, 7:].any()
    assert_equal(head.anchor_cls, a_cls)
    ret, tret = out['anchor_head_ret'], tout['anchor_head_ret']
    assert sorted(tret) == sorted(ret)
    for key in ('cls_preds', 'box_preds', 'dir_cls_preds'):
        assert_close(tret[key], ret[key])
    assert (np.asarray(ret['cls_preds']) == -1e9).any()
    assert_close(tout['batch_box_preds'], out['batch_box_preds'])
    if name != 'conv1x1':
        assert tout['batch_box_preds'].shape[-1] == 9


def test_multi_classes_nms_matches_jax(eval_run):
    """One NMS lane per (scan, class): keeps, labels, scores and every box
    column (the velocities too)."""
    name, cfg, out, tout, _ = eval_run
    post = int(cfg.POST_PROCESSING.NMS_CONFIG.NMS_POST_MAXSIZE)
    ndim = 7 if name == 'conv1x1' else 9
    assert tuple(tout['pred_boxes'].shape) == (2, 3 * post, ndim)
    assert_equal(tout['pred_valid'], out['pred_valid'])
    assert_equal(tout['pred_labels'], out['pred_labels'])
    valid = np.asarray(out['pred_valid'])
    assert_close(tout['pred_boxes'][_t(valid)], np.asarray(out['pred_boxes'])[valid])
    assert_close(tout['pred_scores'], out['pred_scores'])
    assert valid.sum() > 0
    assert len(set(np.asarray(out['pred_labels'])[valid].tolist())) > 1


@pytest.fixture(scope='module')
def train_run(case):
    """One train step in both packages from the same variables: the loss
    and gradients, then one adam_onecycle update. With a pillar encoder the
    reference gradients are JAX's eager ones (``tests/test_torch_zoo.py``
    says why: ties of the PFN max among exact zeros move under jit)."""
    name, cfg, batch_np, jmodel, jb, vnp, meta = case
    tmodel = _torch_model(cfg, meta, vnp)

    def loss_fn(params):
        o, _ = jmodel.apply({'params': params, 'batch_stats': vnp['batch_stats']},
                            dict(jb), train=True, mutable=['batch_stats'])
        loss, tb = jax_det.compute_training_loss(jmodel, o)
        return loss, (tb, o['anchor_head_ret']['box_cls_labels'],
                      o['anchor_head_ret']['box_reg_targets'])

    params = jax.tree_util.tree_map(jnp.asarray, vnp['params'])
    if name.startswith('pillar'):
        (loss, (tb, labels, targets)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
    else:
        (loss, (tb, labels, targets)), grads = jgrad(loss_fn, params)
    tx = jax_optim.build_optimizer(StaticConfig(OPTIM), TOTAL_STEPS)
    upd, _ = tx.update(grads, tx.init(params), params)
    new_params = optax.apply_updates(params, upd)

    step = TrainStep(tmodel, OPTIM, TOTAL_STEPS)
    tloss, tterms, tout = step.forward_loss(batch_to_torch(batch_np, 'cpu'))
    step.backward(tloss)
    tgrads = flat_paths(flax_variables(tmodel, grads=True)['params'])
    step.update()
    lr0 = float(jax_optim.one_cycle_lr_schedule(
        float(OPTIM.LR), float(OPTIM.DIV_FACTOR), float(OPTIM.PCT_START), TOTAL_STEPS)(0))
    return {'tb': tb, 'loss': loss, 'labels': labels, 'targets': targets,
            'grads': flat_paths(grads), 'params': flat_paths(new_params),
            'params0': flat_paths(vnp['params']), 'lr0': lr0,
            'ttb': tterms, 'tloss': tloss, 'tout': tout, 'tgrads': tgrads,
            'tparams': flat_paths(flax_variables(tmodel)['params'])}


def test_train_targets_and_losses_match_jax(train_run):
    s = train_run
    tret = s['tout']['anchor_head_ret']
    assert_equal(tret['box_cls_labels'], s['labels'])
    assert_close(tret['box_reg_targets'], s['targets'])
    labels = np.asarray(s['labels'])
    assert len(set(labels[labels > 0].tolist())) == 3
    assert sorted(s['ttb']) == sorted(s['tb'])
    for k, v in s['tb'].items():
        np.testing.assert_allclose(float(s['ttb'][k].detach()), float(v), rtol=1e-4, err_msg=k)
        assert float(v) > 0, k
    np.testing.assert_allclose(float(s['tloss'].detach()), float(s['loss']), rtol=1e-4)


def test_train_gradients_match_jax(train_run):
    s = train_run
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


def test_train_updated_params_match_jax(train_run):
    s = train_run
    lr, wd = s['lr0'], float(OPTIM.WEIGHT_DECAY)
    assert sorted(s['tparams']) == sorted(s['params'])
    n_noise = n_all = 0
    for k, ref in s['params'].items():
        got, g, p0 = s['tparams'][k], np.asarray(s['grads'][k]), s['params0'][k]
        # an exact 0 is no noise: Adam then moves a parameter by its decay alone
        noise = (np.abs(g) <= 2 * (1e-4 * np.abs(g).max() + 1e-7)) & (g != 0)
        if _zero_by_construction(k):
            noise[:] = True
        close_by_max(np.where(noise, 0.0, got), np.where(noise, 0.0, np.asarray(ref)), k)
        for side in (got, np.asarray(ref)):
            step = np.abs(side - p0 + lr * wd * p0)[noise]
            assert not step.size or float(step.max()) <= lr * (1 + 1e-4), k
        n_noise += int(noise.sum())
        n_all += noise.size
    assert n_noise < 0.02 * n_all, (n_noise, n_all)


# ------------------------------------------------------------- full width

MULTIHEAD_YAMLS = ('kitti_models/second_multihead.yaml',
                   'nuscenes_models/cbgs_second_multihead.yaml',
                   'nuscenes_models/cbgs_second_multihead_overfit.yaml',
                   'nuscenes_models/cbgs_pp_multihead.yaml')


@pytest.mark.parametrize('yaml_path', MULTIHEAD_YAMLS)
def test_multihead_yaml_builds_at_full_width(yaml_path):
    """Each yaml builds on the CPU with the JAX model's parameter count
    (``jax.eval_shape`` of the flax init: no parameter shape depends on the
    grid); the anchors cover the full grid in multihead order, padded to
    the boxes' width."""
    cfg = EasyDict()
    cfg_from_yaml_file(str(REPO / 'tools/cfgs' / yaml_path), cfg)
    meta = dataset_meta_from_cfg(cfg.DATA_CONFIG, 'test')
    model = torch_models.build_network(cfg.MODEL, len(cfg.CLASS_NAMES), cfg.CLASS_NAMES,
                                       meta, compute_dtype=torch.bfloat16, device='cpu')
    init_random_(model, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    jcfg = JaxEasyDict(copy.deepcopy(dict(cfg.MODEL)))
    assert n_params == _jax_param_count(jcfg, cfg.CLASS_NAMES, meta['num_point_features'])
    head = model.dense_head
    nx, ny, _ = meta['grid_size']
    stride = cfg.MODEL.DENSE_HEAD.ANCHOR_GENERATOR_CONFIG[0]['feature_map_stride']
    n_cls = len(cfg.CLASS_NAMES)
    ndim = 9 if yaml_path.startswith('nuscenes') else 7
    assert tuple(head.anchors_flat.shape) == ((nx // stride) * (ny // stride) * 2 * n_cls, ndim)
    cls_outs = [m for n, m in model.named_modules() if n.endswith('_cls_out')]
    assert len(cls_outs) == len(cfg.MODEL.DENSE_HEAD.RPN_HEAD_CFGS)
    assert all(float(m.bias.max()) == float(m.bias.min()) == pytest.approx(-np.log(99.0))
               for m in cls_outs)
