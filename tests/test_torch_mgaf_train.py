"""The PyTorch port of MGAF-3DSSD training against the JAX package on the
CPU.

Module by module: the deformable convolution's backward (against
``jax.vjp`` of ``fv2p_tpu.ops.dcn.modulated_deform_conv``, and a gradient
check in f64), the target half of ``center_utils``, ``encode_rot_binres``,
the CenterNet target assigner, the five CenterNet losses and
``center_af_head_loss``; then one whole train step of the tiny MGAF
(``TINY_MODEL_CFG``) from the same flax variables and batch: the eight loss
terms, every gradient, the batch statistics after the step and the
parameters after the adam_onecycle update, compared by flax path. Also the
level capacities a yaml sets for the host rulebooks (``select_mode_caps``).

The tiny model's ``hm_out`` is raised (bias 0, kernel |N(0, 1)|) as in
``tests/test_torch_mgaf.py``, its offset convs moved off their zero
initialisation, and its dim and height outputs biased to car sizes so that
the decoded boxes overlap the gt, which is made of jittered copies of some
of them: the iou-score targets then cover the whole soft-label range.

Tolerances: integer targets exact; float targets, losses and loss terms
rtol 1e-4 (``assert_close``); gradients, batch statistics and updated
parameters within ``1e-4 * max|ref| + 1e-7`` per tensor (``close_by_max``).
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fv2p_tpu.config import StaticConfig
from fv2p_tpu.models import build_network as jax_build_network
from fv2p_tpu.models.dense_heads import center_af_head as jax_head
from fv2p_tpu.models.dense_heads import center_target_assigner as jax_assigner
from fv2p_tpu.models.detectors import detector3d_template as jax_det
from fv2p_tpu.ops import dcn as jax_dcn
from fv2p_tpu.ops.sparse import host_rulebook as jax_host_rulebook
from fv2p_tpu.train_utils import optimization as jax_optim
from fv2p_tpu.utils import box_utils as jax_box_utils
from fv2p_tpu.utils import center_utils as jax_center_utils
from fv2p_tpu.utils import loss_utils as jax_loss
from tests.jitu import japply, jgrad, jinit
from tests.test_mgaf_model import TINY_MODEL_CFG
from tests.test_torch_dcn import _dcn_inputs, perturb_offset_conv
from tests.test_torch_model import (assert_close, assert_equal,
                                    make_rulebook_batches, perturb_bn, t,
                                    to_jax)
from tests.test_torch_train import (_zero_by_construction, close_by_max,
                                    flat_paths, rand_boxes)

import fv2p_torch.models as torch_models
from fv2p_torch.config import EasyDict, cfg_from_yaml_file
from fv2p_torch.datasets import dataset_meta_from_cfg
from fv2p_torch.models.dense_heads import center_af_head as torch_head
from fv2p_torch.models.dense_heads import center_target_assigner as torch_assigner
from fv2p_torch.ops import dcn
from fv2p_torch.ops.sparse import host_rulebook as torch_host_rulebook
from fv2p_torch.train_utils.train_state import TrainStep
from fv2p_torch.utils import box_utils, center_utils, loss_utils
from fv2p_torch.utils.synthetic import batch_to_torch, synthetic_batch_np
from fv2p_torch.weights import flax_variables, load_flax_variables
from tests.test_torch_model import one_torch_thread  # noqa: F401 (an autouse fixture)

REPO = Path(__file__).resolve().parent.parent
MGAF_YAML = REPO / 'tools/cfgs/kitti_models/MGAF-3DSSD/mgaf-3dssd.yaml'
FV2P_YAML = REPO / 'tools/cfgs/kitti_models/FV2P/fv2p.yaml'


def _yaml(path):
    cfg = EasyDict()
    cfg_from_yaml_file(str(path), cfg)
    return cfg


# --------------------------------------------------------- DCN backward

@pytest.mark.parametrize('g', [1, 4])
def test_dcn_gradients_match_jax_vjp(g):
    """d(x), d(offsets), d(mask) and d(W) against jax.vjp, with samples past
    every border, whole samples out of range and corners outside the map on
    one side (the inputs of ``test_torch_dcn``)."""
    x, dy, dx, mask, weights = _dcn_inputs(40 + g, g)
    rng = np.random.RandomState(50 + g)
    args = [jnp.asarray(a) for a in (x, dy, dx, mask, weights)]
    out, vjp = jax.vjp(lambda *a: jax_dcn.modulated_deform_conv(*a, 3, g), *args)
    dout = rng.randn(*out.shape).astype(np.float32)
    ref = vjp(jnp.asarray(dout))
    ts = [t(a).requires_grad_() for a in (x, dy, dx, mask, weights)]
    got = dcn.modulated_deform_conv(*ts, 3, g)
    got.backward(t(dout))
    for name, tt, r in zip(('x', 'offset_dy', 'offset_dx', 'mask', 'weights'), ts, ref):
        assert tt.grad.dtype == torch.float32
        close_by_max(tt.grad, r, name)
        assert float(np.abs(np.asarray(r)).max()) > 0.1, name


def test_dcn_gradcheck_f64():
    """The autograd Function against finite differences in f64 on a tiny
    map, offsets a fraction 0.2-0.8 away from integer positions (floor has
    no derivative there), some samples out of range."""
    rng = np.random.RandomState(60)
    b, h, w, c, g, cout = 1, 4, 5, 4, 2, 3
    x = rng.randn(b, h, w, c)
    off = [np.floor(rng.uniform(-3, 3, (b, h, w, g * 9)))
           + rng.uniform(0.2, 0.8, (b, h, w, g * 9)) for _ in range(2)]
    mask = rng.uniform(0, 1, (b, h, w, g * 9))
    weights = rng.randn(9, c, cout)
    ts = [torch.tensor(a, dtype=torch.float64, requires_grad=True)
          for a in (x, off[0], off[1], mask, weights)]
    assert torch.autograd.gradcheck(
        lambda *a: dcn.modulated_deform_conv(*a, 3, g), ts, eps=1e-6, atol=1e-6)


# ------------------------------------------------------------- helpers

def _quads(rng, n, h, w):
    boxes = np.concatenate([rng.uniform(-2, w + 2, (n, 1)), rng.uniform(-2, h + 2, (n, 1)),
                            np.zeros((n, 1)), rng.uniform(0.5, 6, (n, 2)),
                            np.ones((n, 1)), rng.uniform(-np.pi, np.pi, (n, 1))], 1)
    corners = np.array(jax_box_utils.boxes_to_corners_3d(
        jnp.asarray(boxes, jnp.float32)))[:, :4, :2]
    corners[:3] = corners[:3, ::-1]               # clockwise winding too
    corners[3] = corners[3, 0]                    # a point: no area
    return corners.astype(np.float32)


@pytest.mark.parametrize('helper', ['gaussian_radius', 'draw_gaussians',
                                    'fill_convex_quad', 'encode_rot_binres'])
def test_center_helpers_match_jax(helper):
    rng = np.random.RandomState(70)
    if helper == 'gaussian_radius':
        hw = rng.uniform(0, 30, (2, 200)).astype(np.float32)
        hw[:, :3] = 0.0
        for overlap in (0.01, 0.1, 0.7):
            assert_close(center_utils.gaussian_radius(t(hw[0]), t(hw[1]), overlap),
                         jax_center_utils.gaussian_radius(hw[0], hw[1], overlap))
    elif helper == 'draw_gaussians':
        h, w, m = 23, 31, 9
        base = rng.uniform(0, 0.5, (h, w)).astype(np.float32)
        centers = np.stack([rng.randint(-3, w + 3, m), rng.randint(-3, h + 3, m)], 1)
        radius = rng.randint(0, 6, m).astype(np.float32)
        valid = rng.rand(m) < 0.8
        got = center_utils.draw_gaussians(t(base), t(centers.astype(np.int32)),
                                          t(radius), t(valid))
        ref = jax_center_utils.draw_gaussians(jnp.asarray(base), jnp.asarray(centers),
                                              jnp.asarray(radius), jnp.asarray(valid))
        assert_close(got, ref)
        assert (np.asarray(ref) == 1.0).sum() >= 3
    elif helper == 'fill_convex_quad':
        h, w = 19, 27
        corners = _quads(rng, 12, h, w)
        valid = rng.rand(12) < 0.85
        got = center_utils.fill_convex_quad(h, w, t(corners), t(valid))
        ref = jax_center_utils.fill_convex_quad(h, w, jnp.asarray(corners),
                                                jnp.asarray(valid))
        assert_equal(got, ref)
        assert np.asarray(ref).sum() > 50
    else:
        ry = np.concatenate([rng.uniform(-7, 7, 300), np.arange(-12, 13) * np.pi / 6,
                             [0.0, np.pi, -np.pi, 2 * np.pi]]).astype(np.float32)
        for bins in (12, 4):
            got = box_utils.encode_rot_binres(t(ry), bins)
            ref = jax_box_utils.encode_rot_binres(jnp.asarray(ry), bins)
            assert_equal(got[0], ref[0])
            assert_close(got[1], ref[1])


# ------------------------------------------------------------- targets

def _target_gt():
    """gt (3, 12, 8) on the tiny map (8 x 8 cells of 0.8 m): overlapping
    boxes (later ones overwrite the height), boxes over the map's edge and
    outside it, zero sizes, class 0 rows, padding, and one scan whose rows
    exceed MAX_OBJS (10)."""
    rng = np.random.RandomState(80)
    gt = np.zeros((3, 12, 8), np.float32)
    gt[0, :6] = [[3.0, 0.0, -1.0, 3.7, 1.6, 1.5, 0.3, 1],
                 [3.4, 0.3, -0.5, 3.9, 1.6, 1.4, -0.5, 1],      # overlaps row 0
                 [0.1, -3.0, -1.2, 3.9, 1.6, 1.56, 1.2, 1],     # over the edge
                 [7.5, 0.0, -1.0, 3.9, 1.6, 1.5, 0.0, 1],       # centre off the map
                 [2.0, 2.0, -1.0, 0.0, 1.6, 1.5, 0.0, 1],       # zero size
                 [5.0, -1.5, -1.0, 2.0, 1.0, 1.5, 2.5, 0]]      # class 0
    gt[1, :2] = [[6.3, 3.1, -0.7, 4.2, 1.8, 1.5, -1.57, 1],       # rounds off the map
                 [1.0, -1.0, -1.0, 1.0, 0.6, 1.7, 2.9, 1]]
    gt[2, :12, :7] = rand_boxes(rng, 12)
    gt[2, :, 0] += 3.2
    gt[2, :12, 7] = 1
    return gt


def test_center_targets_match_jax():
    meta = make_rulebook_batches()[2]
    dh = TINY_MODEL_CFG.DENSE_HEAD
    gt = _target_gt()
    jas = jax_assigner.CenterTargetAssigner(StaticConfig(dh), ['Car'],
                                            meta['voxel_size'], meta['point_cloud_range'])
    tas = torch_assigner.CenterTargetAssigner(dh, 1, meta['voxel_size'],
                                              meta['point_cloud_range'])
    ref = jas.assign_targets(jnp.asarray(gt))
    got = tas.assign_targets(t(gt))
    assert sorted(got) == sorted(ref)
    for k in ('ind_target', 'mask_target', 'segm_target', 'xsys_target'):
        assert_equal(got[k], ref[k])
    for k in ('hm_target', 'anno_box_target', 'height_target', 'src_box_target',
              'batch_gtboxes_src'):
        assert_close(got[k], ref[k])
    mask = np.asarray(ref['mask_target'])
    assert mask.shape == (3, 10)
    assert mask[0, :6].tolist() == [1, 1, 1, 0, 0, 0]
    assert mask[1, :2].tolist() == [0, 1] and mask[2].sum() >= 5
    # one peak per object, but objects may share a center cell
    assert mask.sum() - 2 <= (np.asarray(ref['hm_target']) == 1.0).sum() <= mask.sum()
    # the overlap: row 1 overwrote row 0's height where both quads cover
    heights = np.asarray(ref['height_target'])[0]
    assert (heights == np.float32(-0.5)).any() and (heights == np.float32(-1.0)).any()


# -------------------------------------------------------------- losses

def _loss_inputs(seed=90):
    """A head's train outputs on the tiny map: random predictions and the
    targets of ``_target_gt``'s first two scans, decoded boxes near the gt."""
    rng = np.random.RandomState(seed)
    meta = make_rulebook_batches()[2]
    dh = TINY_MODEL_CFG.DENSE_HEAD
    gt = _target_gt()[:2]
    jas = jax_assigner.CenterTargetAssigner(StaticConfig(dh), ['Car'],
                                            meta['voxel_size'], meta['point_cloud_range'])
    ret = {k: np.asarray(v) for k, v in jas.assign_targets(jnp.asarray(gt)).items()}
    b, h, w = 2, 8, 8
    for name, ch in (('hm', 1), ('offset', 2), ('height', 1), ('dim', 3), ('rot', 24),
                     ('segm', 1), ('iouscore', 1)):
        ret[f'{name}_pred'] = (rng.randn(b, h, w, ch) * 1.5).astype(np.float32)
    ret['gthm_box_preds'] = (ret['src_box_target']
                             + rng.randn(b, 10, 7).astype(np.float32) * 0.3)
    k = 8
    jitter = np.linspace(0.02, 0.6, k)[None, :, None]
    box = np.repeat(gt[:, :1, :7], k, 1) + rng.randn(b, k, 7) * jitter
    ret['batch_box_preds'] = box.astype(np.float32)
    ret['batch_cls_preds'] = rng.randn(b, k, 1).astype(np.float32)
    ret['batch_iouscore_preds'] = rng.randn(b, k, 1).astype(np.float32)
    return ret


LOSSES = ('centernet_focal_loss', 'centernet_res_loss', 'rot_binres_loss',
          'corner_loss_mse', 'iouscore_loss_bce', 'center_af_head_loss')


@pytest.mark.parametrize('name', LOSSES)
def test_losses_match_jax(name):
    ret = _loss_inputs()
    jr = {k: jnp.asarray(v) for k, v in ret.items()}
    tr = {k: t(v) for k, v in ret.items()}
    mask, ind = 'mask_target', 'ind_target'
    if name == 'centernet_focal_loss':
        got = loss_utils.centernet_focal_loss(tr['hm_pred'], tr['hm_target'])
        ref = jax_loss.centernet_focal_loss(jr['hm_pred'], jr['hm_target'])
        # no positive at all: the negative part alone
        zero = np.minimum(ret['hm_target'], 0.9)
        assert_close(loss_utils.centernet_focal_loss(tr['hm_pred'], t(zero)),
                     jax_loss.centernet_focal_loss(jr['hm_pred'], jnp.asarray(zero)))
    elif name == 'centernet_res_loss':
        got = [loss_utils.centernet_res_loss(tr['dim_pred'], tr[mask], tr[ind],
                                             tr['anno_box_target'][:, :, 3:6], f)
               for f in ('l1', 'smooth-l1')]
        ref = [jax_loss.centernet_res_loss(jr['dim_pred'], jr[mask], jr[ind],
                                           jr['anno_box_target'][:, :, 3:6], f)
               for f in ('l1', 'smooth-l1')]
    elif name == 'rot_binres_loss':
        got = loss_utils.rot_binres_loss(
            center_utils.gather_feat_nhwc(tr['rot_pred'], tr[ind]),
            tr['anno_box_target'][:, :, 6], tr[mask])
        ref = jax_loss.rot_binres_loss(
            jax_center_utils.gather_feat_nhwc(jr['rot_pred'], jr[ind]),
            jr['anno_box_target'][:, :, 6], jr[mask])
    elif name == 'corner_loss_mse':
        args = ('gthm_box_preds', 'src_box_target')
        got = loss_utils.corner_loss_mse(*(tr[a].reshape(-1, 7) for a in args),
                                         tr[mask].reshape(-1))
        ref = jax_loss.corner_loss_mse(*(jr[a].reshape(-1, 7) for a in args),
                                       jr[mask].reshape(-1))
    elif name == 'iouscore_loss_bce':
        ious = np.linspace(0, 1, 40).astype(np.float32)
        preds = np.random.RandomState(91).randn(40).astype(np.float32) * 3
        valid = np.arange(40) % 7 != 3
        got = loss_utils.iouscore_loss_bce(t(preds), t(ious), t(valid))
        ref = jax_loss.iouscore_loss_bce(jnp.asarray(preds), jnp.asarray(ious),
                                         jnp.asarray(valid))
    else:
        got_loss, got = torch_head.center_af_head_loss(TINY_MODEL_CFG.DENSE_HEAD, tr)
        ref_loss, ref = jax_head.center_af_head_loss(StaticConfig(TINY_MODEL_CFG.DENSE_HEAD), jr)
        assert sorted(got) == sorted(ref)
        got, ref = [got[k] for k in sorted(ref)], [ref[k] for k in sorted(ref)]
        assert_close(got_loss, ref_loss)
        targets = torch_head.iouscore_targets(tr)
        assert (targets > 0.75).any() and ((targets > 0.25) & (targets < 0.75)).any()
    for g, r in zip(*((got, ref) if isinstance(got, list) else ([got], [ref]))):
        assert_close(g, r)
        assert float(np.abs(np.asarray(r))) > 0


# ------------------------------------------------------ level capacities

def test_select_mode_caps_keeps_jax_rules():
    flat = {'x_conv2': 100, 'out': 50}
    nested = {'train': {'x_conv2': 300}, 'test': {'x_conv2': 400}}
    cases = [None, {}, flat, nested, {'train': {'x_conv2': 300}},
             {'test': {'out': 9}}]
    for caps in cases:
        for training in (True, False):
            assert (torch_host_rulebook.select_mode_caps(caps, training)
                    == jax_host_rulebook.select_mode_caps(caps, training))
    assert torch_host_rulebook.select_mode_caps(flat, False) == flat
    assert torch_host_rulebook.select_mode_caps({'test': {'out': 9}}, True) is None
    mixed = {'train': {'x_conv2': 300}, 'x_conv3': 200}
    for mod in (torch_host_rulebook, jax_host_rulebook):
        with pytest.raises(ValueError, match='mixes per-mode keys'):
            mod.select_mode_caps(mixed, True)
    spec = torch_host_rulebook.backbone_spec('VoxelResBackBone8x', (16, 16, 8), 1000,
                                             caps_override=flat)
    ref = jax_host_rulebook.backbone_spec('VoxelResBackBone8x', (16, 16, 8), 1000,
                                          caps_override=flat)
    assert spec['caps'] == ref['caps'] and spec['caps']['x_conv2'] == 100


def test_yaml_train_caps_rulebooks_match_jax():
    """fv2p.yaml's train level caps, given to both packages' rulebook
    builders on the same small train batch: every table equal, each level
    at the yaml's capacity."""
    cfg = _yaml(FV2P_YAML)
    caps = torch_host_rulebook.select_mode_caps(
        cfg.MODEL.BACKBONE_3D.LEVEL_CAPACITIES, training=True)
    assert caps == jax_host_rulebook.select_mode_caps(
        cfg.MODEL.BACKBONE_3D.LEVEL_CAPACITIES, training=True)
    meta = dataset_meta_from_cfg(cfg.DATA_CONFIG, 'train')
    cap = int(caps['x_conv1'])
    got = synthetic_batch_np(meta, 2, cap, 1500, 100, seed=5, caps_override=caps)
    plain = synthetic_batch_np(meta, 2, cap, 1500, 100, seed=5)
    # JAX's builder on the same voxels (already in key order: its sort keeps them)
    jb = {k: np.array(got[k]) for k in ('voxels', 'voxel_coords',
                                        'voxel_num_points', 'voxel_valid')}
    jax_host_rulebook.prepare_batch_rulebooks(jb, 'VoxelResBackBone8x', meta['grid_size'],
                                              caps_override=caps)
    for k in ('voxels', 'voxel_coords'):
        assert_equal(jb[k], got[k])
    rb, jrb = got['rulebooks'], jb['rulebooks']
    assert sorted(rb) == sorted(jrb)
    for k in jrb:
        assert_equal(rb[k], jrb[k])
    for lvl, n in caps.items():
        assert rb[f'coords_{lvl}'].shape[1] == n
    assert plain['rulebooks']['coords_x_conv2'].shape[1] != caps['x_conv2']


# ------------------------------------------------- the whole train step

def _tiny_variables(jmodel, jb):
    """The tiny MGAF's flax variables: JAX's init, BatchNorms perturbed,
    offset convs off zero, ``hm_out`` raised, and the dim and height outputs
    biased to car sizes (3.9 x 1.6 x 1.5 m at z = -1) so decoded boxes
    overlap cars."""
    variables = jinit(jmodel, jax.random.PRNGKey(0), dict(jb))
    rng = np.random.RandomState(1)
    vnp = perturb_bn(jax.tree_util.tree_map(np.asarray, dict(variables)), rng)
    vnp['params'] = perturb_offset_conv(vnp['params'], rng)
    for path, leaf in flat_paths(vnp['params']).items():
        if path.endswith('conv_offset_mask/kernel'):
            leaf *= 0.1        # offsets of a few pixels: see the module docstring
    head = vnp['params']['dense_head']
    head['hm_out']['bias'][:] = 0.0
    head['hm_out']['kernel'] = np.abs(rng.randn(*head['hm_out']['kernel'].shape)).astype(np.float32)
    head['dim_out']['bias'][:] = [3.9, 1.6, 1.5]
    head['height_out']['bias'][:] = -1.0
    for name in ('dim_out', 'height_out'):
        head[name]['kernel'] = head[name]['kernel'] * 0.1
    return vnp


@pytest.fixture(scope='module')
def train_step():
    """One tiny MGAF train step in JAX (value_and_grad with mutable batch
    statistics, then the adam_onecycle update) and in the port
    (``TrainStep``), from the same variables and batch. The gt of each scan
    is three of JAX's own decoded training boxes, moved by 0.05-0.4 m and
    0.1-0.3 rad."""
    jax_np, torch_np, meta = make_rulebook_batches()
    jax_np['gt_boxes'] = np.zeros((2, 10, 8), np.float32)
    jmodel = jax_build_network(TINY_MODEL_CFG, num_class=1, class_names=['Car'],
                               dataset_meta=meta)
    vnp = _tiny_variables(jmodel, to_jax(jax_np))
    first, _ = japply(jmodel, jax.tree_util.tree_map(jnp.asarray, vnp),
                      dict(to_jax(jax_np)), train=True, mutable=['batch_stats'])
    boxes = np.asarray(first['head_ret']['batch_box_preds'])
    gt = np.zeros((2, 10, 8), np.float32)
    # every regressed quantity moved, so no l1 residual is exactly 0 (where
    # JAX's |x|' is 1 and torch's 0)
    shift = np.array([[0.1, -0.1, 0.05, 0.1, 0.05, -0.05, 0.1],
                      [0.25, 0.2, -0.1, -0.2, 0.1, 0.05, -0.2],
                      [-0.4, 0.3, 0.1, 0.3, -0.1, 0.1, 0.3]], np.float32)
    for b in range(2):
        gt[b, :3, :7] = boxes[b, [0, 2, 5]] + shift
        gt[b, :3, 7] = 1
    jax_np['gt_boxes'] = torch_np['gt_boxes'] = gt
    jb = to_jax(jax_np)

    def loss_fn(params):
        out, mutated = jmodel.apply({'params': params, 'batch_stats': vnp['batch_stats']},
                                    dict(jb), train=True, mutable=['batch_stats'])
        loss, tb = jax_det.compute_training_loss(jmodel, out)
        hr = out['head_ret']
        return loss, (tb, mutated['batch_stats'],
                      {k: hr[k] for k in hr if k.endswith('_target')
                       or k in ('batch_box_preds', 'gthm_box_preds')})

    params = jax.tree_util.tree_map(jnp.asarray, vnp['params'])
    (loss, (tb, stats, head_ret)), grads = jgrad(loss_fn, params)
    ocfg = _yaml(MGAF_YAML).OPTIMIZATION
    total = 100
    tx = jax_optim.build_optimizer(StaticConfig(ocfg), total)
    upd, _ = tx.update(grads, tx.init(params), params)
    new_params = optax.apply_updates(params, upd)
    ref_iou = jax.vmap(lambda bp, gb: jnp.max(
        jax_head.iou3d.boxes_iou3d(bp, gb[:, :7]) * (gb[:, 7] > 0), axis=1))(
        head_ret['batch_box_preds'], jnp.asarray(gt))

    tmodel = torch_models.build_network(TINY_MODEL_CFG, 1, ['Car'], meta, device='cpu')
    load_flax_variables(tmodel, vnp)
    step = TrainStep(tmodel, ocfg, total)
    tloss, tterms, tout = step.forward_loss(batch_to_torch(torch_np, 'cpu'))
    step.backward(tloss)
    tgrads = flax_variables(tmodel, grads=True)
    tstats = flax_variables(tmodel)['batch_stats']
    grad_norm = step.update()
    lr0 = float(jax_optim.one_cycle_lr_schedule(
        float(ocfg.LR), float(ocfg.DIV_FACTOR), float(ocfg.PCT_START), total)(0))
    return {'tb': tb, 'loss': loss, 'grads': flat_paths(grads),
            'params0': flat_paths(vnp['params']), 'lr0': lr0,
            'weight_decay': float(ocfg.WEIGHT_DECAY), 'stats': flat_paths(stats),
            'params': flat_paths(new_params), 'head_ret': head_ret,
            'ref_iou': np.asarray(ref_iou),
            'ttb': tterms, 'tloss': tloss, 'tgrads': flat_paths(tgrads['params']),
            'tstats': flat_paths(tstats),
            'tparams': flat_paths(flax_variables(tmodel)['params']),
            'tout': tout, 'grad_norm': grad_norm,
            'ref_grad_norm': optax.global_norm(grads)}


def test_train_step_targets_match_jax(train_step):
    s = train_step
    got, ref = s['tout']['head_ret'], s['head_ret']
    for k in ('ind_target', 'mask_target', 'segm_target', 'xsys_target'):
        assert_equal(got[k], ref[k])
    for k in ('hm_target', 'anno_box_target', 'height_target', 'src_box_target',
              'batch_box_preds', 'gthm_box_preds'):
        assert_close(got[k], ref[k])
    iou = torch_head.iouscore_targets(got)
    assert_close(iou, s['ref_iou'])
    # the iou-score labels cover background, the soft interval and foreground
    assert (s['ref_iou'] < 0.25).any() and (s['ref_iou'] > 0.75).any()
    assert ((s['ref_iou'] > 0.25) & (s['ref_iou'] < 0.75)).any()
    assert float(np.asarray(ref['mask_target']).sum()) >= 4


def test_train_step_losses_match_jax(train_step):
    s = train_step
    assert sorted(s['ttb']) == sorted(s['tb'])
    assert len(s['tb']) == 10                    # eight terms, rpn_loss, loss
    for k, v in s['tb'].items():
        np.testing.assert_allclose(float(s['ttb'][k].detach()), float(v), rtol=1e-4, err_msg=k)
        assert float(v) > 0, k
    np.testing.assert_allclose(float(s['tloss'].detach()), float(s['loss']), rtol=1e-4)
    np.testing.assert_allclose(float(s['grad_norm']), float(s['ref_grad_norm']), rtol=1e-4)


def test_train_step_gradients_match_jax(train_step):
    """Every parameter's gradient by flax path; the segmentation head's come
    only from its own loss (the attention reads sigmoid(segm) without a
    gradient), the DCN kernels' through the port's backward."""
    s = train_step
    assert sorted(s['tgrads']) == sorted(s['grads'])
    for k, ref in s['grads'].items():
        if _zero_by_construction(k):
            scale = float(np.abs(s['grads'][k[:-len('bias')] + 'kernel']).max())
            assert float(np.abs(ref).max()) <= 1e-5 * scale, k
            assert float(np.abs(s['tgrads'][k]).max()) <= 1e-5 * scale, k
            continue
        close_by_max(s['tgrads'][k], ref, k)
    nonzero = sum(float(np.abs(g).max()) > 0 for g in s['grads'].values())
    assert nonzero > 0.9 * len(s['grads'])
    for k in ('dense_head/segm/Conv_0/kernel', 'dense_head/feature_adapt/mdcn/kernel',
              'backbone_2d/deblock0/dcn/kernel',
              'dense_head/feature_adapt/mdcn/conv_offset_mask/kernel'):
        assert float(np.abs(s['grads'][k]).max()) > 0, k


def test_train_step_batch_stats_match_jax(train_step):
    s = train_step
    assert sorted(s['tstats']) == sorted(s['stats'])
    assert any(k.startswith('dense_head/heads_fused_bn') for k in s['stats'])
    for k, ref in s['stats'].items():
        close_by_max(s['tstats'][k], ref, k)


def test_train_step_updated_params_match_jax(train_step):
    """As ``test_torch_train``: where |g| is within rounding noise of 0 the
    sign of Adam's first step is noise, so each side moves by at most lr
    there; elsewhere the updated parameters agree by max."""
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
            moved = np.abs(side - p0 + lr * wd * p0)[noise]
            assert not moved.size or float(moved.max()) <= lr * (1 + 1e-4), k
        n_noise += int(noise.sum())
        n_all += noise.size
    assert n_noise < 0.02 * n_all, (n_noise, n_all)
