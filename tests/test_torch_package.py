"""Package-level checks of the PyTorch port: it stands alone (no JAX, no
``fv2p_tpu``), it refuses to fall back to the CPU, its weight loader is
strict, its sparse convolution matches the JAX one, and (on a machine with
a CUDA card only) each kernel matches its plain version."""
import ast
import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fv2p_tpu.models import build_network as jax_build_network
from fv2p_tpu.ops.sparse.conv import sparse_conv_apply as jax_sparse_conv_apply

import fv2p_torch.models as torch_models
from fv2p_torch.config import EasyDict, cfg_from_yaml_file
from fv2p_torch.datasets import dataset_meta_from_cfg
from fv2p_torch.ops.dcn import MdeformConvBlock
from fv2p_torch.ops.sparse.conv import sparse_conv_apply
from fv2p_torch.models.layers import BatchNorm
from fv2p_torch.ops.sparse.conv import MaskedBatchNorm
from fv2p_torch.utils.synthetic import batch_to_torch
from fv2p_torch.weights import (calibrate_batchnorm_, init_random_,
                                load_flax_variables)
from tests.test_fv2p_model import TINY_FV2P_CFG
from tests.test_mgaf_model import TINY_DATA_CFG, TINY_MODEL_CFG
from tests.test_torch_model import make_rulebook_batches, to_jax
from tests.test_torch_model import one_torch_thread  # noqa: F401 (an autouse fixture)

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'fv2p_tpu')


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split('.')[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split('.')[0]


@pytest.mark.parametrize('path', sorted(
    [p.relative_to(REPO) for p in (REPO / 'fv2p_torch').rglob('*.py')]
    + [Path('chip_smoke.py'), Path('tools/torch_kernel_variants.py'),
       Path('tools/torch_gate_probe.py'), Path('tools/torch_bn_probe.py')]), ids=str)
def test_port_imports_no_jax(path):
    bad = sorted({m for m in _imported_roots(REPO / path) if m in FORBIDDEN})
    assert not bad, f'{path} imports {bad}'


PORT_MODULES = sorted(
    '.'.join(p.relative_to(REPO).with_suffix('').parts[:-1] if p.name == '__init__.py'
             else p.relative_to(REPO).with_suffix('').parts)
    for p in (REPO / 'fv2p_torch').rglob('*.py'))

FIRST_IMPORT = """import importlib, json, sys
out = {}
for name in json.loads(sys.argv[1]):
    for m in [m for m in sys.modules if m == 'fv2p_torch' or m.startswith('fv2p_torch.')]:
        del sys.modules[m]
    try:
        importlib.import_module(name)
        out[name] = None
    except Exception as e:
        out[name] = f'{type(e).__name__}: {e}'
print(json.dumps(out))
"""


@pytest.fixture(scope='module')
def first_imports():
    """Each module of the port imported first, in one fresh interpreter
    (torch loaded once, every ``fv2p_torch`` module dropped from
    ``sys.modules`` before the next): the error each raised, or None."""
    import json
    import subprocess
    import sys
    done = subprocess.run([sys.executable, '-c', FIRST_IMPORT, json.dumps(PORT_MODULES)],
                          cwd=REPO, capture_output=True, text=True, timeout=300, check=True)
    return json.loads(done.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize('name', PORT_MODULES)
def test_module_imports_first(first_imports, name):
    """Every module imports in a fresh interpreter before any other of the
    package (no import cycle; ``ops.sparse.conv`` was one)."""
    assert first_imports[name] is None, first_imports[name]


def _cdll_calls(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    return [n for n in ast.walk(tree) if isinstance(n, ast.Call)
            and isinstance(n.func, ast.Attribute) and n.func.attr == 'CDLL']


def test_port_loads_only_its_own_libraries():
    """Shared libraries are loaded in two places only, each building its
    library from a source of the port into build/ at the repository root:
    nothing of fv2p_tpu's (its .so files included) is loaded."""
    from fv2p_torch.datasets.kitti.kitti_object_eval import eval as kitti_eval
    from fv2p_torch.ops import cuda as kcuda
    from fv2p_torch.ops.sparse import host_rulebook
    from fv2p_torch.utils import native
    loaders = sorted(str(p.relative_to(REPO)) for p in (REPO / 'fv2p_torch').rglob('*.py')
                     if _cdll_calls(p))
    assert loaders == ['fv2p_torch/ops/cuda/__init__.py', 'fv2p_torch/utils/native.py']
    for src in (host_rulebook.NATIVE_SRC, kitti_eval.NATIVE_SRC):
        assert src.is_relative_to(REPO / 'fv2p_torch')
        assert native.library_path(src).is_relative_to(REPO / 'build')
    for name in kcuda.KERNELS:
        assert kcuda.library_path(name).is_relative_to(REPO / 'build')


def test_build_network_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    meta = dataset_meta_from_cfg(TINY_DATA_CFG, 'train')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        torch_models.build_network(TINY_FV2P_CFG, 1, ['Car'], meta)


def test_unported_detector_raises():
    """A detector or a slot module that the port does not have raises
    NotImplementedError naming it (every shipped yaml builds: see
    ``test_every_yaml_names_ported_modules_only``)."""
    meta = dataset_meta_from_cfg(TINY_DATA_CFG, 'train')
    cfg = EasyDict(dict(TINY_FV2P_CFG, NAME='NoSuchNet'))
    with pytest.raises(NotImplementedError, match='detector NoSuchNet'):
        torch_models.build_network(cfg, 1, ['Car'], meta, device='cpu')
    cfg = EasyDict(dict(TINY_FV2P_CFG, PFE={'NAME': 'NoSuchPFE'}))
    with pytest.raises(NotImplementedError, match='PFE NoSuchPFE'):
        torch_models.build_network(cfg, 1, ['Car'], meta, device='cpu')


ALL_MODEL_YAMLS = sorted(str(p.relative_to(REPO / 'tools/cfgs'))
                         for p in (REPO / 'tools/cfgs').glob('*_models/**/*.yaml'))


def test_every_yaml_names_ported_modules_only():
    """Each of the yamls under tools/cfgs/*_models/ names a detector and,
    in every slot it fills, a module the port builds; read from the yaml
    alone, without building 30 full-width models."""
    from fv2p_torch.models.detectors import detector3d_template as det
    assert len(ALL_MODEL_YAMLS) == 30
    for rel in ALL_MODEL_YAMLS:
        cfg = EasyDict()
        cfg_from_yaml_file(str(REPO / 'tools/cfgs' / rel), cfg)
        assert cfg.MODEL.NAME in det.DETECTOR_REGISTRY, rel
        for key, names in det._PORTED.items():
            if key in cfg.MODEL:
                assert cfg.MODEL[key].NAME in names, (rel, key, cfg.MODEL[key].NAME)


def test_kitti_fv2p_yaml_builds_at_full_width():
    cfg = EasyDict()
    cfg_from_yaml_file(str(REPO / 'tools/cfgs/kitti_models/FV2P/fv2p.yaml'), cfg)
    meta = dataset_meta_from_cfg(cfg.DATA_CONFIG, 'test')
    assert meta['grid_size'] == (1408, 1600, 40)
    model = torch_models.build_network(cfg.MODEL, len(cfg.CLASS_NAMES),
                                       cfg.CLASS_NAMES, meta,
                                       compute_dtype=torch.bfloat16,
                                       device='cpu')
    init_random_(model, seed=0)
    assert model.roi_head.feature_net.sa_module.fused_ok()
    assert model.dense_head.anchors_flat.shape == (176 * 200 * 6, 7)
    n_params = sum(p.numel() for p in model.parameters())
    assert 5e6 < n_params < 5e7


MGAF_YAMLS = ('kitti_models/MGAF-3DSSD/mgaf-3dssd.yaml',
              'kitti_models/MGAF-3DSSD/mgaf-3dssd_3classes.yaml',
              'waymo_models/MGAF-3DSSD/waymo_mgaf-3dssd_e36.yaml')
# FV2P yamls whose parameter count is held to JAX's beside the MGAF ones
# (fv2p.yaml has its own test above)
FV2P_YAMLS = {'kitti_models/FV2P/fv2p_3classes.yaml': 20_995_058,
              'waymo_models/FV2P/waymo_fv2p_e30.yaml': 20_968_814}


def _jax_param_count(model_cfg, class_names, num_point_features):
    """Parameters of the JAX model of the same config, from an abstract init
    on the tiny batch with the config's point features in its voxels and
    raw points (no parameter shape depends on the grid)."""
    cfg = copy.deepcopy(model_cfg)
    cfg.DENSE_HEAD.NUM_INFERENCE_SAMPLES = 10        # the tiny map has 64 cells
    jax_np, _, meta = make_rulebook_batches()
    for key in ('voxels', 'points'):
        v = jax_np[key]
        jax_np[key] = np.pad(v, ((0, 0),) * (v.ndim - 1)
                             + ((0, num_point_features - v.shape[-1]),))
    meta = dict(meta, num_point_features=num_point_features)
    jmodel = jax_build_network(cfg, num_class=len(class_names),
                               class_names=class_names, dataset_meta=meta)
    shapes = jax.eval_shape(lambda b: jmodel.init(jax.random.PRNGKey(0), b),
                            dict(to_jax(jax_np)))
    return sum(int(np.prod(x.shape))
               for x in jax.tree_util.tree_leaves(shapes['params']))


@pytest.mark.parametrize('yaml_path', MGAF_YAMLS + tuple(FV2P_YAMLS))
def test_mgaf_yaml_builds_at_full_width(yaml_path):
    """Each yaml builds at full width with the JAX model's parameter count;
    for MGAF also its four deformable convs and the head's 768 input
    channels."""
    cfg = EasyDict()
    cfg_from_yaml_file(str(REPO / 'tools/cfgs' / yaml_path), cfg)
    meta = dataset_meta_from_cfg(cfg.DATA_CONFIG, 'test')
    model = torch_models.build_network(cfg.MODEL, len(cfg.CLASS_NAMES),
                                       cfg.CLASS_NAMES, meta,
                                       compute_dtype=torch.bfloat16,
                                       device='cpu')
    init_random_(model, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    assert n_params == _jax_param_count(cfg.MODEL, cfg.CLASS_NAMES,
                                        meta['num_point_features'])
    if yaml_path in FV2P_YAMLS:
        assert n_params == FV2P_YAMLS[yaml_path]
        assert model.dense_head.num_class == len(cfg.CLASS_NAMES)
        return
    dcns = {n: m for n, m in model.named_modules() if isinstance(m, MdeformConvBlock)}
    assert sorted(dcns) == ['backbone_2d.deblock0.dcn', 'backbone_2d.deblock1.dcn',
                            'backbone_2d.deblock2.dcn', 'dense_head.feature_adapt.mdcn']
    assert [tuple(m.kernel.shape) for m in dcns.values()] == [
        (9, 128, 128), (9, 256, 256), (9, 256, 256), (9, 256, 256)]
    assert dcns['dense_head.feature_adapt.mdcn'].deformable_groups == 4
    # seeded offsets: the deformable convs sample off the grid
    assert all(m.conv_offset_mask.weight.abs().max() > 0 for m in dcns.values())
    # the head reads the 768-channel BEV map at stride 8
    nx, ny, _ = meta['grid_size']
    x = torch.zeros((1, ny // 8, nx // 8, 256))
    shapes = [m.BatchNorm_1.weight.shape[0] for m in
              (model.backbone_2d.deblock0, model.backbone_2d.deblock1,
               model.backbone_2d.deblock2)]
    assert sum(shapes) == model.dense_head.shared_conv0.in_channels == 768
    with torch.no_grad():
        bd = model.backbone_2d({'spatial_features': x.to(torch.float32)})
    assert tuple(bd['spatial_features_2d'].shape) == (1, ny // 8, nx // 8, 768)
    assert model.dense_head.hm_out.out_channels == len(cfg.CLASS_NAMES)


def test_calibrated_batchnorms_put_out_zero_mean_unit_variance():
    """After calibrate_batchnorm_, a second forward over the same batch feeds
    every BatchNorm the input it was calibrated on: each channel comes out
    with mean 0 and variance var / (var + eps), over the valid voxel rows for
    the sparse ones."""
    _, torch_np, meta = make_rulebook_batches()
    batch = batch_to_torch(torch_np, 'cpu')
    model = init_random_(torch_models.build_network(
        TINY_MODEL_CFG, 1, ['Car'], meta, device='cpu'), seed=0)
    calibrate_batchnorm_(model, batch)
    seen = []

    def check(module, args, out):
        x = out.float()
        rows = (x[args[1]] if isinstance(module, MaskedBatchNorm)
                else x.movedim(module.axis, -1).reshape(-1, x.shape[module.axis]))
        var = module.running_var
        eps = module.eps if isinstance(module, BatchNorm) else 1e-3
        torch.testing.assert_close(rows.mean(0), torch.zeros_like(var),
                                   rtol=0, atol=1e-4)
        torch.testing.assert_close(rows.var(0, unbiased=False), var / (var + eps),
                                   rtol=1e-3, atol=1e-6)
        seen.append(module)

    bns = [m for m in model.modules() if isinstance(m, (BatchNorm, MaskedBatchNorm))]
    handles = [m.register_forward_hook(check) for m in bns]
    model(dict(batch))
    for h in handles:
        h.remove()
    assert len(seen) == len(bns) > 30
    assert not any(torch.equal(m.running_var, torch.ones_like(m.running_var))
                   for m in bns)


def test_weight_loader_rejects_a_stray_dcn_leaf():
    """A deformable block's kernel where the config builds none (FV2P's
    deblocks have no DCN) has no torch home."""
    meta = dataset_meta_from_cfg(TINY_DATA_CFG, 'train')
    model = torch_models.build_network(TINY_FV2P_CFG, 1, ['Car'], meta,
                                       device='cpu')
    stray = {'params': {'backbone_2d': {'deblock0': {'dcn': {
        'kernel': np.zeros((9, 32, 32), np.float32)}}}}}
    with pytest.raises(ValueError, match='deblock0/dcn/kernel'):
        load_flax_variables(model, stray)


def test_weight_loader_rejects_unmatched_and_unfilled():
    meta = dataset_meta_from_cfg(TINY_DATA_CFG, 'train')
    model = torch_models.build_network(TINY_FV2P_CFG, 1, ['Car'], meta,
                                       device='cpu')
    stray = {'params': {'point_head': {'cls_fc9': {'kernel': np.zeros((2, 2))}}}}
    with pytest.raises(ValueError, match='cls_fc9'):
        load_flax_variables(model, stray)


def test_sparse_conv_apply_matches_jax():
    rng = np.random.RandomState(0)
    n_in, n_out, k, cin, cout = 50, 40, 27, 8, 12
    feats = rng.randn(n_in, cin).astype(np.float32)
    nbr = rng.randint(0, n_in + 1, (k, n_out)).astype(np.int32)  # n_in = zero row
    w = rng.randn(k, cin, cout).astype(np.float32)
    ref = np.asarray(jax_sparse_conv_apply(jnp.asarray(feats),
                                           jnp.asarray(nbr), jnp.asarray(w)))
    got = sparse_conv_apply(torch.from_numpy(feats),
                            torch.from_numpy(nbr.T.astype(np.int64)),
                            torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """Runs on a machine with a CUDA card (``python -m pytest -m cuda
    tests/test_torch_package.py``); chip_smoke.py does the same at the main
    path's shapes."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernels are built with nvcc')
    from fv2p_torch.ops.cuda import fps, rotated_iou, three_nn
    from fv2p_torch.utils import iou3d
    g = torch.Generator().manual_seed(0)
    pts = torch.rand(2, 3000, 3, generator=g) * 40
    valid = torch.rand(2, 3000, generator=g) > 0.1
    d = pts.cuda()
    assert torch.equal(fps.fps(d, valid.cuda(), 256).cpu(),
                       fps.fps_plain(pts, valid, 256))
    q = torch.rand(2, 500, 3, generator=g) * 40
    dk, ik = three_nn.three_nn(d, valid.cuda(), q.cuda())
    dp, ip = three_nn.three_nn_plain(pts, valid, q)
    assert torch.equal(ik.cpu(), ip)
    boxes = torch.cat([torch.rand(64, 2, generator=g) * 8,
                       torch.rand(64, 1, generator=g),
                       torch.rand(64, 3, generator=g) * 3 + 1,
                       torch.rand(64, 1, generator=g) * 6], dim=1)
    corners = iou3d._bev_corners_ccw(boxes)
    ov = rotated_iou.overlap_matrix(corners.cuda(), corners.cuda()).cpu()
    torch.testing.assert_close(ov, rotated_iou.overlap_matrix_plain(corners, corners),
                               rtol=0, atol=1e-4)
    # the IoU entry points compute corners and areas themselves: the sines
    # and cosines come from the card on one side and the CPU on the other
    iou = rotated_iou.iou_bev(boxes.cuda(), boxes[:20].cuda()).cpu()
    torch.testing.assert_close(iou, rotated_iou.iou_bev_plain(boxes, boxes[:20]),
                               rtol=0, atol=1e-4)
    upper = rotated_iou.iou_bev_upper(boxes.cuda()).cpu()
    torch.testing.assert_close(upper, rotated_iou.iou_bev_upper_plain(boxes),
                               rtol=0, atol=1e-4)
    assert (upper.tril() == 0).all() and (upper > 0).any()
