"""Package-level checks of the PyTorch port: it stands alone (no JAX, no
``fv2p_tpu``), it refuses to fall back to the CPU, its weight loader is
strict, its sparse convolution matches the JAX one, and (on a machine with
a CUDA card only) each kernel matches its plain version."""
import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fv2p_tpu.ops.sparse.conv import sparse_conv_apply as jax_sparse_conv_apply

import fv2p_torch.models as torch_models
from fv2p_torch.config import EasyDict, cfg_from_yaml_file
from fv2p_torch.datasets import dataset_meta_from_cfg
from fv2p_torch.ops.sparse.conv import sparse_conv_apply
from fv2p_torch.weights import init_random_, load_flax_variables
from tests.test_fv2p_model import TINY_FV2P_CFG
from tests.test_mgaf_model import TINY_DATA_CFG

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
    + [Path('chip_smoke.py'), Path('tools/torch_kernel_variants.py')]), ids=str)
def test_port_imports_no_jax(path):
    bad = sorted({m for m in _imported_roots(REPO / path) if m in FORBIDDEN})
    assert not bad, f'{path} imports {bad}'


def test_build_network_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    meta = dataset_meta_from_cfg(TINY_DATA_CFG, 'train')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        torch_models.build_network(TINY_FV2P_CFG, 1, ['Car'], meta)


def test_unported_detector_raises():
    meta = dataset_meta_from_cfg(TINY_DATA_CFG, 'train')
    cfg = EasyDict(dict(TINY_FV2P_CFG, NAME='MGAF3DSSD'))
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        torch_models.build_network(cfg, 1, ['Car'], meta, device='cpu')


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
