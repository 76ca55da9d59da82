"""Each kernel's plain PyTorch version against the JAX function it ports,
run as the JAX package's own tests run it on the CPU: the Pallas kernel in
interpret mode, and the XLA path beside it.

  B1 rotated-IoU overlap  <- ops/pallas/rotated_iou.py:overlap_matrix
  B2 farthest-point sample <- ops/pallas/fps.py:fps_pallas
  B3 exact 3-NN            <- ops/pallas/three_nn.py:three_nn_pallas
  B4 fused SA group        <- ops/pallas/sa_group.py:sa_group_pool_fused

Tolerances: indices, keep flags and counts are exact. B3 distances: rtol
1e-6 (a few ulps: XLA:CPU fuses multiply-adds). B1 areas: atol 1e-4
(m^2; the same clip arithmetic in another evaluation order). B4 output is
bf16: |diff| <= 1.6e-2 * max(1, |ref|), about two bf16 ulps, since both
sides round layer 1 to bf16 and differ only in the f32 order of the
layer-2 sums.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fv2p_tpu.models.roi_heads.iouguided_roi_head as jax_roi
from fv2p_tpu.ops import pointops as jax_pointops
from fv2p_tpu.ops.pallas.fps import fps_pallas
from fv2p_tpu.ops.pallas.rotated_iou import overlap_matrix as jax_overlap_matrix
from fv2p_tpu.ops.pallas.sa_group import sa_group_pool_fused as jax_sa_fused
from fv2p_tpu.ops.pallas.three_nn import three_nn_pallas
from fv2p_tpu.utils import iou3d as jax_iou3d

from fv2p_torch.models.roi_heads.iouguided_roi_head import _SAModuleMSG
from fv2p_torch.ops import pointops
from fv2p_torch.ops.cuda import aligned, launch_counts, reset_launch_counts
from fv2p_torch.ops.cuda.fps import fps, fps_chain_floor_cuda, fps_cuda, fps_plain
from fv2p_torch.ops.cuda.rotated_iou import (
    iou_bev_cuda, iou_bev_plain, iou_bev_upper_cuda, iou_bev_upper_plain,
    overlap_matrix_cuda, overlap_matrix_plain)
from fv2p_torch.ops.cuda.sa_group import sa_group_pool_plain
from fv2p_torch.ops.cuda.three_nn import three_nn_cuda, three_nn_plain
from fv2p_torch.utils import iou3d
from fv2p_torch.weights import load_flax_variables
from tests.test_torch_model import one_torch_thread  # noqa: F401 (an autouse fixture)

RADII = (0.8, 1.6)
NSAMPLES = (16, 32)
B4_TOL = 1.6e-2


def t(x):
    return torch.from_numpy(np.array(x))


def random_boxes(rng, n, extent=12.0):
    """(n, 7) boxes clustered enough that many pairs overlap."""
    return np.concatenate([
        rng.uniform(-extent, extent, (n, 2)), rng.uniform(-1, 1, (n, 1)),
        rng.uniform(1.0, 5.0, (n, 2)), rng.uniform(1.0, 2.0, (n, 1)),
        rng.uniform(-np.pi, np.pi, (n, 1))], axis=1).astype(np.float32)


# ---------------------------------------------------------------- B1 + NMS

def test_b1_overlap_matches_clip_and_pallas():
    rng = np.random.RandomState(0)
    a = random_boxes(rng, 70, extent=4.0)
    b = random_boxes(rng, 45, extent=4.0)
    b[:5] = a[:5]                                    # identical pairs
    ca = jax_iou3d._bev_corners_ccw(jnp.asarray(a))
    cb = jax_iou3d._bev_corners_ccw(jnp.asarray(b))
    tca, tcb = iou3d._bev_corners_ccw(t(a)), iou3d._bev_corners_ccw(t(b))
    np.testing.assert_allclose(tca.numpy(), np.asarray(ca), atol=1e-5)

    got = overlap_matrix_plain(tca, tcb).numpy()
    pallas = np.asarray(jax_overlap_matrix(ca, cb))        # interpret on CPU
    n, m = len(a), len(b)
    xla = np.asarray(jax_iou3d._polygon_clip_area(
        jnp.broadcast_to(ca[:, None], (n, m, 4, 2)),
        jnp.broadcast_to(cb[None, :], (n, m, 4, 2))))
    np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got, xla, rtol=0, atol=1e-4)
    assert (got > 0).mean() > 0.2                   # many real overlaps
    np.testing.assert_allclose(np.diag(got[:5, :5]), a[:5, 3] * a[:5, 4],
                               rtol=1e-4)


def _axis_boxes(xy, size, heading=0.0):
    out = np.zeros((len(xy), 7), np.float32)
    out[:, :2], out[:, 3:6], out[:, 6] = xy, size, heading
    return out


def _b1_case(case):
    """(boxes_a, boxes_b, expected IoU or None): the pairs the kernel's cull
    and its upper triangle rest on."""
    rng = np.random.RandomState(21)
    lattice = np.stack(np.meshgrid(np.arange(5.0), np.arange(4.0)),
                       -1).reshape(-1, 2)
    if case == 'well_separated':          # >= 10 m apart, at most 5 m long
        a = random_boxes(rng, 20, extent=2.0)
        a[:, :2] += lattice * 20.0
        b = random_boxes(rng, 20, extent=2.0)
        b[:, :2] += lattice[::-1] * 20.0 + 10.0
        return a, b, None
    if case == 'touch_edges_and_corners':  # unit squares on the unit lattice
        a = _axis_boxes(lattice, 1.0)
        want = np.eye(len(a), dtype=np.float32)
        return a, a, want
    a = _axis_boxes(lattice * np.sqrt(2.0), 1.0, np.pi / 4)   # diamonds
    return a, a, None


@pytest.mark.parametrize('case', ['well_separated', 'touch_edges_and_corners',
                                  'touch_corners_rotated'])
def test_b1_disjoint_and_touching_boxes_match_pallas(case):
    """The facts the CUDA kernel's cull rests on: boxes whose circumcircles
    lie apart overlap by exactly 0.0, in the plain version and in the Pallas
    kernel alike, and boxes that only touch overlap by (about) nothing."""
    a, b, want = _b1_case(case)
    ca = jax_iou3d._bev_corners_ccw(jnp.asarray(a))
    cb = jax_iou3d._bev_corners_ccw(jnp.asarray(b))
    pallas = np.asarray(jax_overlap_matrix(ca, cb))        # interpret on CPU
    got = overlap_matrix_plain(iou3d._bev_corners_ccw(t(a)),
                               iou3d._bev_corners_ccw(t(b))).numpy()
    np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-4)
    dist = np.linalg.norm(a[:, None, :2] - b[None, :, :2], axis=-1)
    reach = 0.5 * (np.hypot(a[:, 3], a[:, 4])[:, None]
                   + np.hypot(b[:, 3], b[:, 4])[None, :])
    apart = dist > 1.001 * reach
    assert apart.sum() > len(a)
    assert (got[apart] == 0.0).all() and (pallas[apart] == 0.0).all()
    if case == 'well_separated':
        assert apart.all()
    else:                                  # touching pairs: no area to speak of
        touching = ~apart & ~np.eye(len(a), dtype=bool)
        assert touching.sum() >= len(a)
        assert np.abs(got[touching]).max() <= 1e-4
    if want is not None:
        np.testing.assert_allclose(iou_bev_plain(t(a), t(b)).numpy(), want,
                                   rtol=0, atol=1e-4)


def test_b1_iou_epilogue_matches_jax_boxes_iou_bev():
    """The IoU entry point's plain version (corners, areas and division as
    the kernel does them) against the JAX package's boxes_iou_bev; the
    port's boxes_iou_bev is that entry point."""
    rng = np.random.RandomState(22)
    a = random_boxes(rng, 60, extent=5.0)
    b = random_boxes(rng, 37, extent=5.0)
    b[:4] = a[:4]
    ref = np.asarray(jax_iou3d.boxes_iou_bev(jnp.asarray(a), jnp.asarray(b)))
    got = iou_bev_plain(t(a), t(b)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(iou3d.boxes_iou_bev(t(a), t(b)).numpy(), got)
    np.testing.assert_allclose(np.diag(got[:4, :4]), 1.0, atol=1e-4)
    assert (got > 0.05).mean() > 0.1


@pytest.mark.parametrize('n', [1, 33, 70])
def test_b1_upper_triangle_is_the_full_matrix_above_the_diagonal(n):
    rng = np.random.RandomState(23 + n)
    a = random_boxes(rng, n, extent=4.0)
    full = iou_bev_plain(t(a), t(a)).numpy()
    upper = iou_bev_upper_plain(t(a)).numpy()
    i, j = np.indices((n, n))
    np.testing.assert_array_equal(upper[i < j], full[i < j])
    assert (upper[i >= j] == 0.0).all()
    ref = np.asarray(jax_iou3d.boxes_iou_bev(jnp.asarray(a), jnp.asarray(a)))
    np.testing.assert_allclose(upper[i < j], ref[i < j], rtol=0, atol=1e-4)


def mgaf_extent_boxes(rng, normal, far):
    """Boxes with the extents MGAF's raw dim decode gives (no exp): negative,
    zero and mixed-sign dx and dy, one per extent pair, each on the center
    of a box of ``normal`` (near) or 60 m beyond every box (far)."""
    extents = np.array([(-3.0, 1.5), (2.5, -1.2), (-2.0, -1.6), (0.0, 1.5),
                        (1.8, 0.0), (0.0, 0.0), (-1e-3, 2.0), (0.0, -1.0),
                        (-4.0, -0.5)], np.float32)
    out = normal[:len(extents)].copy()
    out[:, 3:5] = extents
    out[:, :2] += rng.uniform(-0.4, 0.4, (len(extents), 2))
    if far:
        out[:, 0] += 60.0
    return out


@pytest.mark.parametrize('far', [False, True], ids=['near', 'far'])
def test_b1_negative_and_zero_extents_match_pallas(far):
    """Plain version against the Pallas kernel (interpret mode) and the JAX
    IoU for such boxes, as rows, as columns and within one set (the NMS
    check). They are not all 0.0: a row box with one negative extent is a
    clockwise quad, whose clip against a box it overlaps has an area, and a
    size-0 column box returns the row box's area, near or far. Apart from
    that, far pairs are exactly 0.0, which is what the CUDA kernel's cull
    gives (it never culls a box with a null edge)."""
    rng = np.random.RandomState(24)
    normal = random_boxes(rng, 12, extent=6.0)
    odd = mgaf_extent_boxes(rng, normal, far)
    mixed = np.concatenate([normal, odd])
    for a, b in ((odd, normal), (normal, odd), (mixed, mixed)):
        ca = jax_iou3d._bev_corners_ccw(jnp.asarray(a))
        cb = jax_iou3d._bev_corners_ccw(jnp.asarray(b))
        pallas = np.asarray(jax_overlap_matrix(ca, cb))     # interpret on CPU
        got = overlap_matrix_plain(iou3d._bev_corners_ccw(t(a)),
                                   iou3d._bev_corners_ccw(t(b))).numpy()
        np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-4)
        ref = np.asarray(jax_iou3d.boxes_iou_bev(jnp.asarray(a), jnp.asarray(b)))
        iou = iou_bev_plain(t(a), t(b)).numpy()
        np.testing.assert_allclose(iou, ref, rtol=1e-5, atol=1e-4)
    n = len(normal)
    cross = got[n:, :n]                              # odd rows x normal columns
    point = (odd[:, 3] == 0) & (odd[:, 4] == 0)
    np.testing.assert_allclose(got[:n, n:][:, point],
                               np.repeat(normal[:, 3:4] * normal[:, 4:5],
                                         point.sum(), 1), rtol=1e-5)
    if far:
        assert (cross == 0.0).all() and (pallas[n:, :n] == 0.0).all()
        assert (got[:n, n:][:, ~point] == 0.0).all()
        assert (pallas[:n, n:][:, ~point] == 0.0).all()
    else:
        assert (cross > 0).any() and (got[:n, n:] > 0).any()
    upper = iou_bev_upper_plain(t(mixed)).numpy()
    np.testing.assert_array_equal(upper[np.triu_indices(len(mixed), 1)],
                                  iou[np.triu_indices(len(mixed), 1)])


@pytest.mark.parametrize('n,post_max,thresh', [(300, 50, 0.3),
                                                (2200, 120, 0.2)])
def test_nms_rotated_matches_jax(n, post_max, thresh):
    """Dense path (n <= 2048) and the blocked path with several blocks."""
    rng = np.random.RandomState(n)
    boxes = random_boxes(rng, n, extent=9.0)
    scores = rng.rand(n).astype(np.float32)
    scores[rng.rand(n) < 0.1] = -np.inf               # invalid entries
    scores[10:20] = scores[0]                         # exact score ties
    ref_idx, ref_valid = jax_iou3d.nms_rotated(
        jnp.asarray(boxes), jnp.asarray(scores), thresh, pre_max=n,
        post_max=post_max)
    idx, valid = iou3d.nms_rotated(t(boxes), t(scores), thresh, pre_max=n,
                                   post_max=post_max)
    ref_valid = np.asarray(ref_valid)
    np.testing.assert_array_equal(valid.numpy(), ref_valid)
    np.testing.assert_array_equal(idx.numpy()[ref_valid],
                                  np.asarray(ref_idx)[ref_valid])
    assert 10 < ref_valid.sum()


@pytest.mark.parametrize('n', [40, 2100])
def test_nms_rotated_long_suppression_chain(n):
    """Boxes in a row, each overlapping only its neighbours: every second
    box survives, and the greedy fixed point needs about n steps, many
    rounds of them (dense path, and blocked with the chain crossing a
    block boundary)."""
    boxes = np.zeros((n, 7), np.float32)
    boxes[:, 0] = np.arange(n) * 0.5
    boxes[:, 3:6] = (1.0, 1.0, 1.0)
    scores = np.linspace(1.0, 0.5, n).astype(np.float32)
    post_max = n // 2 + 5
    ref_idx, ref_valid = jax_iou3d.nms_rotated(
        jnp.asarray(boxes), jnp.asarray(scores), 0.2, pre_max=n,
        post_max=post_max)
    idx, valid = iou3d.nms_rotated(t(boxes), t(scores), 0.2, pre_max=n,
                                   post_max=post_max)
    ref_valid = np.asarray(ref_valid)
    np.testing.assert_array_equal(valid.numpy(), ref_valid)
    np.testing.assert_array_equal(idx.numpy()[ref_valid],
                                  np.asarray(ref_idx)[ref_valid])
    np.testing.assert_array_equal(idx.numpy()[ref_valid], np.arange(0, n, 2))


# ---------------------------------------------------------------------- B2

def test_b2_fps_matches_pallas_with_invalid_rows():
    rng = np.random.RandomState(0)
    b, n, k = 4, 400, 128
    pts = (rng.rand(b, n, 3) * 50).astype(np.float32)
    valid = np.ones((b, n), bool)
    valid[1, 250:] = False
    valid[2, ::3] = False
    valid[3, :] = False                               # no valid point
    ref = np.asarray(fps_pallas(jnp.asarray(pts), jnp.asarray(valid), k,
                                interpret=True))
    got = fps_plain(t(pts), t(valid), k)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got[3].numpy(), np.zeros(k, np.int32))


def test_b2_batch_fps_wraparound_matches_jax():
    rng = np.random.RandomState(1)
    b, n, k = 2, 64, 32
    pts = rng.rand(b, n, 3).astype(np.float32)
    valid = np.ones((b, n), bool)
    valid[0, 10:] = False                             # 10 valid < K
    ref = np.asarray(jax_pointops.farthest_point_sample_batch(
        jnp.asarray(pts), jnp.asarray(valid), k))
    got = pointops.farthest_point_sample_batch(t(pts), t(valid), k)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got[0, 10:20].numpy(), got[0, :10].numpy())


def _fps_corner(case):
    rng = np.random.RandomState(11)
    if case == 'ties':                       # every point five times, shuffled
        pts = np.repeat(rng.rand(2, 40, 3) * 10, 5, axis=1)
        pts = pts[:, rng.permutation(200)]
        return pts, np.ones((2, 200), bool), 100
    if case == 'all_equal':
        return np.full((2, 96, 3), 1.5), np.ones((2, 96), bool), 16
    pts = rng.rand(2, 120, 3) * 30           # fewer valid points than picks
    valid = np.zeros((2, 120), bool)
    valid[0, 3:10] = True
    valid[1, ::17] = True
    return pts, valid, 48


@pytest.mark.parametrize('case', ['ties', 'all_equal', 'fewer_valid_than_picks'])
def test_b2_fps_corner_cases_match_pallas(case):
    """The corners the card holds the CUDA kernel to (chip_smoke.py): the
    lowest index wins a tie, and once every valid point is taken the picks
    repeat as the Pallas kernel's do."""
    pts, valid, k = _fps_corner(case)
    pts = pts.astype(np.float32)
    ref = np.asarray(fps_pallas(jnp.asarray(pts), jnp.asarray(valid), k,
                                interpret=True))
    got = fps_plain(t(pts), t(valid), k).numpy()
    np.testing.assert_array_equal(got, ref)
    if case == 'all_equal':
        assert (got == 0).all()
    if case == 'fewer_valid_than_picks':
        assert valid[np.arange(2)[:, None], got].all()    # only valid points
        assert len(set(got[0])) == 7


def _builds(model_cfg):
    """Whether the port builds this MODEL config: its detector and every
    slot it names are ported (the 4 PartA2 yamls are not)."""
    from fv2p_torch.models.detectors.detector3d_template import (
        _PORTED, _SLOT_KEYS, DETECTOR_REGISTRY)
    return model_cfg.NAME in DETECTOR_REGISTRY and all(
        model_cfg[key].NAME in _PORTED[key] for key in _SLOT_KEYS.values()
        if key in model_cfg)


def test_b2_limit_covers_every_built_yaml_scan_cap():
    """The kernel takes the raw-point cap of every yaml under tools/cfgs/
    that the port builds (the dataset pads every scan to
    MAX_POINTS_PER_SCAN): Waymo FV2P's and Waymo PV-RCNN's 180000 are the
    largest."""
    from fv2p_torch.config import EasyDict, cfg_from_yaml_file
    from fv2p_torch.ops.cuda import fps as fps_module
    repo = Path(__file__).resolve().parent.parent
    caps = {}
    for path in sorted((repo / 'tools' / 'cfgs').glob('*_models/**/*.yaml')):
        cfg = EasyDict()
        cfg_from_yaml_file(str(path), cfg)
        if 'MAX_POINTS_PER_SCAN' in cfg.DATA_CONFIG and _builds(cfg.MODEL):
            caps[str(path.relative_to(repo))] = int(cfg.DATA_CONFIG.MAX_POINTS_PER_SCAN)
    assert caps['tools/cfgs/kitti_models/FV2P/fv2p.yaml'] == 24000
    assert max(caps.values()) == 180000
    assert {k for k, v in caps.items() if v == 180000} == {
        'tools/cfgs/waymo_models/FV2P/waymo_fv2p_e30.yaml',
        'tools/cfgs/waymo_models/pv_rcnn.yaml'}
    assert fps_module.MAX_POINTS >= max(caps.values())
    # the C source refuses above the same limit the wrapper checks
    src = (Path(fps_module.__file__).resolve().parent.parent / 'csrc' / 'fps.cu').read_text()
    assert f'kMaxPointsWide = {fps_module.MAX_POINTS // (16 * 512)} * kWideStride' in src
    assert 'kWideStride = kWideCluster * kWideThreads' in src
    assert 'kWideCluster = 16;' in src and 'kWideThreads = 512;' in src
    assert 'n > kMaxPointsWide) return static_cast<int>(cudaErrorInvalidValue)' in src


@pytest.mark.cuda
@pytest.mark.parametrize('n,n_valid', [(24000, 22500), (24576, 24576), (18000, 17000),
                                       (180000, 30000)])
def test_b2_kernel_on_card_at_train_scan_sizes(n, n_valid):
    """Runs on a machine with a CUDA card (``python -m pytest -m cuda
    tests/test_torch_kernels.py``): the whole-scan instantiation (18000),
    the own-points one (24000 with an invalid tail, 24576) and the 16-block
    one (a Waymo scan, 180000 points with 30000 valid) pick exactly as the
    plain version."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernels are built with nvcc')
    g = torch.Generator().manual_seed(n)
    pts = torch.randn(2, n, 3, generator=g) * 20
    valid = torch.zeros(2, n, dtype=torch.bool)
    valid[:, :n_valid] = True
    valid[1, 5::7] = False
    got = fps_cuda(pts.cuda(), valid.cuda(), 512)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), fps_plain(pts, valid, 512))


def test_cpu_dispatch_takes_plain_version():
    """A CPU tensor runs the plain version and launches nothing."""
    reset_launch_counts()
    pts = torch.rand(1, 50, 3)
    out = fps(pts, torch.ones(1, 50, dtype=torch.bool), 8)
    assert out.shape == (1, 8) and out.dtype == torch.int32
    assert all(v == 0 for v in launch_counts.values())


@pytest.mark.parametrize('entry', [fps_cuda, fps_chain_floor_cuda])
def test_b2_cuda_entry_points_refuse_cpu_tensors(entry):
    """The kernel's entry points never fall back: a CPU tensor is an error
    there (only the dispatching ``fps`` takes the plain version)."""
    reset_launch_counts()
    with pytest.raises(ValueError, match='CUDA tensor'):
        entry(torch.rand(1, 50, 3), torch.ones(1, 50, dtype=torch.bool), 8)
    assert launch_counts['fps'] == 0


@pytest.mark.parametrize('entry,shapes', [
    (three_nn_cuda, ((1, 50, 3), (1, 50), (1, 9, 3))),
    (overlap_matrix_cuda, ((5, 4, 2), (6, 4, 2))),
    (iou_bev_cuda, ((5, 7), (6, 7))),
    (iou_bev_upper_cuda, ((5, 7),)),
], ids=lambda v: getattr(v, '__name__', ''))
def test_b1_b3_cuda_entry_points_refuse_cpu_tensors(entry, shapes):
    """As for FPS: the kernels' entry points raise on a CPU tensor and count
    no launch; only the dispatching functions take the plain version."""
    reset_launch_counts()
    args = [torch.ones(s, dtype=torch.bool) if len(s) == 2 and entry is three_nn_cuda
            else torch.rand(s) for s in shapes]
    with pytest.raises(ValueError, match='CUDA tensor'):
        entry(*args)
    assert all(v == 0 for v in launch_counts.values())


def test_aligned_copies_only_offset_views():
    """The SA-group kernel copies 16-byte pieces: a view that starts off a
    16-byte boundary is copied, an aligned tensor is passed through."""
    base = torch.arange(64, dtype=torch.bfloat16)
    assert aligned(base) is base
    view = base[1:33]
    assert view.data_ptr() % 16 != 0
    copy = aligned(view)
    assert copy.data_ptr() % 16 == 0 and torch.equal(copy, view)


# ---------------------------------------------------------------------- B3

def test_b3_three_nn_matches_pallas():
    rng = np.random.RandomState(7)
    src = (rng.randn(700, 3) * 10).astype(np.float32)
    q = (rng.randn(300, 3) * 10).astype(np.float32)
    valid = rng.rand(700) > 0.15
    d_ref, i_ref = three_nn_pallas(jnp.asarray(src), jnp.asarray(valid),
                                   jnp.asarray(q), bm=128, bn=512,
                                   interpret=True)
    d, i = three_nn_plain(t(src)[None], t(valid)[None], t(q)[None])
    np.testing.assert_array_equal(i[0].numpy(), np.asarray(i_ref))
    # XLA:CPU contracts the squared distance into fused multiply-adds, the
    # plain version does not: the distances may differ in the last ulp
    np.testing.assert_allclose(d[0].numpy(), np.asarray(d_ref), rtol=1e-6)


def _b3_oracle(src, valid, q):
    """Brute force over (f32 distance + 1e10 if invalid, index): the order
    the plain version and the CUDA kernel promise."""
    diff = q[:, None, :] - src[None]
    d = (diff[..., 0] ** 2 + diff[..., 1] ** 2) + diff[..., 2] ** 2
    d = d + np.where(valid, 0.0, 1e10).astype(np.float32)[None]
    idx = np.argsort(d, axis=1, kind='stable')[:, :3]
    return np.take_along_axis(d, idx, 1), idx


def _b3_case(case):
    rng = np.random.RandomState(31)
    q = (rng.randn(40, 3) * 10).astype(np.float32)
    n = {'n1': 1, 'n2': 2, 'n129': 129}.get(case, 300)
    src = (rng.randn(n, 3) * 10).astype(np.float32)
    valid = np.ones(n, bool)
    if case == 'two_valid':
        valid[:] = False
        valid[[7, 200]] = True
    elif case == 'none_valid':
        valid[:] = False
    elif case == 'mask_with_holes':
        valid = rng.rand(n) < 0.5
        valid[:5] = False
    elif case == 'random_order':          # key-sorted grid, then shuffled
        gy, gx, gz = np.meshgrid(np.arange(10), np.arange(10), np.arange(3),
                                 indexing='ij')
        src = np.stack([gx, gy, gz], -1).reshape(-1, 3).astype(np.float32)
        src = src[rng.permutation(len(src))] * np.float32(0.8)
        valid = rng.rand(len(src)) < 0.9
        q = (rng.rand(40, 3) * [8, 8, 2.4]).astype(np.float32)
    elif case == 'ties_across_row_128':   # one point on rows 126-130, 254-258
        src[126:131] = src[126]
        src[254:259] = src[254]
        q[:3] = src[126]
        q[3:6] = src[254]
    return src, valid, q


@pytest.mark.parametrize('case', [
    'two_valid', 'none_valid', 'mask_with_holes', 'random_order',
    'ties_across_row_128', 'n1', 'n2', 'n129'])
def test_b3_three_nn_corner_cases_match_pallas(case):
    """The corners the card holds the CUDA kernel to (chip_smoke.py). Where a
    slot has a valid source, the plain version equals the Pallas kernel
    (indices exact, distances rtol 1e-6). Where fewer than three sources are
    valid the two fill the rest differently (the Pallas kernel repeats an
    index at 1e10), and the plain version is held to its own rule: invalid
    sources at 1e10 + d, the lowest index first, then (inf, 0)."""
    src, valid, q = _b3_case(case)
    n = len(src)
    d_ref, i_ref = three_nn_pallas(jnp.asarray(src), jnp.asarray(valid),
                                   jnp.asarray(q), bm=128, bn=128,
                                   interpret=True)
    d_ref, i_ref = np.asarray(d_ref), np.asarray(i_ref)
    d, i = three_nn_plain(t(src)[None], t(valid)[None], t(q)[None])
    d, i = d[0].numpy(), i[0].numpy()
    real = d_ref < 1e9                     # slots with a valid source
    assert real.sum() == len(q) * min(3, int(valid.sum()))
    np.testing.assert_array_equal(i[real], i_ref[real])
    np.testing.assert_allclose(d[real], d_ref[real], rtol=1e-6)
    d_or, i_or = _b3_oracle(src, valid, q)
    filled = min(3, n)
    np.testing.assert_array_equal(i[:, :filled], i_or[:, :filled])
    np.testing.assert_allclose(d[:, :filled], d_or[:, :filled], rtol=1e-6)
    assert np.isinf(d[:, filled:]).all() and (i[:, filled:] == 0).all()
    assert (d[~real] >= 1e10).all()
    if case == 'ties_across_row_128':
        np.testing.assert_array_equal(i[:6], [[126, 127, 128]] * 3
                                      + [[254, 255, 256]] * 3)


def test_b3_three_nn_ties_lowest_index():
    rng = np.random.RandomState(8)
    src = np.repeat(rng.randn(60, 3).astype(np.float32), 4, axis=0)
    q = src[::5] + 1e-6
    ones = np.ones(len(src), bool)
    d_ref, i_ref = three_nn_pallas(jnp.asarray(src), jnp.asarray(ones),
                                   jnp.asarray(q), bm=128, bn=128,
                                   interpret=True)
    _, i = three_nn_plain(t(src)[None], t(ones)[None], t(q)[None])
    np.testing.assert_array_equal(i[0].numpy(), np.asarray(i_ref))


def test_b3_interpolate_matches_xla_path():
    """Against the off-TPU XLA path (matmul-expanded distances) on inputs
    without near-ties, with a float tolerance."""
    rng = np.random.RandomState(9)
    src = (rng.randn(2, 500, 3) * 5).astype(np.float32)
    feats = rng.randn(2, 500, 16).astype(np.float32)
    valid = rng.rand(2, 500) > 0.2
    q = (rng.randn(2, 200, 3) * 5).astype(np.float32)
    ref = np.stack([np.asarray(jax_pointops.three_nn_interpolate(
        jnp.asarray(src[b]), jnp.asarray(valid[b]), jnp.asarray(feats[b]),
        jnp.asarray(q[b]))) for b in range(2)])
    got = pointops.three_nn_interpolate(t(src), t(valid), t(feats), t(q))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------- B4

def _sa_data(seed, r=3, p=64, g=27, c=64):
    """Point sets whose center-point distances keep clear of the ball
    boundaries (the Pallas kernel's d2 is a matmul expansion, the port's
    elementwise), with some grid centers far from every point."""
    for s in range(seed, seed + 50):
        rng = np.random.RandomState(s)
        xyz = rng.randn(r, p, 3).astype(np.float32)
        valid = rng.rand(r, p) < 0.9
        feats = rng.randn(r, p, c).astype(np.float32)
        centers = (rng.randn(r, g, 3) * 0.7).astype(np.float32)
        centers[:, -3:] = 50.0                         # empty balls
        d2 = ((centers[:, :, None, :].astype(np.float64)
               - xyz[:, None, :, :]) ** 2).sum(-1)
        if min(np.abs(d2 - rad * rad).min() for rad in RADII) > 1e-4:
            return xyz, valid, feats, centers
    raise AssertionError('no boundary-safe seed found')


def assert_bf16_close(got, ref):
    got = got.detach().float().numpy()
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    assert got.shape == ref.shape
    err = np.abs(got - ref) / np.maximum(np.abs(ref), 1.0)
    assert err.max() <= B4_TOL, err.max()


def test_b4_sa_group_matches_pallas():
    xyz, valid, _, centers = _sa_data(0)
    rng = np.random.RandomState(3)
    r, p, g, h = xyz.shape[0], xyz.shape[1], centers.shape[1], 64
    z = rng.randn(2, r, p, h).astype(np.float32)
    cw = rng.randn(2, r, g, h).astype(np.float32)
    w2 = (rng.randn(2, h, h) / 8).astype(np.float32)
    b1 = rng.randn(2, h).astype(np.float32) * 0.5
    b2 = rng.randn(2, h).astype(np.float32) * 0.1
    pad = 128 - h
    ref = jax_sa_fused(
        jnp.asarray(centers), jnp.asarray(xyz), jnp.asarray(valid),
        [jnp.pad(jnp.asarray(z[i]), ((0, 0), (0, 0), (0, pad))) for i in range(2)],
        [jnp.pad(jnp.asarray(cw[i]), ((0, 0), (0, 0), (0, pad))) for i in range(2)],
        [jnp.pad(jnp.asarray(w2[i]), ((0, pad), (0, pad))) for i in range(2)],
        [jnp.pad(jnp.asarray(b1[i]), (0, pad))[None] for i in range(2)],
        [jnp.pad(jnp.asarray(b2[i]), (0, pad))[None] for i in range(2)],
        RADII, NSAMPLES, interpret=True)
    got = sa_group_pool_plain(
        t(centers), t(xyz), t(valid), t(z).to(torch.bfloat16), t(cw),
        t(w2).to(torch.bfloat16), t(b1), t(b2), RADII, NSAMPLES)
    assert got.dtype == torch.bfloat16
    assert_bf16_close(got, ref)
    # an empty ball pools relu(relu(b1) @ W2 + b2) over its single slot
    h1 = torch.relu(t(b1)).to(torch.bfloat16).float()
    empty = torch.relu(torch.einsum('ik,ikj->ij', h1, t(w2).to(torch.bfloat16)
                                    .float()) + t(b2)).reshape(-1)
    assert_bf16_close(got[:, -1].reshape(r, -1)[0:1], empty[None].numpy())


@pytest.mark.parametrize('case,in_small,in_large_only', [
    ('nsample', 16, 16), ('nsample_plus_1', 17, 16), ('empty', 0, 0)])
def test_b4_sa_group_ball_counts_match_pallas(case, in_small, in_large_only):
    """Ball counts of exactly nsample, nsample + 1 and 0 for both radii
    (16 and 32, 17 and 33, none), with b2 > 0 so that a slot wrongly filled
    with zeros, which pools relu(b2), would show. Points sit 0.4 m and 1.2 m
    from the centers, clear of the ball boundaries at 0.8 and 1.6 m."""
    rng = np.random.RandomState(5)
    r, p, g, h = 3, 64, 27, 64
    n_in = in_small + in_large_only
    xyz = np.full((r, p, 3), 100.0, np.float32)
    for i in range(r):
        v = rng.randn(n_in, 3)
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        v *= np.r_[np.full(in_small, 0.4), np.full(in_large_only, 1.2)][:, None]
        xyz[i, np.sort(rng.permutation(p)[:n_in])] = v[rng.permutation(n_in)]
    valid = np.ones((r, p), bool)
    centers = (rng.randn(r, g, 3) * 1e-3).astype(np.float32)
    centers[:, -6:] = -50.0                            # empty balls
    d2 = ((centers[:, :, None, :] - xyz[:, None, :, :]) ** 2).sum(-1)
    for rad, ns, want in zip(RADII, NSAMPLES, (in_small, n_in)):
        assert ((d2 < rad * rad).sum(-1)[:, :-6] == want).all()
        assert want in (0, ns, ns + 1)
    z = rng.randn(2, r, p, h).astype(np.float32)
    cw = rng.randn(2, r, g, h).astype(np.float32)
    w2 = (rng.randn(2, h, h) / 8).astype(np.float32)
    b1 = rng.randn(2, h).astype(np.float32) * 0.5
    b2 = (0.5 + rng.rand(2, h)).astype(np.float32)
    pad = 128 - h
    ref = jax_sa_fused(
        jnp.asarray(centers), jnp.asarray(xyz), jnp.asarray(valid),
        [jnp.pad(jnp.asarray(z[i]), ((0, 0), (0, 0), (0, pad))) for i in range(2)],
        [jnp.pad(jnp.asarray(cw[i]), ((0, 0), (0, 0), (0, pad))) for i in range(2)],
        [jnp.pad(jnp.asarray(w2[i]), ((0, pad), (0, pad))) for i in range(2)],
        [jnp.pad(jnp.asarray(b1[i]), (0, pad))[None] for i in range(2)],
        [jnp.pad(jnp.asarray(b2[i]), (0, pad))[None] for i in range(2)],
        RADII, NSAMPLES, interpret=True)
    got = sa_group_pool_plain(
        t(centers), t(xyz), t(valid), t(z).to(torch.bfloat16), t(cw),
        t(w2).to(torch.bfloat16), t(b1), t(b2), RADII, NSAMPLES)
    assert_bf16_close(got, ref)
    # the pooled value is not relu(b2) everywhere: the slots count
    assert (np.abs(got.float().numpy() - np.tile(b2.reshape(-1), (r, g, 1)))
            > 0.05).mean() > 0.5


def test_b4_sa_module_fused_path_matches_jax(monkeypatch):
    """The bf16 SA module: folded layer-1 precompute + plain B4 against the
    JAX module on its fused path (Pallas interpret mode)."""
    xyz, valid, feats, centers = _sa_data(1)
    jmod = jax_roi._SAModuleMSG(RADII, NSAMPLES, ((64, 64), (64, 64)),
                                compute_dtype=jnp.bfloat16)
    args = tuple(jnp.asarray(x) for x in (xyz, valid, feats, centers))
    variables = jmod.init(jax.random.PRNGKey(0), *args, train=False)
    monkeypatch.setattr(jax_roi, '_FUSED_SA_MODE', 'interpret')
    ref = jmod.apply(variables, *args, train=False)

    tmod = _SAModuleMSG(RADII, NSAMPLES, ((64, 64), (64, 64)), feats.shape[-1],
                        compute_dtype=torch.bfloat16).eval()
    load_flax_variables(tmod, jax.tree_util.tree_map(np.asarray,
                                                     dict(variables)))
    assert tmod.fused_ok()              # eval mode: training groups without B4
    got = tmod(t(xyz), t(valid), t(feats), t(centers))
    assert got.shape == ref.shape == (3, 27, 128)
    assert_bf16_close(got, ref)
