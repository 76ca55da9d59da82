"""The gather-MMA sparse conv forward (``fv2p_torch/ops/cuda/sparse_conv.py``,
``ops/csrc/sparse_conv.cu``) and the dispatch in ``ops/sparse/conv.py`` that
sends a no-grad bf16 conv on the card to it.

On the CPU: the wrapper's checks take every (K, Cin, Cout) that a voxel
yaml under ``tools/cfgs/`` builds (collected by building each network) and
refuse what the kernel does not take; the plain version is the autograd
path's forward, bias and mask, bit for bit; the dispatch sends a call that
autograd records to ``_SparseConvFn`` and a no-grad bf16 call on the card to
the wrapper.

On the card (``python -m pytest -o addopts='' --noconftest -m cuda
tests/test_torch_sparse_conv.py``: the file imports no JAX): the kernel
against its plain version at both inference cells' capacity shapes with
host and device tables, at every zoo shape on seeded tables with the edge
cases (a tile whose every tap is the zero row, a tap that is the zero row
for every row, N_out not a multiple of the 64-row tile), on UNetV2's
inverse convs (a strided layer's tables swapped); and the launches of an
eval forward and a train step of FV2P and MGAF-3DSSD.

Tolerance of the kernel against the plain version (both bf16 products, f32
sums, one rounding to bf16): the two sum the same exact products in another
order, so before rounding they differ by at most ~n 2^-24 S, S the sum of
|x w| of the element and n <= 27 * 128; each then rounds to bf16 once, which
may put them one bf16 ulp (<= 2^-7 |value|) apart. The test holds every
element to 2^-7 max(|kernel|, |plain|) + 2^-12 S. The epilogue (bias, mask)
is held exactly: it is the same f32 add and fill on the same values.
"""
import contextlib
import copy
import os
import types
from pathlib import Path

import pytest
import torch

from fv2p_torch.config import EasyDict, cfg_from_yaml_file
from fv2p_torch.datasets import dataset_meta_from_cfg
from fv2p_torch.models import build_network
from fv2p_torch.ops import cuda as kcuda
from fv2p_torch.ops.cuda import sparse_conv as sc
from fv2p_torch.ops.sparse import conv
from fv2p_torch.utils import tracing

REPO = Path(__file__).resolve().parent.parent
SPARSE_BACKBONES = ('VoxelResBackBone8x', 'VoxelBackBone8x', 'UNetV2')
FV2P_YAML = REPO / 'tools/cfgs/kitti_models/FV2P/fv2p.yaml'
MGAF_YAML = REPO / 'tools/cfgs/kitti_models/MGAF-3DSSD/mgaf-3dssd.yaml'
PARTA2_YAML = REPO / 'tools/cfgs/kitti_models/PartA2.yaml'
TRUNK_CONVS = 21    # VoxelResBackBone8x: conv_input, 8 residual blocks x 2, 4 strided


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """As ``tests/test_torch_model.py``'s fixture (this file imports no JAX,
    so it keeps its own copy): one intra-op thread under pytest-xdist."""
    if int(os.environ.get('PYTEST_XDIST_WORKER_COUNT', '1')) <= 1:
        yield
        return
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def load_cfg(path):
    cfg = EasyDict()
    cfg_from_yaml_file(str(path), cfg)
    return cfg


def build(cfg, mode, device, dtype=torch.bfloat16, seed=0):
    from fv2p_torch.weights import init_random_
    meta = dataset_meta_from_cfg(cfg.DATA_CONFIG, mode)
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), cfg.CLASS_NAMES, meta,
                          compute_dtype=dtype, device=device)
    init_random_(model, seed=seed)
    return model, meta


@pytest.fixture(scope='module')
def zoo_shapes():
    """{(K, Cin, Cout): [yaml, ...]} over every yaml under tools/cfgs/ whose
    detector has a sparse backbone, from the networks it builds."""
    shapes = {}
    for path in sorted((REPO / 'tools/cfgs').glob('*_models/**/*.yaml')):
        cfg = load_cfg(path)
        if cfg.MODEL.get('BACKBONE_3D', {}).get('NAME') not in SPARSE_BACKBONES:
            continue
        meta = dataset_meta_from_cfg(cfg.DATA_CONFIG, 'test')
        model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), cfg.CLASS_NAMES, meta,
                              compute_dtype=torch.bfloat16, device='cpu')
        for m in model.modules():
            if isinstance(m, conv._SparseConvBase):
                shapes.setdefault(tuple(m.kernel.shape), []).append(path.name)
    return shapes


def seeded_case(k, cin, cout, n_in, n_out, seed, device='cpu'):
    """bf16 features and weight, a table with about half its entries at the
    zero row, rows 64-127 all zero row (a whole tile), tap k // 2 zero row
    for every row; an f32 bias and a valid mask with every fifth row off."""
    g = torch.Generator().manual_seed(seed)
    feats = torch.randn(n_in, cin, generator=g).to(torch.bfloat16)
    weight = (torch.randn(k, cin, cout, generator=g) / (k * cin) ** 0.5).to(torch.bfloat16)
    nbr = torch.randint(0, n_in, (n_out, k), generator=g)
    nbr[torch.rand(n_out, k, generator=g) < 0.5] = n_in
    nbr[64:128] = n_in
    nbr[:, k // 2] = n_in
    bias = torch.randn(cout, generator=g)
    valid = torch.arange(n_out) % 5 != 0
    return [t.to(device) for t in (feats, weight, nbr, bias, valid)]


# ---------------------------------------------------------------- CPU

def test_zoo_builds_the_shapes_the_kernel_takes(zoo_shapes):
    """Every (K, Cin, Cout) of the voxel yamls passes the wrapper's checks
    (``check_operands``) and lies in the kernel's range."""
    assert {k for k, _, _ in zoo_shapes} == {3, 27}
    assert {cin for _, cin, _ in zoo_shapes} >= {4, 5, 16, 32, 64, 128}
    for k, cin, cout in zoo_shapes:
        f, w, nbr, bias, valid = seeded_case(k, cin, cout, 200, 150, 0)
        sc.check_operands(f, w, nbr, bias, valid)
        sc.check_operands(f, w, nbr)


REFUSED = {
    'f32 features': lambda f, w, n, b, v: (f.float(), w, n, b, v),
    'f32 weight': lambda f, w, n, b, v: (f, w.float(), n, b, v),
    'int32 table': lambda f, w, n, b, v: (f, w, n.int(), b, v),
    'bf16 bias': lambda f, w, n, b, v: (f, w, n, b.bfloat16(), v),
    'uint8 mask': lambda f, w, n, b, v: (f, w, n, b, v.to(torch.uint8)),
    'strided features': lambda f, w, n, b, v: (f.t().contiguous().t(), w, n, b, v),
    'table of other taps': lambda f, w, n, b, v: (f, w, n[:, :5], b, v),
    'features of other depth': lambda f, w, n, b, v: (f[:, :8].contiguous(), w, n, b, v),
    'short bias': lambda f, w, n, b, v: (f, w, n, b[:8], v),
    'short mask': lambda f, w, n, b, v: (f, w, n, b, v[:10]),
    'Cout 48': lambda f, w, n, b, v: (f, w[..., :48].contiguous(), n, b[:48], v),
    'Cin 129': lambda f, w, n, b, v: (
        torch.zeros(f.shape[0], 129, dtype=f.dtype),
        torch.zeros(w.shape[0], 129, w.shape[2], dtype=w.dtype), n, b, v),
    'K 33': lambda f, w, n, b, v: (
        f, torch.zeros(33, *w.shape[1:], dtype=w.dtype),
        torch.zeros(n.shape[0], 33, dtype=n.dtype), b, v),
    'flat table': lambda f, w, n, b, v: (f, w, n.reshape(-1), b, v),
}


@pytest.mark.parametrize('case', sorted(REFUSED))
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    ops = REFUSED[case](*seeded_case(27, 16, 64, 100, 80, 1))
    with pytest.raises(ValueError):
        sc.check_operands(*ops)


def test_cuda_entry_refuses_cpu_tensors_and_launches_nothing():
    """The kernel's entry point never falls back: a CPU tensor is an error
    there (only the dispatching ``sparse_conv_fwd`` takes the plain
    version), and nothing is counted."""
    kcuda.reset_launch_counts()
    with pytest.raises(ValueError, match='CUDA tensor'):
        sc.sparse_conv_fwd_cuda(*seeded_case(27, 16, 32, 100, 80, 2))
    assert kcuda.launch_counts['sparse_conv'] == 0


@pytest.mark.parametrize('k,cin,cout', [(27, 4, 16), (27, 5, 16), (27, 16, 32),
                                        (27, 128, 64), (3, 128, 128)])
def test_plain_version_is_the_autograd_path(k, cin, cout):
    """The plain version is ``_SparseConvFn``'s forward, the bias and the
    mask of ``_apply_conv``, bit for bit, with and without the epilogue."""
    f, w, nbr, bias, valid = seeded_case(k, cin, cout, 300, 200, k + cin)
    ref = conv._SparseConvFn.apply(f, w, nbr, None)
    assert torch.equal(sc.sparse_conv_fwd_plain(f, w, nbr), ref)
    assert torch.equal(sc.sparse_conv_fwd(f, w, nbr, bias, valid),
                       (ref + bias).masked_fill(~valid[:, None], 0.0))
    assert torch.equal(sc.sparse_conv_fwd_plain(f, w, nbr)[64:128], torch.zeros(64, cout))


def _operand(is_cuda, dtype, requires_grad):
    return types.SimpleNamespace(is_cuda=is_cuda, dtype=dtype, requires_grad=requires_grad)


@pytest.mark.parametrize('is_cuda,dtype,grad,feat_rg,weight_rg,takes', [
    (True, torch.bfloat16, False, False, True, True),      # eval: no_grad
    (True, torch.bfloat16, True, False, False, True),      # nothing requires grad
    (True, torch.bfloat16, True, False, True, False),      # training: the weights
    (True, torch.bfloat16, True, True, False, False),      # a gradient to the input
    (True, torch.float32, False, False, True, False),      # f32 (--dtype float32)
    (False, torch.bfloat16, False, False, True, False),    # the CPU
])
def test_kernel_takes_only_no_grad_bf16_on_the_card(is_cuda, dtype, grad, feat_rg,
                                                    weight_rg, takes):
    with torch.set_grad_enabled(grad):
        assert conv._kernel_takes(_operand(is_cuda, dtype, feat_rg),
                                  _operand(is_cuda, dtype, weight_rg)) is takes


@pytest.mark.parametrize('mode', ['no_grad', 'grad', 'frozen', 'f32'])
def test_apply_conv_dispatch(monkeypatch, mode):
    """With the features taken for the card's (the real predicate on an
    operand that says it is on CUDA), a no-grad bf16 conv goes to the
    wrapper (whose CPU branch is the plain version) and gives the autograd
    path's result bit for bit; a conv that autograd records goes to
    ``_SparseConvFn``, and so does an f32 one."""
    calls, fn_calls = [], []
    real_takes, real_fwd, real_fn = conv._kernel_takes, conv.sparse_conv_fwd, conv._SparseConvFn

    def on_card(f):
        return _operand(True, f.dtype, f.requires_grad)

    class RecordingFn(real_fn):
        @staticmethod
        def forward(ctx, *args):
            fn_calls.append(1)
            return real_fn.forward(ctx, *args)

    monkeypatch.setattr(conv, '_kernel_takes', lambda f, w: real_takes(on_card(f), w))
    monkeypatch.setattr(conv, 'sparse_conv_fwd',
                        lambda *a: calls.append(1) or real_fwd(*a))
    monkeypatch.setattr(conv, '_SparseConvFn', RecordingFn)
    dtype = torch.float32 if mode == 'f32' else torch.bfloat16
    layer = conv.SubMConv3d(16, 32, 3, use_bias=True, compute_dtype=dtype)
    f, w, nbr, bias, valid = seeded_case(27, 16, 32, 150, 150, 3)
    with torch.no_grad():
        layer.kernel.copy_(w.float())
        layer.bias.copy_(bias)
    if mode == 'frozen':
        layer.requires_grad_(False)
    st = types.SimpleNamespace(features=f.float(), valid_mask=lambda: valid,
                               replace=lambda features: features)
    with torch.set_grad_enabled(mode != 'no_grad'):
        out = layer(st, nbr)
    to_kernel = mode in ('no_grad', 'frozen')
    assert (len(calls), len(fn_calls)) == ((1, 0) if to_kernel else (0, 1))
    assert out.requires_grad is (mode in ('grad', 'f32'))
    ref = real_fn.apply(f.to(dtype), w.to(dtype), nbr, None)
    assert torch.equal(out.detach(), (ref + bias).masked_fill(~valid[:, None], 0.0))


def test_cpu_eval_forward_keeps_the_autograd_path(monkeypatch):
    """On the CPU a no-grad bf16 conv still takes ``_SparseConvFn`` (the
    kernel is the card's), so the CPU's spans and numbers do not move."""
    calls = []
    real_fwd = conv.sparse_conv_fwd
    monkeypatch.setattr(conv, 'sparse_conv_fwd', lambda *a: calls.append(1) or real_fwd(*a))
    layer = conv.SubMConv3d(16, 16, 3, compute_dtype=torch.bfloat16)
    f, _, nbr, _, valid = seeded_case(27, 16, 16, 90, 90, 4)
    st = types.SimpleNamespace(features=f, valid_mask=lambda: valid,
                               replace=lambda features: features)
    with torch.no_grad():
        layer(st, nbr)
    assert not calls


# ---------------------------------------------------------------- card

def needs_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernel is built with nvcc')


def assert_kernel_matches_plain(f, w, nbr, bias=None, valid=None, label=''):
    """The kernel against the plain version on the card, within the
    tolerance of the module docstring, the epilogue exact, the result the
    same on a second launch."""
    got = sc.sparse_conv_fwd_cuda(f, w, nbr)
    ref = sc.sparse_conv_fwd_plain(f, w, nbr)
    assert torch.equal(sc.sparse_conv_fwd_cuda(f, w, nbr), got), label
    s = sc.sparse_conv_fwd_plain(f.abs().float(), w.abs().float(), nbr)
    err = (got - ref).abs()
    tol = 2.0 ** -7 * torch.maximum(got.abs(), ref.abs()) + 2.0 ** -12 * s
    worst = float((err - tol).max()) if err.numel() else 0.0
    assert worst <= 0.0, (label, float(err.max()), worst)
    empty = (nbr == f.shape[0]).all(dim=1)
    assert torch.equal(got[empty], torch.zeros_like(got[empty])), label
    if bias is not None or valid is not None:
        full = sc.sparse_conv_fwd_cuda(f, w, nbr, bias, valid)
        want = got if bias is None else got + bias
        if valid is not None:
            want = want.masked_fill(~valid[:, None], 0.0)
        assert torch.equal(full, want), label


@contextlib.contextmanager
def captured_calls():
    """Every call the dispatch sends to the wrapper, with its operands."""
    calls = []
    real = conv.sparse_conv_fwd

    def record(*args):
        calls.append(args)
        return real(*args)

    conv.sparse_conv_fwd = record
    try:
        yield calls
    finally:
        conv.sparse_conv_fwd = real


def cell_batch(meta, batch, n_cap, fill, seed, caps=None, n_points=512, pad_points=False):
    """A batch of ray-cast scans on the card with host rulebooks (the
    level caps derived from ``n_cap`` unless ``caps``) and each scan's six
    cars as gt."""
    from fv2p_torch.utils.synthetic import batch_to_torch, synthetic_batch_np
    b = synthetic_batch_np(meta, batch, n_cap, fill, n_points, seed=seed, gt='scan',
                           pad_points=pad_points, caps_override=caps)
    return batch_to_torch(b, 'cuda')


def trunk_calls(model, batch):
    """The sparse trunk of an eval forward (VFE and backbone_3d), its convs'
    calls to the wrapper captured."""
    bd = dict(batch)
    with torch.no_grad(), captured_calls() as calls:
        bd = model.vfe(bd)
        model.backbone_3d(bd)
    torch.cuda.synchronize()
    return calls


@pytest.mark.cuda
@pytest.mark.parametrize('yaml', [FV2P_YAML, MGAF_YAML], ids=['fv2p', 'mgaf'])
@pytest.mark.parametrize('tables', ['host', 'device'])
def test_kernel_matches_plain_at_cell_shapes(yaml, tables):
    """Both inference cells' trunk at their traffic's shape (batch 4, the
    40000-voxel test cap with 14000 voxels a scan, derived level caps), its
    21 calls held to the plain version, with the host rulebooks and with the
    tables the backbone builds on the card."""
    needs_card()
    cfg = load_cfg(yaml)
    model, meta = build(cfg, 'test', 'cuda')
    batch = cell_batch(meta, 4, 40000, 14000, seed=11)
    if tables == 'device':
        batch = {k: v for k, v in batch.items() if k != 'rulebooks'}
    calls = trunk_calls(model, batch)
    assert len(calls) == TRUNK_CONVS
    rows = [c[2].shape[0] for c in calls]
    if tables == 'host':
        assert rows[0] == 160000 and max(rows) > 160000, rows
    for i, (f, w, nbr, bias, valid) in enumerate(calls):
        assert_kernel_matches_plain(f, w, nbr, bias, valid, label=f'{tables} conv {i}')


@pytest.mark.cuda
def test_kernel_matches_plain_at_every_zoo_shape(zoo_shapes):
    """Every (K, Cin, Cout) of the voxel yamls on seeded tables: a whole
    tile of zero rows, a tap that is the zero row for every row, and N_out
    (64 x 5 + 17) not a multiple of the tile."""
    needs_card()
    for (k, cin, cout), yamls in sorted(zoo_shapes.items()):
        f, w, nbr, bias, valid = seeded_case(k, cin, cout, 1000, 64 * 5 + 17,
                                             k * cin + cout, device='cuda')
        assert_kernel_matches_plain(f, w, nbr, bias, valid, label=(k, cin, cout, yamls[0]))
        assert_kernel_matches_plain(f, w, nbr, label=(k, cin, cout))
    # one row, a table entirely of the zero row, and no rows at all
    f, w, nbr, bias, valid = seeded_case(27, 16, 16, 50, 1, 5, device='cuda')
    assert_kernel_matches_plain(f, w, nbr, bias, valid, label='one row')
    nbr = torch.full((200, 27), 50, dtype=torch.int64, device='cuda')
    assert_kernel_matches_plain(f, w, nbr, label='all zero row')
    assert sc.sparse_conv_fwd_cuda(f, w, nbr[:0]).shape == (0, 16)


@pytest.mark.cuda
def test_kernel_matches_plain_on_inverse_conv_tables():
    """PartA2's UNetV2 in eval on tables built on the card: its decoder's
    inverse convs gather through a strided layer's inverse table (the two
    tables swapped) and its conv_m layers take Cin 128."""
    needs_card()
    cfg = load_cfg(PARTA2_YAML)
    model, meta = build(cfg, 'test', 'cuda')
    batch = cell_batch(meta, 2, 16000, 12000, seed=12)
    batch = {k: v for k, v in batch.items() if k != 'rulebooks'}
    calls = trunk_calls(model, batch)
    inverse = [m for m in model.backbone_3d.modules()
               if isinstance(m, conv.SparseInverseConv3d)]
    n_convs = sum(isinstance(m, conv._SparseConvBase) for m in model.backbone_3d.modules())
    assert len(inverse) == 3 and len(calls) == n_convs
    assert any(w.shape[1] == 128 for _, w, _, _, _ in calls)
    for i, (f, w, nbr, bias, valid) in enumerate(calls):
        assert_kernel_matches_plain(f, w, nbr, bias, valid, label=f'unet conv {i}')


@contextlib.contextmanager
def deterministic():
    """Deterministic algorithms (a warning where an operation has none), the
    defaults restored after: two runs of one step then agree to the bit."""
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])


def train_step_record(model, cfg, batch):
    """Loss terms, the forward's point features and every gradient of one
    train step of ``model``, and the wrapper's launches during it."""
    from fv2p_torch.train_utils.train_state import TrainStep
    step = TrainStep(model, cfg.OPTIMIZATION, 100)
    kcuda.reset_launch_counts()
    loss, terms, out = step.forward_loss(dict(batch))
    step.backward(loss)
    torch.cuda.synchronize()
    launches = kcuda.launch_counts['sparse_conv']
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    feats = out['encoded_spconv_tensor'].features.detach().clone()
    return {k: v.detach() for k, v in terms.items()}, feats, grads, launches


@pytest.mark.cuda
@pytest.mark.parametrize('yaml', [FV2P_YAML, MGAF_YAML], ids=['fv2p', 'mgaf'])
def test_launches_in_eval_and_none_in_training(yaml, monkeypatch):
    """An eval forward of the full model launches the kernel once for each
    of the trunk's 21 convs; a train step launches it never, and its loss
    terms, trunk output and gradients equal those of the step with the
    dispatch shut (every conv on ``_SparseConvFn``, the code before the
    kernel) bit for bit."""
    needs_card()
    cfg = load_cfg(yaml)
    model, meta = build(cfg, 'test', 'cuda')
    batch = cell_batch(meta, 2, 16000, 12000, seed=13, n_points=18000)
    if yaml == MGAF_YAML:       # else no heat-map logit clears the threshold
        from fv2p_torch.weights import calibrate_batchnorm_
        calibrate_batchnorm_(model, batch)
    tracing.reset_counters('launches.')
    with torch.no_grad():
        model(dict(batch))
    torch.cuda.synchronize()
    assert kcuda.launch_counts['sparse_conv'] == TRUNK_CONVS

    from fv2p_torch.ops.sparse.host_rulebook import select_mode_caps
    tmodel, tmeta = build(cfg, 'train', 'cuda')
    tmodel.train()
    caps = select_mode_caps(cfg.MODEL.BACKBONE_3D.get('LEVEL_CAPACITIES'), training=True)
    tbatch = cell_batch(tmeta, 2, 16000, 14000, seed=14, caps=caps, n_points=24000,
                        pad_points=True)
    shut = copy.deepcopy(tmodel)
    with deterministic():
        run = train_step_record(tmodel, cfg, tbatch)
        monkeypatch.setattr(conv, '_kernel_takes', lambda f, w: False)
        ref = train_step_record(shut, cfg, tbatch)
    assert run[3] == 0 and ref[3] == 0
    assert sorted(run[0]) == sorted(ref[0])
    assert all(torch.equal(run[0][k], ref[0][k]) for k in ref[0])
    assert torch.equal(run[1], ref[1])
    assert sorted(run[2]) == sorted(ref[2])
    assert all(torch.equal(run[2][n], ref[2][n]) for n in ref[2])
