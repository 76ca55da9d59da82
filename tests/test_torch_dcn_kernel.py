"""The sample-and-MMA deformable conv forward (``fv2p_torch/ops/cuda/dcn.py``,
``ops/csrc/dcn.cu``) and the dispatch in ``ops/dcn.py`` that sends a no-grad
bf16 call on the card to it.

On the CPU: the plain version is the autograd path's forward
(``_mdcn_forward``) bit for bit, with offsets past every border and a mask
that is not uniform; the dispatch keeps CPU tensors, f32 and calls that
autograd records on ``_ModulatedDeformConvFn`` and sends a no-grad bf16 call
on the card to the wrapper; the wrapper's checks take every deformable conv
that a yaml under ``tools/cfgs/`` builds and refuse what the kernel does not
take.

On the card (``python -m pytest -o addopts='' --noconftest -m cuda
tests/test_torch_dcn_kernel.py``: the file imports no JAX): the kernel
against its plain version at MGAF-3DSSD's four test-batch calls with the
offsets at zero and the mask at 0.5 (the benchmark's weights), the same
shapes with drawn fractional offsets that reach past the borders and a
drawn mask, one-pixel-wide edge cases (batch 1, maps that are not a
multiple of the 128-pixel tile, a depth that is not a multiple of the
32-channel step, Waymo's 188 x 188 head map), and the launches of an eval
forward and a train step of MGAF-3DSSD.

Tolerance of the kernel against the plain version. Both blend the same
corners with the same bf16 weights and roundings, so the A operands agree
to the bit: with weights that select one (tap, channel) for each output
column, the outputs are the samples themselves and must be equal. Otherwise
both sum the same exact products (bf16 x bf16 in f32) in another order: per
tap C of them, then the 9 taps in order, so two orders differ by at most
~2 (C + 9) 2^-24 S, S the sum of |sample w| of the element. The test holds
every element to 2^-23 (K C) S, with K C the depth, plus one bf16 ulp
(2^-8) of the largest |x| times the largest |w|, which covers one sample
that rounds to its other neighbour.
"""
import copy
import types

import pytest
import torch

from fv2p_torch.models import build_network
from fv2p_torch.datasets import dataset_meta_from_cfg
from fv2p_torch.ops import cuda as kcuda
from fv2p_torch.ops import dcn
from fv2p_torch.ops.cuda import dcn as cd
from fv2p_torch.utils import tracing
from tests.test_torch_sparse_conv import (MGAF_YAML, REPO, build, cell_batch, deterministic,
                                          load_cfg, one_torch_thread)  # noqa: F401


def names_dcn(path):
    """Whether the yaml (with its base configs) names a deformable conv."""
    model = load_cfg(path).MODEL
    return any(model.get(slot, {}).get('USE_DCN') for slot in ('BACKBONE_2D', 'DENSE_HEAD'))


DCN_YAMLS = sorted((p for p in (REPO / 'tools/cfgs').glob('*_models/**/*.yaml')
                    if names_dcn(p)), key=lambda p: p.name)
# MGAF-3DSSD's four calls of a KITTI test batch: (B, H, W, C, Cout, G)
CELL_CALLS = {'deblock0': (4, 200, 176, 128, 128, 1), 'deblock1': (4, 100, 88, 256, 256, 1),
              'deblock2': (4, 50, 44, 256, 256, 1), 'head': (4, 200, 176, 256, 256, 4)}
EDGE_CALLS = {'one scan, odd map': (1, 37, 53, 64, 128, 2),
              'depth 40 in 8-wide groups': (1, 13, 29, 40, 256, 5),
              'one pixel': (1, 1, 1, 32, 128, 1),
              'waymo head': (1, 188, 188, 256, 256, 4)}


def operands(b, h, w, c, cout, g, seed, offsets='drawn', device='cpu'):
    """x, the offsets, the mask and the weights of one call. ``offsets``
    'zero': offsets 0 and mask 0.5 (the offset convs at zero, as the
    benchmark draws MGAF-3DSSD); 'drawn': fractional offsets of a few
    pixels, one in ten pushed past the map by up to its size, and a mask
    drawn in [0, 1]."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(b, h, w, c, generator=gen).to(torch.bfloat16)
    weight = (torch.randn(9, c, cout, generator=gen) / (9 * c) ** 0.5).to(torch.bfloat16)
    shape = (b, h, w, g * 9)
    if offsets == 'zero':
        dy, dx = torch.zeros(shape), torch.zeros(shape)
        mask = torch.full(shape, 0.5).to(torch.bfloat16)
    else:
        dy, dx = (torch.randn(shape, generator=gen) * 2.5 for _ in range(2))
        for o, n in ((dy, h), (dx, w)):
            far = torch.rand(shape, generator=gen) < 0.1
            o[far] += (torch.rand(shape, generator=gen)[far] * 2 - 1) * (n + 2)
        mask = torch.rand(shape, generator=gen).to(torch.bfloat16)
    return [t.to(device) for t in (x, dy, dx, mask, weight)]


# ---------------------------------------------------------------- CPU

@pytest.mark.parametrize('g,c,dtype', [(1, 16, torch.bfloat16), (4, 32, torch.bfloat16),
                                       (1, 16, torch.float32), (4, 32, torch.float32)])
def test_plain_version_is_the_autograd_forward(g, c, dtype):
    """Bit for bit, at 1 and 4 groups, bf16 and f32, with offsets that reach
    past every border and a mask that is not uniform."""
    x, dy, dx, mask, weight = operands(2, 9, 11, c, 24, g, seed=g * c)
    assert ((dy + torch.arange(9).view(1, 9, 1, 1)) < -1).any()
    assert ((dx + torch.arange(11).view(1, 1, 11, 1)) > 11).any()
    x, mask, weight = x.to(dtype), mask.to(dtype), weight.to(dtype)
    ref = dcn._mdcn_forward(x, dy, dx, mask, weight, 3, g)
    assert torch.equal(cd.mdcn_fwd_plain(x, dy, dx, mask, weight, g), ref)
    assert torch.equal(cd.mdcn_fwd(x, dy, dx, mask, weight, g), ref)


def test_plain_version_takes_views_and_f64():
    """The channel chunks of one offset map (as ``MdeformConvBlock`` makes
    them) and f64 operands, as the autograd path takes them."""
    x, dy, dx, mask, weight = operands(1, 6, 7, 16, 8, 2, seed=5)
    om = torch.cat([dy, dx, mask.float()], dim=-1).permute(0, 3, 1, 2).permute(0, 2, 3, 1)
    vy, vx, vm = torch.chunk(om, 3, dim=-1)
    assert not vy.is_contiguous()
    ref = dcn._mdcn_forward(x, vy, vx, vm.bfloat16(), weight, 3, 2)
    assert torch.equal(cd.mdcn_fwd_plain(x, vy, vx, vm.bfloat16(), weight, 2), ref)
    args = [t.double() for t in (x, dy, dx, mask, weight)]
    assert torch.equal(cd.mdcn_fwd_plain(*args, 2), dcn._mdcn_forward(*args, 3, 2))


REFUSED = {
    'f32 x': lambda x, dy, dx, m, w: (x.float(), dy, dx, m, w),
    'bf16 offsets': lambda x, dy, dx, m, w: (x, dy.bfloat16(), dx, m, w),
    'f32 mask': lambda x, dy, dx, m, w: (x, dy, dx, m.float(), w),
    'f32 weight': lambda x, dy, dx, m, w: (x, dy, dx, m, w.float()),
    'strided x': lambda x, dy, dx, m, w: (x.transpose(1, 2).contiguous().transpose(1, 2),
                                          dy, dx, m, w),
    'strided offsets': lambda x, dy, dx, m, w: (x, dy.transpose(1, 2).contiguous()
                                                .transpose(1, 2), dx, m, w),
    'offsets of another map': lambda x, dy, dx, m, w: (x, dy[:, :-1].contiguous(), dx, m, w),
    'mask of other taps': lambda x, dy, dx, m, w: (x, dy, dx, m[..., :-1].contiguous(), w),
    '5 x 5 kernel': lambda x, dy, dx, m, w: (x, dy, dx, m, torch.zeros(
        25, *w.shape[1:], dtype=w.dtype)),
    'weight of another depth': lambda x, dy, dx, m, w: (x, dy, dx, m, w[:, :8].contiguous()),
    'Cout 64': lambda x, dy, dx, m, w: (x, dy, dx, m, w[..., :64].contiguous()),
    'Cout 192': lambda x, dy, dx, m, w: (x, dy, dx, m, torch.cat([w, w[..., :64]], -1)),
    'Cout 384': lambda x, dy, dx, m, w: (x, dy, dx, m, torch.cat([w, w, w], -1)),
    'Cg 4': lambda x, dy, dx, m, w: (x[..., :16].contiguous(), dy, dx, m,
                                     w[:, :16].contiguous()),
    'flat x': lambda x, dy, dx, m, w: (x.reshape(-1, x.shape[-1]), dy, dx, m, w),
}


@pytest.mark.parametrize('case', sorted(REFUSED))
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    """``check_operands`` raises ValueError (at 4 groups of 8 channels, so a
    depth of 16 leaves groups of 4)."""
    ops = operands(1, 5, 6, 32, 128, 4, seed=3)
    cd.check_operands(*ops, 4)
    with pytest.raises(ValueError):
        cd.check_operands(*REFUSED[case](*ops), 4)


@pytest.mark.parametrize('groups', [3, 0, 2.0])
def test_wrapper_refuses_groups_that_do_not_divide_the_depth(groups):
    x, dy, dx, mask, weight = operands(1, 5, 6, 32, 128, 4, seed=4)
    with pytest.raises(ValueError):
        cd.check_operands(x, dy, dx, mask, weight, groups)


def test_cuda_entry_refuses_cpu_tensors_and_launches_nothing():
    """The kernel's entry point never falls back: a CPU tensor is an error
    there (only the dispatching ``mdcn_fwd`` takes the plain version), and
    nothing is counted."""
    kcuda.reset_launch_counts()
    with pytest.raises(ValueError, match='CUDA tensor'):
        cd.mdcn_fwd_cuda(*operands(1, 5, 6, 32, 128, 4, seed=2), 4)
    assert kcuda.launch_counts['dcn'] == 0


def dcn_blocks(path):
    """(K, C, Cout, G) of every deformable conv the yaml's network builds."""
    cfg = load_cfg(path)
    meta = dataset_meta_from_cfg(cfg.DATA_CONFIG, 'test')
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), cfg.CLASS_NAMES, meta,
                          compute_dtype=torch.bfloat16, device='cpu')
    return [(*m.kernel.shape, m.deformable_groups) for m in model.modules()
            if isinstance(m, dcn.MdeformConvBlock)]


@pytest.mark.parametrize('path', DCN_YAMLS, ids=lambda p: p.name)
def test_every_deformable_conv_of_the_zoo_fits_the_kernel(path):
    """Every yaml that names a deformable conv builds four, and the kernel
    takes each of them: the dispatch predicate holds for bf16 operands of
    their shapes on a card."""
    blocks = dcn_blocks(path)
    assert sorted(blocks) == [(9, 128, 128, 1), (9, 256, 256, 1), (9, 256, 256, 1),
                              (9, 256, 256, 4)]
    for k, c, cout, g in blocks:
        ops = operands(1, 4, 5, c, cout, g, seed=k)
        with torch.no_grad():
            assert dcn._kernel_takes(on_card(ops[0]), *ops[1:], 3, g)


def test_the_deformable_convs_are_mgaf_3dssd_s():
    """MGAF-3DSSD's yamls alone name one: KITTI (1 and 3 classes, two
    overfit yamls) and Waymo (e36 and its overfit yaml)."""
    assert [p.name for p in DCN_YAMLS] == [
        'mgaf-3dssd.yaml', 'mgaf-3dssd_3classes.yaml', 'mgaf-3dssd_overfit.yaml',
        'mgaf-3dssd_overfit_fullres.yaml', 'waymo_mgaf-3dssd_e36.yaml',
        'waymo_mgaf-3dssd_overfit.yaml']


def on_card(t):
    """An operand that says it lies on the card, for the dispatch predicate."""
    return types.SimpleNamespace(is_cuda=True, dtype=t.dtype, requires_grad=t.requires_grad,
                                 shape=t.shape, device=t.device, dim=t.dim)


@pytest.mark.parametrize('is_cuda,dtype,grad,x_rg,w_rg,ks,takes', [
    (True, torch.bfloat16, False, False, True, 3, True),     # eval: no_grad
    (True, torch.bfloat16, True, False, False, 3, True),     # nothing requires grad
    (True, torch.bfloat16, True, False, True, 3, False),     # training: the weights
    (True, torch.bfloat16, True, True, False, 3, False),     # a gradient to the map
    (True, torch.float32, False, False, True, 3, False),     # f32 (--dtype float32)
    (False, torch.bfloat16, False, False, True, 3, False),   # the CPU
    (True, torch.bfloat16, False, False, True, 2, False),    # a kernel_size the weights deny
])
def test_kernel_takes_only_no_grad_bf16_on_the_card(is_cuda, dtype, grad, x_rg, w_rg, ks,
                                                    takes):
    x, dy, dx, mask, weight = operands(1, 4, 5, 32, 128, 1, seed=6)
    x, mask, weight = x.to(dtype), mask.to(dtype), weight.to(dtype)
    x.requires_grad_(x_rg)
    weight.requires_grad_(w_rg)
    xs = on_card(x) if is_cuda else x
    with torch.set_grad_enabled(grad):
        assert dcn._kernel_takes(xs, dy, dx, mask, weight, ks, 1) is takes


@pytest.mark.parametrize('mode', ['no_grad', 'frozen', 'grad', 'f32', 'cpu'])
def test_dispatch(monkeypatch, mode):
    """With x taken for the card's (the real predicate on an operand that says
    it is on CUDA), a bf16 call that autograd does not record (under no_grad,
    or with the block frozen) goes to the wrapper (whose CPU branch is the
    plain version) inside one ``slot:dcn`` span and gives the autograd
    path's result bit for bit; a call that autograd records goes to
    ``_ModulatedDeformConvFn``, with the gradients of that function called
    directly, and so do a no-grad f32 call and a no-grad call on the CPU. No
    kernel is launched."""
    calls, fn_calls = [], []
    real_takes, real_fwd, real_fn = dcn._kernel_takes, dcn.mdcn_fwd, dcn._ModulatedDeformConvFn

    class RecordingFn(real_fn):
        @staticmethod
        def forward(ctx, *args):
            fn_calls.append(1)
            return real_fn.forward(ctx, *args)

    if mode != 'cpu':
        monkeypatch.setattr(dcn, '_kernel_takes',
                            lambda x, *rest: real_takes(on_card(x), *rest))
    monkeypatch.setattr(dcn, 'mdcn_fwd', lambda *a: calls.append(1) or real_fwd(*a))
    monkeypatch.setattr(dcn, '_ModulatedDeformConvFn', RecordingFn)
    dtype = torch.float32 if mode == 'f32' else torch.bfloat16
    block = dcn.MdeformConvBlock(32, 128, 3, deformable_groups=4, compute_dtype=dtype)
    x, dy, dx, mask, weight = operands(2, 6, 7, 32, 128, 4, seed=7)
    with torch.no_grad():
        block.kernel.copy_(weight.float())
        block.conv_offset_mask.weight.normal_(0.0, 0.05)
    if mode == 'frozen':
        block.requires_grad_(False)
    kcuda.reset_launch_counts()
    tracing.reset()
    tracing.enable()
    try:
        with torch.set_grad_enabled(mode in ('grad', 'frozen')):
            out = block(x.float())
        spans = tracing.snapshot()['spans']
    finally:
        tracing.disable()
        tracing.reset()
    to_kernel = mode in ('no_grad', 'frozen')
    assert (len(calls), len(fn_calls)) == ((1, 0) if to_kernel else (0, 1))
    assert spans['slot:dcn']['count'] == 1
    assert ('slot:dcn.sample' in spans) is not to_kernel
    assert kcuda.launch_counts['dcn'] == 0
    assert out.requires_grad is (mode == 'grad')

    # the same call through the autograd function itself
    om = block.conv_offset_mask(x.float().permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    vy, vx, vm = torch.chunk(om, 3, dim=-1)
    leaves = [x.to(dtype).requires_grad_(True), block.kernel.detach().to(dtype)
              .requires_grad_(True)]
    ref = real_fn.apply(leaves[0], vy, vx, torch.sigmoid(vm).to(dtype), leaves[1], 3, 4)
    assert torch.equal(out.detach(), ref.detach())
    if out.requires_grad:
        gout = torch.randn(out.shape, generator=torch.Generator().manual_seed(8))
        params = [block.kernel]
        got = torch.autograd.grad(out, params, gout)
        want = torch.autograd.grad(ref, [leaves[1]], gout)
        assert torch.equal(got[0], want[0].float())


# ---------------------------------------------------------------- card

def needs_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernel is built with nvcc')


def kernel_against_plain(ops, g, label):
    """The kernel against the plain version on the card, within the
    tolerance of the module docstring, the same on a second launch. Returns
    whether the two are equal to the bit."""
    got = cd.mdcn_fwd_cuda(*ops, g)
    ref = cd.mdcn_fwd_plain(*ops, g)
    assert torch.equal(cd.mdcn_fwd_cuda(*ops, g), got), label
    x, dy, dx, mask, weight = ops
    s = cd.mdcn_fwd_plain(x.abs(), dy, dx, mask, weight.abs(), g)
    depth = weight.shape[0] * weight.shape[1]
    ulp = 2.0 ** -8 * float(x.abs().max()) * float(weight.abs().max())
    err = (got - ref).abs()
    worst = float((err - (2.0 ** -23 * depth * s + ulp)).max())
    assert worst <= 0.0, (label, float(err.max()), worst)
    return torch.equal(got, ref)


def selector_weights(c, cout, g, seed):
    """(9, C, Cout) bf16 with one 1 a column: output column n is sample
    (tap, channel) of a drawn pair, every tap and every group among them."""
    gen = torch.Generator().manual_seed(seed)
    pick = torch.randint(0, 9 * c, (cout,), generator=gen)
    cg = c // g
    pick[:9 * g] = torch.tensor([t * c + j * cg + (t + j) % cg
                                 for t in range(9) for j in range(g)])
    w = torch.zeros(9 * c, cout)
    w[pick, torch.arange(cout)] = 1.0
    return w.view(9, c, cout).to(torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize('offsets', ['zero', 'drawn'])
def test_kernel_matches_plain_at_cell_shapes(offsets, capsys):
    """MGAF-3DSSD's four calls of a test batch: with the offsets at zero and
    the mask at 0.5, and with drawn offsets past the borders and a drawn
    mask; each with drawn weights (the tolerance) and with selector weights
    (the samples themselves, equal to the bit)."""
    needs_card()
    equal = 0
    for i, (name, (b, h, w, c, cout, g)) in enumerate(sorted(CELL_CALLS.items())):
        ops = operands(b, h, w, c, cout, g, seed=20 + i, offsets=offsets, device='cuda')
        equal += kernel_against_plain(ops, g, (offsets, name))
        ops[4] = selector_weights(c, cout, g, seed=30 + i).cuda()
        assert torch.equal(cd.mdcn_fwd_cuda(*ops, g), cd.mdcn_fwd_plain(*ops, g)), name
    with capsys.disabled():
        print(f'\n# dcn kernel, {offsets} offsets: {equal} of {len(CELL_CALLS)} calls '
              f'equal to the plain version to the bit')


@pytest.mark.cuda
@pytest.mark.parametrize('name', sorted(EDGE_CALLS))
def test_kernel_matches_plain_at_edges(name):
    """Batch 1, maps that are not a multiple of the tile, a depth that is
    not a multiple of the step (groups of 8 inside a step), one pixel, and
    Waymo's head map, at drawn offsets; drawn and selector weights."""
    needs_card()
    b, h, w, c, cout, g = EDGE_CALLS[name]
    ops = operands(b, h, w, c, cout, g, seed=40, device='cuda')
    kernel_against_plain(ops, g, name)
    ops[4] = selector_weights(c, cout, g, seed=41).cuda()
    assert torch.equal(cd.mdcn_fwd_cuda(*ops, g), cd.mdcn_fwd_plain(*ops, g)), name


def train_step_record(model, cfg, batch):
    """Loss terms and every gradient of one train step of ``model``, and the
    kernel's launches during it."""
    from fv2p_torch.train_utils.train_state import TrainStep
    step = TrainStep(model, cfg.OPTIMIZATION, 100)
    kcuda.reset_launch_counts()
    loss, terms, _ = step.forward_loss(dict(batch))
    step.backward(loss)
    torch.cuda.synchronize()
    launches = kcuda.launch_counts['dcn']
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    return {k: v.detach() for k, v in terms.items()}, grads, launches


@pytest.mark.cuda
def test_launches_in_eval_and_none_in_training(monkeypatch):
    """An eval forward of MGAF-3DSSD launches the kernel once for each of
    its four deformable convs; a train step launches it never, and its loss
    terms and gradients equal those of the step with the dispatch shut
    (every call on ``_ModulatedDeformConvFn``, the code before the kernel)
    bit for bit."""
    needs_card()
    from fv2p_torch.ops.sparse.host_rulebook import select_mode_caps
    from fv2p_torch.weights import calibrate_batchnorm_
    cfg = load_cfg(MGAF_YAML)
    model, meta = build(cfg, 'test', 'cuda')
    batch = cell_batch(meta, 2, 16000, 12000, seed=13, n_points=18000)
    calibrate_batchnorm_(model, batch)
    tracing.reset_counters('launches.')
    with torch.no_grad():
        model(dict(batch))
    torch.cuda.synchronize()
    assert kcuda.launch_counts['dcn'] == 4

    tmodel, tmeta = build(cfg, 'train', 'cuda')
    tmodel.train()
    caps = select_mode_caps(cfg.MODEL.BACKBONE_3D.get('LEVEL_CAPACITIES'), training=True)
    tbatch = cell_batch(tmeta, 2, 16000, 14000, seed=14, caps=caps, n_points=24000,
                        pad_points=True)
    shut = copy.deepcopy(tmodel)
    with deterministic():
        run = train_step_record(tmodel, cfg, tbatch)
        monkeypatch.setattr(dcn, '_kernel_takes', lambda *a: False)
        ref = train_step_record(shut, cfg, tbatch)
    assert run[2] == 0 and ref[2] == 0
    assert sorted(run[0]) == sorted(ref[0])
    assert all(torch.equal(run[0][k], ref[0][k]) for k in ref[0])
    assert sorted(run[1]) == sorted(ref[1])
    assert all(torch.equal(run[1][n], ref[1][n]) for n in ref[1])
