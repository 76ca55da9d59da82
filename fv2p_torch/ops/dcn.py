"""Modulated deformable convolution v2 (counterpart of
``fv2p_tpu/ops/dcn.py``): ``modulated_deform_conv``, ``MdeformConvBlock``
and ``FeatureAdaption``, with the backward of JAX's ``_mdcn_all_taps``
custom VJP.

JAX runs this as XLA, not as a Pallas kernel, so it is tensor code here: per
kernel tap, the four bilinear corners of every sample are gathered from the
zero-padded map, blended with the modulation folded into their weights, and
the tap's product with the weights is added into an f32 accumulator. The
quad-row layout and the checkpointed scan of the JAX version are TPU layout
tricks; their semantics are kept:

* offsets and mask arrive as three (B, H, W, G*K) maps, each read as
  (B, HW, G, K) (group-major); taps run ky-major; the weight (K, C, Cout)
  reads C as (G, Cg);
* sample coordinates are f32 whatever the compute type (f64 only for f64
  offsets, which a gradient check takes): ``(base + tap) + offset``;
* a sample counts only if floor(y) is in [-1, H-1] and floor(x) in
  [-1, W-1]; corners outside the map read zero, and so does every corner of
  a sample that does not count;
* the modulation is folded into the four bilinear weights, which are cast
  to the compute type before the blend; the products accumulate in f32 and
  the output is f32.

Memory: besides every tap's corner indices and weights (4 x K x B x HW x G
of each), one tap's gathered corners and the (B*HW, Cout) f32 accumulator
are live at a time, never the whole (B, HW, K, C) sample matrix.

Backward (``_mdcn_backward``): the forward saves its inputs only; the
backward recomputes one tap at a time and follows JAX's formulas: the
samples' gradient dout @ W_k^T and the weights' samples^T @ dout in f32,
the offsets' and the mask's from the row-wise dots of that gradient with
the four corners, and x's from one f32 scatter-add (``index_add_``) of the
four weighted gradient rows into the padded source, whose border and
sentinel row are then dropped.
"""
import torch
import torch.nn.functional as F
from torch import nn

from ..models.layers import Conv2d
from ..utils import tracing


def _accumulate(acc, a, b):
    """acc += a @ b with f32 sums and an f32 result (JAX's
    ``preferred_element_type=float32``): cuBLAS returns f32 from bf16
    operands; elsewhere the operands are widened, which keeps their products
    exact."""
    if a.is_cuda and a.dtype != acc.dtype:
        return torch.addmm(acc, a, b, out_dtype=torch.float32)
    return acc.addmm_(a.to(acc.dtype), b.to(acc.dtype))


def _bilinear_taps(offset_dy, offset_dx, mask, b, h, w, g, ks, dtype,
                   taps=slice(None), fractions=False):
    """The four corner rows (4 x (T, B, HW, G) indices into the padded
    source of ``modulated_deform_conv``) and bilinear weights, with the
    modulation folded in and cast to ``dtype``, of the taps ``taps`` (T of
    them). With ``fractions`` also (wy1, wx1, modulation) in the coordinate
    type, which the backward needs. The coordinates are f32 (f64 for f64
    offsets) and are freed here."""
    hw, k, pad, dev = h * w, ks * ks, (ks - 1) // 2, offset_dy.device
    cdt = torch.promote_types(offset_dy.dtype, torch.float32)
    ky, kx = torch.meshgrid(torch.arange(ks, device=dev),
                            torch.arange(ks, device=dev), indexing='ij')
    tap_y = (ky.reshape(-1).to(cdt) - pad)[taps]               # (T,)
    tap_x = (kx.reshape(-1).to(cdt) - pad)[taps]
    base_y = torch.arange(h, device=dev, dtype=cdt).repeat_interleave(w)
    base_x = torch.arange(w, device=dev, dtype=cdt).repeat(h)

    def taps_first(v):                         # (B, H, W, G*K) -> (T, B, HW, G)
        v = v.to(cdt).reshape(b, hw, g, k)[..., taps]
        return v.permute(3, 0, 1, 2).contiguous()

    # rows of the source: the map zero-padded by one cell on each side, one
    # row per (sample, cell, group), then the all-zero sentinel row; int32
    # row numbers where they fit halve the largest tensors here
    hp, wp = h + 2, w + 2
    sentinel = b * hp * wp * g
    idx = torch.int32 if sentinel < 2 ** 31 else torch.int64

    sy = (base_y[:, None] + tap_y[:, None, None, None]) + taps_first(offset_dy)
    sx = (base_x[:, None] + tap_x[:, None, None, None]) + taps_first(offset_dx)
    y0, x0 = torch.floor(sy), torch.floor(sx)
    wy1, wx1 = sy - y0, sx - x0
    del sy, sx
    y0i, x0i = y0.to(idx), x0.to(idx)
    ok = (y0i >= -1) & (y0i <= h - 1) & (x0i >= -1) & (x0i <= w - 1)
    bi = torch.arange(b, device=dev, dtype=idx).view(b, 1, 1)
    r00 = ((bi * hp + y0i + 1) * wp + x0i + 1) * g + torch.arange(g, device=dev, dtype=idx)
    rows = [torch.where(ok, r00 + step, sentinel)
            for step in (0, g, wp * g, wp * g + g)]            # 00 01 10 11

    modf = taps_first(mask)
    wts = [((1 - wy1) * (1 - wx1) * modf), ((1 - wy1) * wx1 * modf),
           (wy1 * (1 - wx1) * modf), (wy1 * wx1 * modf)]
    wts = [wt.to(dtype) for wt in wts]
    if fractions:
        return rows, wts, (wy1, wx1, modf)
    return rows, wts


def _padded_source(x, cg):
    """x (B, H, W, C) zero-padded by one cell on each side, as rows of Cg
    (one per sample, cell and group), then the all-zero sentinel row."""
    src = F.pad(x, (0, 0, 1, 1, 1, 1)).reshape(-1, cg)
    return torch.cat([src, src.new_zeros((1, cg))])


def _mdcn_forward(x, offset_dy, offset_dx, mask, weights, kernel_size, groups):
    b, h, w, c = x.shape
    g, k = groups, kernel_size * kernel_size
    cg, hw, cout = c // g, h * w, weights.shape[-1]
    with tracing.span('slot:dcn.sample'):
        rows, wts = _bilinear_taps(offset_dy, offset_dx, mask, b, h, w, g,
                                   kernel_size, x.dtype)
        src = _padded_source(x, cg)
    w_k = weights.reshape(k, c, cout)
    acc_dt = torch.promote_types(x.dtype, torch.float32)
    acc = torch.zeros((b * hw, cout), dtype=acc_dt, device=x.device)
    for t in range(k):
        with tracing.span('slot:dcn.sample'):
            samples = _sample_tap(src, rows, wts, t).view(b * hw, c)
        acc = _accumulate(acc, samples, w_k[t])
    return acc.view(b, h, w, cout)


def _mdcn_backward(x, offset_dy, offset_dx, mask, weights, dout, kernel_size,
                   groups):
    """Gradients of ``modulated_deform_conv`` with respect to x, the two
    offsets, the mask and the weights, tap by tap: each tap's corner rows
    and weights are recomputed, its samples' gradient is dout @ W_k^T, the
    weights' dW_k = samples^T @ dout, the offsets' and the mask's come from
    the row-wise dots of that gradient with the four corners, and the
    source's from one scatter-add of the four weighted gradient rows into
    the padded source (whose border and sentinel row are dropped at the
    end: a corner outside the map or a sample that does not count adds
    nothing). Every sum is f32 (f64 for f64 inputs), whatever the compute
    type; d(x), d(mask) and d(W) come back in the types of x, the mask and
    the weights, the offsets' in the coordinate type."""
    b, h, w, c = x.shape
    g, k = groups, kernel_size * kernel_size
    cg, hw, cout = c // g, h * w, weights.shape[-1]
    acc_dt = torch.promote_types(x.dtype, torch.float32)
    src = _padded_source(x, cg)
    dsrc = torch.zeros(src.shape, dtype=acc_dt, device=x.device)
    dout = dout.reshape(b * hw, cout).to(acc_dt)
    w_k = weights.reshape(k, c, cout)
    dw = torch.empty((k, c, cout), dtype=acc_dt, device=x.device)
    d_off = torch.empty((3, b, hw, g, k), dtype=acc_dt, device=x.device)
    for t in range(k):
        rows, wts, (wy1, wx1, modf) = _bilinear_taps(
            offset_dy, offset_dx, mask, b, h, w, g, kernel_size, x.dtype,
            taps=slice(t, t + 1), fractions=True)
        rows = [r[0] for r in rows]
        wts = [wt[0] for wt in wts]
        wy1, wx1, modf = wy1[0], wx1[0], modf[0]
        dsamp = torch.mm(dout, w_k[t].to(acc_dt).t()).view(b, hw, g, cg)
        sampled, dots = None, []
        for r, wt in zip(rows, wts):
            v = src.index_select(0, r.view(-1)).view(b, hw, g, cg)
            wv = wt[..., None]
            sampled = v * wv if sampled is None else sampled.addcmul_(v, wv)
            dots.append((dsamp * v.to(acc_dt)).sum(-1))
        d00, d01, d10, d11 = dots
        torch.mm(sampled.view(b * hw, c).to(acc_dt).t(), dout, out=dw[t])
        d_off[0, ..., t] = modf * (-(1 - wx1) * d00 - wx1 * d01
                                   + (1 - wx1) * d10 + wx1 * d11)
        d_off[1, ..., t] = modf * (-(1 - wy1) * d00 + (1 - wy1) * d01
                                   - wy1 * d10 + wy1 * d11)
        d_off[2, ..., t] = ((1 - wy1) * (1 - wx1) * d00 + (1 - wy1) * wx1 * d01
                            + wy1 * (1 - wx1) * d10 + wy1 * wx1 * d11)
        upd = torch.cat([dsamp * wt.to(acc_dt)[..., None] for wt in wts])
        dsrc.index_add_(0, torch.cat([r.reshape(-1) for r in rows]),
                        upd.view(-1, cg))
        del dsamp, sampled, dots, upd      # one tap's temporaries live at a time
    dx = dsrc[:-1].view(b, h + 2, w + 2, c)[:, 1:-1, 1:-1].to(x.dtype)
    d_off = d_off.view(3, b, h, w, g * k)
    cdt = torch.promote_types(offset_dy.dtype, torch.float32)
    return (dx, d_off[0].to(cdt), d_off[1].to(cdt), d_off[2].to(mask.dtype),
            dw.to(weights.dtype))


class _ModulatedDeformConvFn(torch.autograd.Function):
    """``modulated_deform_conv`` with its own backward: the forward saves
    its inputs only, not the sampled taps, and the backward recomputes one
    tap at a time, so its live memory is one tap's temporaries and the
    source's gradient."""

    @staticmethod
    def forward(ctx, x, offset_dy, offset_dx, mask, weights, kernel_size, groups):
        ctx.save_for_backward(x, offset_dy, offset_dx, mask, weights)
        ctx.kernel_size, ctx.groups = kernel_size, groups
        with tracing.span('slot:dcn'):
            return _mdcn_forward(x, offset_dy, offset_dx, mask, weights,
                                 kernel_size, groups)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        with tracing.span('phase:dcn.backward'):
            grads = _mdcn_backward(*ctx.saved_tensors, dout, ctx.kernel_size,
                                   ctx.groups)
        return grads + (None, None)


def modulated_deform_conv(x, offset_dy, offset_dx, mask, weights,
                          kernel_size=3, deformable_groups=1):
    """Args:
        x: (B, H, W, C) input features, in the compute type.
        offset_dy/offset_dx: (B, H, W, G*K) learned offsets (pixels).
        mask: (B, H, W, G*K) modulation in [0, 1] (already sigmoided).
        weights: (K, C, Cout), in the compute type.
    Returns: (B, H, W, Cout) float32 (float64 for f64 inputs).
    Differentiable in all five tensors (``_ModulatedDeformConvFn``).
    """
    return _ModulatedDeformConvFn.apply(x, offset_dy, offset_dx, mask, weights,
                                        kernel_size, deformable_groups)


def _sample_tap(src, rows, wts, t):
    """Tap t's samples (B, HW, G, Cg): the four corners blended, in the
    source's type, in the order v00 w00 + v01 w01 + v10 w10 + v11 w11."""
    sampled = None
    for r, wt in zip(rows, wts):
        v = src.index_select(0, r[t].view(-1)).view(*r.shape[1:], src.shape[1])
        wv = wt[t, ..., None]
        sampled = v * wv if sampled is None else sampled.addcmul_(v, wv)
    return sampled


class MdeformConvBlock(nn.Module):
    """Offset/mask conv + modulated deform conv, no activation, on
    (B, H, W, C) maps. The offset conv computes in f32 (its input's type, as
    flax infers it); the deformable conv in ``compute_dtype``."""

    def __init__(self, in_channels, out_channels, kernel_size=3,
                 deformable_groups=1, compute_dtype=None):
        super().__init__()
        k = kernel_size * kernel_size
        self.kernel_size, self.deformable_groups = kernel_size, deformable_groups
        self.compute_dtype = compute_dtype
        self.conv_offset_mask = Conv2d(in_channels, deformable_groups * k * 3,
                                       kernel_size,
                                       padding=(kernel_size - 1) // 2)
        self.kernel = nn.Parameter(torch.empty(k, in_channels, out_channels))

    def forward(self, x):
        om = self.conv_offset_mask(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        dy, dx, mask = torch.chunk(om, 3, dim=-1)
        mask = torch.sigmoid(mask)
        dt = self.compute_dtype or x.dtype
        xin = x.to(dt)
        return modulated_deform_conv(xin, dy, dx, mask.to(dt),
                                     self.kernel.to(dt), self.kernel_size,
                                     self.deformable_groups)


class FeatureAdaption(nn.Module):
    """MDCN feature adaptation of the CenterAF head: 4 deformable groups,
    ReLU on the output."""

    def __init__(self, in_channels, out_channels, kernel_size=3,
                 deformable_groups=4, compute_dtype=None):
        super().__init__()
        self.mdcn = MdeformConvBlock(in_channels, out_channels, kernel_size,
                                     deformable_groups, compute_dtype)

    def forward(self, x):
        return torch.relu(self.mdcn(x))
