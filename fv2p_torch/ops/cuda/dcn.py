"""Modulated deformable conv forward without autograd: one implicit GEMM whose
A operand, each tap's bilinear samples, is blended in shared memory.

CUDA kernel: ``ops/csrc/dcn.cu``. It replaces no Pallas kernel: JAX runs the
deformable conv as XLA (``fv2p_tpu/ops/dcn.py``), and ``ops/dcn.py`` as
PyTorch tensor code that writes every tap's corners and blends to device
memory. ``ops/dcn.py`` sends the no-grad bf16 forward on the card here; a
call that autograd records keeps ``_ModulatedDeformConvFn``.

The function is that of ``_ModulatedDeformConvFn``'s forward
(``_mdcn_forward``) for a 3 x 3 kernel: x (B, H, W, C) bf16, the offsets
(B, H, W, G * 9) f32, the mask (B, H, W, G * 9) bf16 (group-major, taps
ky-major), the weights (9, C, Cout) bf16 -> (B, H, W, Cout) f32; f32
coordinates, the modulation folded into the four corner weights, which are
rounded to bf16, a blend rounded to bf16 after each corner, bf16 products
and f32 sums, a tap at a time.
"""
import math

import torch
import torch.nn.functional as F

from ...utils import tracing
from . import aligned, check_launch, library, require, stream_handle

TAPS = 9                 # the kernel's 3 x 3
COUTS = (128, 256)       # the kernel's instantiations: a block takes all of Cout
CG_MULTIPLE = 8          # a group's channels are read 8 at a time
INT32_MAX = 2 ** 31 - 1


def mdcn_fwd_plain(x, offset_dy, offset_dx, mask, weight, groups):
    """The tensor code's arithmetic for any K x K kernel, a tap at a time: the
    four corners of every sample read from the map zero-padded by one cell
    (the padding's corner cell where the sample does not count), blended
    with the modulated weights in x's type, and the tap's product added into
    an f32 accumulator."""
    b, h, w, c = x.shape
    k, _, cout = weight.shape
    ks = math.isqrt(k)
    g, pad = groups, (ks - 1) // 2
    cdt = torch.promote_types(offset_dy.dtype, torch.float32)
    dev = x.device
    src = F.pad(x, (0, 0, 1, 1, 1, 1)).reshape(b, h + 2, w + 2, g, c // g)
    bi = torch.arange(b, device=dev).view(b, 1, 1, 1)
    gi = torch.arange(g, device=dev).view(1, 1, 1, g)
    base_y = torch.arange(h, device=dev, dtype=cdt).view(1, h, 1, 1)
    base_x = torch.arange(w, device=dev, dtype=cdt).view(1, 1, w, 1)
    dy, dx = (o.to(cdt).reshape(b, h, w, g, k) for o in (offset_dy, offset_dx))
    m = mask.to(cdt).reshape(b, h, w, g, k)
    acc = torch.zeros((b * h * w, cout), dtype=torch.promote_types(x.dtype, torch.float32),
                      device=dev)
    for t in range(k):
        ky, kx = divmod(t, ks)
        sy = (base_y + (ky - pad)) + dy[..., t]
        sx = (base_x + (kx - pad)) + dx[..., t]
        y0, x0 = torch.floor(sy), torch.floor(sx)
        wy1, wx1 = sy - y0, sx - x0
        ok = (y0 >= -1) & (y0 <= h - 1) & (x0 >= -1) & (x0 <= w - 1)
        mt = m[..., t]
        wts = ((1 - wy1) * (1 - wx1) * mt, (1 - wy1) * wx1 * mt,
               wy1 * (1 - wx1) * mt, wy1 * wx1 * mt)
        sampled = None
        for (oy, ox), wt in zip(((0, 0), (0, 1), (1, 0), (1, 1)), wts):
            # padded rows and columns: a counted sample's corners lie in
            # [0, H + 1] x [0, W + 1]; cell (0, 0) is zero
            yy = torch.where(ok, y0 + (oy + 1), 0).long()
            xx = torch.where(ok, x0 + (ox + 1), 0).long()
            v = src[bi, yy, xx, gi]                            # (B, H, W, G, Cg)
            wv = wt.to(x.dtype)[..., None]
            sampled = v * wv if sampled is None else sampled.addcmul_(v, wv)
        a = sampled.view(b * h * w, c)
        if a.is_cuda and a.dtype != acc.dtype:
            acc = torch.addmm(acc, a, weight[t], out_dtype=torch.float32)
        else:
            acc.addmm_(a.to(acc.dtype), weight[t].to(acc.dtype))
    return acc.view(b, h, w, cout)


def refusal(x, offset_dy, offset_dx, mask, weight, groups):
    """Why the kernel does not take these operands (dtypes, shapes, its
    limits, one device), or None; contiguity and the device's type aside."""
    if not (x.dim() == 4 and weight.dim() == 3):
        return 'x (B, H, W, C), weight (K, C, Cout)'
    b, h, w, c = x.shape
    cout = weight.shape[2]
    if not (isinstance(groups, int) and groups >= 1 and c % groups == 0):
        return f'groups must divide C = {c}, got {groups}'
    gk = groups * TAPS
    for t, name, dtype, shape in ((x, 'x', torch.bfloat16, (b, h, w, c)),
                                  (offset_dy, 'offset_dy', torch.float32, (b, h, w, gk)),
                                  (offset_dx, 'offset_dx', torch.float32, (b, h, w, gk)),
                                  (mask, 'mask', torch.bfloat16, (b, h, w, gk)),
                                  (weight, 'weight', torch.bfloat16, (TAPS, c, cout))):
        if t.dtype != dtype:
            return f'{name} must be {dtype}, got {t.dtype}'
        if tuple(t.shape) != shape:
            return f'{name} must have shape {shape}, got {tuple(t.shape)}'
        if t.device != x.device:
            return f"{name} must lie on x's device"
    if (c // groups) % CG_MULTIPLE:
        return f'C / groups must be a multiple of {CG_MULTIPLE}, got {c // groups}'
    if cout not in COUTS:
        return f'Cout must be one of {COUTS}, got {cout}'
    if b * h * w * max(c, cout, gk) > INT32_MAX:
        return "elements past the kernel's 32-bit indexing"
    return None


def check_operands(x, offset_dy, offset_dx, mask, weight, groups):
    """Raise ValueError on operands the kernel does not take, the device's
    type aside: dtypes, shapes, contiguity, the kernel's limits, one device."""
    reason = refusal(x, offset_dy, offset_dx, mask, weight, groups)
    require(reason is None, reason)
    for t, name in ((x, 'x'), (offset_dy, 'offset_dy'), (offset_dx, 'offset_dx'),
                    (mask, 'mask'), (weight, 'weight')):
        require(t.is_contiguous(), f'{name} must be contiguous')


def mdcn_fwd_cuda(x, offset_dy, offset_dx, mask, weight, groups):
    require(x.is_cuda, 'x must be a CUDA tensor')
    check_operands(x, offset_dy, offset_dx, mask, weight, groups)
    b, h, w, c = x.shape
    cout = weight.shape[2]
    out = torch.empty((b, h, w, cout), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    # the kernel reads corners and W in 16-byte pieces
    x, weight = aligned(x), aligned(weight)
    lib = library('dcn')
    code = lib.fv2p_dcn_fwd(x.data_ptr(), offset_dy.data_ptr(), offset_dx.data_ptr(),
                            mask.data_ptr(), weight.data_ptr(), out.data_ptr(),
                            b, h, w, c, groups, cout, stream_handle(x.device))
    check_launch('dcn', lib, code)
    tracing.count('launches.dcn')
    return out


def mdcn_fwd(x, offset_dy, offset_dx, mask, weight, groups):
    """Dispatch: plain version for CPU tensors, the CUDA kernel otherwise
    (on contiguous copies of operands that are views)."""
    if x.device.type == 'cpu':
        return mdcn_fwd_plain(x, offset_dy, offset_dx, mask, weight, groups)
    return mdcn_fwd_cuda(*(t.contiguous() for t in (x, offset_dy, offset_dx, mask, weight)),
                         groups)
