"""The yardstick's arithmetic: the card's peaks and the least time each hand
kernel's call could take, from the call's inputs.

Frozen at commit c8e3fcd from ``chip_smoke.py``: the peaks (lines 385-387),
``bound_rotated_iou``, ``bound_fps``, ``bound_three_nn``, ``sa_slots``,
``bound_sa_group`` and ``bound_dcn`` (lines 511-580) and
``bound_dcn_backward`` (line 1690), unchanged. Each bound returns (seconds
for the bytes at the memory rate, seconds for the operations at the
compute rate); the call's least time is the larger. Work that depends on the
data (B1's pairs, B4's ball counts) is counted from the call's inputs.
Each hand kernel's file under ``kernels/`` names its bound."""
import torch

# H100 SXM data sheet (dense): HBM rate, f32 outside the tensor cores, bf16
HBM_BYTES_S, F32_OPS_S, BF16_OPS_S = 3.35e12, 67e12, 989e12
# Sutherland-Hodgman over 4 edges x 8 slots + the shoelace sum (clip_area)
CLIP_OPS_PER_PAIR = 460

def bound_rotated_iou(call):
    """Every pair the function defines is clipped: all n x m, or i < j of a
    set against itself; boxes are 28 B, corners 32 B."""
    fn, args = call
    n, m = args[0].shape[0], args[-1].shape[0]
    upper = fn == 'iou_bev_upper_cuda'
    row = 32 if fn == 'overlap_matrix_cuda' else 28
    nbytes = (n if upper else n + m) * row + n * m * 4
    pairs = n * (n - 1) // 2 if upper else n * m
    return nbytes / HBM_BYTES_S, pairs * CLIP_OPS_PER_PAIR / F32_OPS_S


def bound_fps(call):
    pts, valid, k = call[1]
    b, n, _ = pts.shape
    nbytes = b * n * 13 + b * k * 4
    # each pick: 3 sub, 3 mul, 2 add, min, compare per valid point
    ops = 10 * (k - 1) * int(valid.sum())
    return nbytes / HBM_BYTES_S, ops / F32_OPS_S


def bound_three_nn(call):
    """The function by brute force, whatever implements it: a search that
    skips sources can come in under this."""
    src, valid, q = call[1]
    b, n, _ = src.shape
    m = q.shape[1]
    nbytes = b * n * 13 + b * m * 12 + b * m * 3 * 8
    ops = 10 * m * int(valid.sum())            # every valid source per query
    return nbytes / HBM_BYTES_S, ops / F32_OPS_S


def sa_slots(args):
    """Distinct MLP slots per (radius): max(1, min(in-ball count, nsample))."""
    centers, xyz, valid, _, _, _, _, _, radii, nsamples = args
    d2 = ((centers[:, :, None, :] - xyz[:, None, :, :]) ** 2).sum(-1)
    out = []
    for r, ns in zip(radii, nsamples):
        cnt = ((d2 < r * r) & valid[:, None, :]).sum(-1)
        out.append(int(cnt.clamp(min=1, max=ns).sum()))
    return out


def bound_sa_group(call):
    args = call[1]
    centers, xyz, valid, z, cw, w2, b1, b2, _, _ = args
    r, g, _ = centers.shape
    nbytes = sum(t.numel() * t.element_size()
                 for t in (centers, xyz, valid, z, cw, w2, b1, b2))
    nbytes += r * g * 128 * 2                   # bf16 output
    slots = sum(sa_slots(args))
    h = z.shape[-1]
    f32_ops = 8 * g * int(valid.sum()) + 2 * h * slots   # distances, layer 1
    bf16_ops = 2 * h * h * slots                         # layer 2
    return nbytes / HBM_BYTES_S, f32_ops / F32_OPS_S + bf16_ops / BF16_OPS_S


def bound_dcn(args):
    """One modulated_deform_conv call: its inputs read once (map, offsets,
    mask, weights) and its f32 output written once; 2 operations a MAC at
    the rate of the compute type."""
    x, dy, dx, mask, w, ks, _ = args
    b, h, wd, c = x.shape
    cout = w.shape[-1]
    nbytes = sum(t.numel() * t.element_size() for t in (x, dy, dx, mask, w))
    nbytes += b * h * wd * cout * 4
    macs = b * h * wd * ks * ks * c * cout
    rate = F32_OPS_S if x.dtype == torch.float32 else BF16_OPS_S
    return nbytes / HBM_BYTES_S, 2 * macs / rate, macs


def bound_dcn_backward(args):
    """The backward of one modulated_deform_conv call: its inputs and the
    f32 output gradient read once, a gradient of each input written once;
    two products a tap (the samples' gradient and the weights'), 2x the
    forward's MACs."""
    x, dy, dx, mask, w, ks, _ = args
    b, h, wd, _ = x.shape
    nbytes = 2 * sum(t.numel() * t.element_size() for t in (x, dy, dx, mask, w))
    nbytes += b * h * wd * w.shape[-1] * 4
    _, ops_s, macs = bound_dcn(args)
    return nbytes / HBM_BYTES_S, 2 * ops_s, 2 * macs
