# Frozen at commit c8e3fcd from fv2p_torch/ops/sparse/rulebook.py, unchanged.
"""Neighbour tables of the sparse convolutions, built on the device from the
voxel keys (counterpart of ``fv2p_tpu/ops/sparse/rulebook.py``).

The tables have the layout ``ops/sparse/conv.py`` takes: (N_out, K) int64,
for output row ``o`` and kernel tap ``k`` the row of the contributing input
voxel, or the zero row N_in where there is none. A strided layer also gets
its inverse table (N_in, K), for each input row and tap the output row it
feeds (the zero row N_out where none), which carries the scatter-free
backward.

Everything is tensor code on fixed shapes: sorts, binary searches, cumsums
and scatters to unique slots, with no host read. JAX finds the output set
of a strided layer from dense occupancy bit planes; here each valid input
voxel proposes the output cells it reaches and a sort keeps the distinct
ones. Both give the active output cells in ascending key order, truncated
to the level's capacity (``dropped`` counts the rest).
"""
import itertools

import numpy as np
import torch

from ...utils.common_utils import device_constant
from .sparse_tensor import INVALID_KEY, decode_keys, from_candidate_keys


def _as3(v):
    if isinstance(v, (tuple, list)):
        return tuple(int(x) for x in v)
    return (int(v),) * 3


def out_shape(shape, kernel, stride, padding):
    (kd, kh, kw), (sd, sh, sw), (pd, ph, pw) = _as3(kernel), _as3(stride), _as3(padding)
    d, h, w = shape
    return ((d + 2 * pd - kd) // sd + 1, (h + 2 * ph - kh) // sh + 1,
            (w + 2 * pw - kw) // sw + 1)


def kernel_offsets(kernel_size):
    """Static (K, 3) numpy array of (dz, dy, dx) taps, row-major order."""
    kd, kh, kw = _as3(kernel_size)
    return np.array(list(itertools.product(range(kd), range(kh), range(kw))),
                    dtype=np.int64)


def _taps(kernel_size, device, centered=False):
    """(K, 3) int64 taps on ``device`` (copied once per process), less the
    kernel's center with ``centered``."""
    taps = kernel_offsets(kernel_size)
    if centered:
        taps = taps - np.array([k // 2 for k in _as3(kernel_size)])
    return device_constant(taps, torch.int64, device)


def subm_rulebook(st, kernel_size=3):
    """Submanifold table (N, K): the voxel at ``coord + tap - kernel // 2``
    for every row and tap."""
    d, h, w = st.spatial_shape
    rel = _taps(kernel_size, st.keys.device, centered=True)        # (K, 3)
    b, z, y, x = decode_keys(st.keys, st.spatial_shape).unbind(-1)
    z = z[:, None] + rel[:, 0]
    y = y[:, None] + rel[:, 1]
    x = x[:, None] + rel[:, 2]
    ok = ((z >= 0) & (z < d) & (y >= 0) & (y < h) & (x >= 0) & (x < w)
          & st.valid_mask()[:, None])
    return st.lookup(b[:, None], z, y, x, ok)


def downsample_rulebook(st, kernel_size, stride, padding, out_capacity):
    """Strided conv: output ``o`` gathers input ``o * s - p + tap``; an output
    cell is active if any input voxel reaches it. Returns (the output
    SparseTensor without features, nbr (out_capacity, K), inv (N_in, K), the
    number of active output cells past ``out_capacity``, a 0-d tensor)."""
    (sd, sh, sw), (pd, ph, pw) = _as3(stride), _as3(padding)
    d, h, w = st.spatial_shape
    od, oh, ow = out_shape(st.spatial_shape, kernel_size, stride, padding)
    dev = st.keys.device
    taps = _taps(kernel_size, dev)                                  # (K, 3)
    b, z, y, x = decode_keys(st.keys, st.spatial_shape).unbind(-1)

    # 1) every output cell each valid input reaches through some tap
    zn = z[:, None] + pd - taps[:, 0]
    yn = y[:, None] + ph - taps[:, 1]
    xn = x[:, None] + pw - taps[:, 2]
    oz, oy, ox = zn // sd, yn // sh, xn // sw
    ok = ((zn % sd == 0) & (yn % sh == 0) & (xn % sw == 0)
          & (oz >= 0) & (oz < od) & (oy >= 0) & (oy < oh) & (ox >= 0) & (ox < ow)
          & st.valid_mask()[:, None])
    cand = ((b[:, None] * oh + oy) * ow + ox) * od + oz
    cand = torch.where(ok, cand, INVALID_KEY)
    out_st, dropped = from_candidate_keys(cand.reshape(-1), out_capacity, (od, oh, ow),
                                       st.batch_size, st.features.dtype)

    # 2) the output side's gather table, looked up in the input's keys
    ob, ozz, oyy, oxx = decode_keys(out_st.keys, out_st.spatial_shape).unbind(-1)
    iz = ozz[:, None] * sd - pd + taps[:, 0]
    iy = oyy[:, None] * sh - ph + taps[:, 1]
    ix = oxx[:, None] * sw - pw + taps[:, 2]
    in_bounds = ((iz >= 0) & (iz < d) & (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
                 & out_st.valid_mask()[:, None])
    nbr = st.lookup(ob[:, None], iz, iy, ix, in_bounds)             # (N_out, K)

    # 3) inverse table: inv[i, k] = o where nbr[o, k] = i (unique per tap);
    # every missing neighbour lands on the dropped row N_in
    n_in, k = st.capacity, nbr.shape[1]
    o_ids = torch.arange(out_capacity, device=dev)[:, None].expand_as(nbr)
    slot = nbr * k + torch.arange(k, device=dev)
    inv = torch.full(((n_in + 1) * k,), out_capacity, dtype=torch.int64, device=dev)
    inv.scatter_(0, slot.reshape(-1), o_ids.reshape(-1))
    return out_st, nbr, inv.view(n_in + 1, k)[:n_in], dropped
