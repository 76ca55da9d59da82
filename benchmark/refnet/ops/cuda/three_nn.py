# Frozen at commit c8e3fcd from fv2p_torch/ops/cuda/three_nn.py; the CUDA launch left out: the dispatcher runs the plain version.
"""Exact 3-nearest-neighbour search (kernel B3).

CUDA kernel: ``ops/csrc/three_nn.cu``; it replaces the Pallas kernel
``fv2p_tpu/ops/pallas/three_nn.py:three_nn_pallas``, batched over samples.
Elementwise f32 squared distances, invalid sources at +1e10, the three
smallest in (distance, index) order, clamped to d >= 0 and idx in [0, N-1];
a slot that no source fills (N < 3) holds (inf, 0).

The kernel is exact for any source order and valid mask, and fast where
consecutive sources lie close together (voxel centers in key order): a small
preparation kernel boxes every tile of consecutive sources, and the search
kernel, one warp per query, skips each tile whose box is farther from the
query than the third-best distance met so far. The wrapper allocates the
scratch of both: the tile boxes and the sources repacked as float4.
"""
import torch

_BIG = 1e10
_QUERY_CHUNK = 2048      # queries per (chunk, N) distance matrix
# the search kernel keeps 28 bytes a tile of sources in shared memory
_MAX_SOURCES = 1 << 20
_MAX_GRID_Y = 65535      # samples are the grid's second dimension


def three_nn_plain(src_xyz, src_valid, query_xyz):
    """src (B, N, 3), src_valid (B, N) bool, query (B, M, 3)
    -> (d2 (B, M, 3) ascending, idx (B, M, 3) int32)."""
    b, n, _ = src_xyz.shape
    s = src_xyz.to(torch.float32)
    q_all = query_xyz.to(torch.float32)
    inv = torch.where(src_valid, 0.0, _BIG).to(torch.float32)[:, None, :]
    ds, idxs = [], []
    for start in range(0, q_all.shape[1], _QUERY_CHUNK):
        q = q_all[:, start:start + _QUERY_CHUNK]
        d2 = ((q[:, :, None, 0] - s[:, None, :, 0]) ** 2
              + (q[:, :, None, 1] - s[:, None, :, 1]) ** 2
              + (q[:, :, None, 2] - s[:, None, :, 2]) ** 2) + inv
        cd, ci = [], []
        for _ in range(3):
            i = torch.argmin(d2, dim=-1, keepdim=True)   # first minimal index
            cd.append(d2.gather(-1, i))
            ci.append(i)
            d2 = d2.scatter(-1, i, float('inf'))
        ds.append(torch.cat(cd, -1))
        idxs.append(torch.cat(ci, -1))
    d = torch.cat(ds, 1).clamp(min=0.0)
    idx = torch.cat(idxs, 1).clamp(0, n - 1).to(torch.int32)
    return d, idx


def three_nn(src_xyz, src_valid, query_xyz):
    return three_nn_plain(src_xyz, src_valid, query_xyz)
