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

from ...utils import tracing

from . import (check_launch, check_tensor, library, require,
               stream_handle)

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


def three_nn_cuda(src_xyz, src_valid, query_xyz):
    b, n, _ = src_xyz.shape
    m = query_xyz.shape[1]
    check_tensor(src_xyz, 'src_xyz', torch.float32, (b, n, 3))
    check_tensor(src_valid, 'src_valid', torch.bool, (b, n))
    check_tensor(query_xyz, 'query_xyz', torch.float32, (b, m, 3))
    require(0 < n <= _MAX_SOURCES,
            f'1 to {_MAX_SOURCES} sources a sample, got {n}')
    require(b <= _MAX_GRID_Y, f'at most {_MAX_GRID_Y} samples, got {b}')
    dev = src_xyz.device
    out_d = torch.empty((b, m, 3), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, m, 3), dtype=torch.int32, device=dev)
    if b == 0 or m == 0:
        return out_d, out_i
    lib = library('three_nn')
    rows = lib.fv2p_three_nn_tile_rows()
    tiles = (n + rows - 1) // rows
    packed = torch.empty((b, tiles * rows, 4), dtype=torch.float32, device=dev)
    boxes = torch.empty((b, tiles, 7), dtype=torch.float32, device=dev)
    code = lib.fv2p_three_nn(query_xyz.data_ptr(), src_xyz.data_ptr(),
                             src_valid.data_ptr(), packed.data_ptr(),
                             boxes.data_ptr(), out_d.data_ptr(),
                             out_i.data_ptr(), b, m, n, stream_handle(dev))
    check_launch('three_nn', lib, code)
    tracing.count('launches.three_nn')
    return out_d, out_i


def three_nn(src_xyz, src_valid, query_xyz):
    """Dispatch: plain version for CPU tensors, the CUDA kernel otherwise."""
    if src_xyz.device.type == 'cpu':
        return three_nn_plain(src_xyz, src_valid, query_xyz)
    return three_nn_cuda(src_xyz.float().contiguous(), src_valid.contiguous(),
                         query_xyz.float().contiguous())
