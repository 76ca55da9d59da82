"""Exact farthest-point sampling (kernel B2).

CUDA kernel: ``ops/csrc/fps.cu``; it replaces the Pallas kernel
``fv2p_tpu/ops/pallas/fps.py:fps_pallas``. Pick 0 is the first valid index
(0 if none); each later pick takes the argmax of the running min squared
distance, the lowest index winning ties; invalid points never win. When
fewer points than picks are valid, later picks repeat selected points (the
caller adds the wraparound padding).

The kernel spreads one scan over a thread-block cluster (16 blocks, past the
portable 8, above 24576 points), so it needs a card of compute capability
9.0 or later (H100); on an older card ``fps_cuda`` raises ``ValueError``
before it launches anything.
"""
import torch

from ...utils import tracing

from . import check_launch, check_tensor, library, require, stream_handle

_BIG = 1e10
# Three instantiations of the kernel, by the scan's point count N. Up to
# 18 * 1024 points (8 blocks of 128 threads) every block keeps the whole
# scan's coordinates; up to 24 * 1024 (the 24000-point scans of the KITTI
# train config) each block keeps its own; above, up to 22 points a thread
# of a 16 x 512 cluster: the 180000-point Waymo scans (MAX_POINTS_PER_SCAN).
MAX_POINTS = 22 * 16 * 512


def fps_plain(points, valid, num_samples):
    """points (B, N, 3) f32; valid (B, N) bool -> (B, num_samples) int32."""
    b, n, _ = points.shape
    x, y, z = (points[..., i].to(torch.float32) for i in range(3))
    big = torch.full_like(x, _BIG)
    dists = torch.where(valid, big, -big)
    iota = torch.arange(n, device=points.device).expand(b, n)
    first = torch.where(valid, iota, n).min(dim=1).values
    last = torch.where(first >= n, 0, first)
    out = torch.empty((b, num_samples), dtype=torch.int32, device=points.device)
    out[:, 0] = last
    for k in range(1, num_samples):
        li = last[:, None]
        d = ((x - x.gather(1, li)) ** 2 + (y - y.gather(1, li)) ** 2
             + (z - z.gather(1, li)) ** 2)
        dists = torch.minimum(dists, torch.where(valid, d, -big))
        last = torch.argmax(dists, dim=1)      # first maximal index
        out[:, k] = last
    return out


def _launch(entry, points, valid, num_samples):
    b, n, _ = points.shape
    check_tensor(points, 'points', torch.float32, (b, n, 3))
    check_tensor(valid, 'valid', torch.bool, (b, n))
    require(n <= MAX_POINTS, f'fps kernel takes at most {MAX_POINTS} points')
    require(torch.cuda.get_device_capability(points.device) >= (9, 0),
            'fps kernel needs thread-block clusters (compute capability 9.0)')
    x, y, z = (points[..., i].contiguous() for i in range(3))
    out = torch.empty((b, num_samples), dtype=torch.int32, device=points.device)
    lib = library('fps')
    code = getattr(lib, entry)(x.data_ptr(), y.data_ptr(), z.data_ptr(),
                               valid.data_ptr(), out.data_ptr(), b, n,
                               num_samples, stream_handle(points.device))
    check_launch('fps', lib, code)
    return out


def fps_cuda(points, valid, num_samples):
    out = _launch('fv2p_fps', points, valid, num_samples)
    tracing.count('launches.fps')
    return out


def fps_chain_floor_cuda(points, valid, num_samples):
    """The kernel's chain of cluster-wide exchanges without its distance
    work, for timing only: the indices it returns mean nothing, and it is
    not a launch of the kernel."""
    return _launch('fv2p_fps_chain', points, valid, num_samples)


def fps(points, valid, num_samples):
    """Dispatch: plain version for CPU tensors, the CUDA kernel otherwise."""
    if points.device.type == 'cpu':
        return fps_plain(points, valid, num_samples)
    return fps_cuda(points.float().contiguous(), valid.contiguous(),
                    num_samples)
