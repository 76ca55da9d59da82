"""Rotated-BEV box overlap-area matrix (kernel B1).

CUDA kernel: ``ops/csrc/rotated_iou.cu``; it replaces the Pallas kernel
``fv2p_tpu/ops/pallas/rotated_iou.py:overlap_matrix``. The plain version
below is the same Sutherland-Hodgman clip (at most 8 vertices, eps 1e-8)
and shoelace area over (N, M) tensors.
"""
import torch

from . import check_launch, check_tensor, launch_counts, library, stream_handle

_EPS = 1e-8
_V = 8


def overlap_matrix_plain(corners_a, corners_b):
    """(N, 4, 2) x (M, 4, 2) CCW corners -> (N, M) intersection areas."""
    n, m = corners_a.shape[0], corners_b.shape[0]
    ca = corners_a.to(torch.float32)
    cb = corners_b.to(torch.float32)
    shape = (n, m)
    zeros = ca.new_zeros(shape)
    vx = [ca[:, k, 0, None].expand(shape) for k in range(4)] + [zeros] * 4
    vy = [ca[:, k, 1, None].expand(shape) for k in range(4)] + [zeros] * 4
    count = torch.full(shape, 4, dtype=torch.int32, device=ca.device)

    for e in range(4):
        p1x, p1y = cb[None, :, e, 0], cb[None, :, e, 1]
        ex = cb[None, :, (e + 1) % 4, 0] - p1x
        ey = cb[None, :, (e + 1) % 4, 1] - p1y
        side = [ex * (vy[k] - p1y) - ey * (vx[k] - p1x) for k in range(_V)]
        new_vx = [zeros] * _V
        new_vy = [zeros] * _V
        pos = torch.full(shape, -1, dtype=torch.int32, device=ca.device)
        for k in range(_V):
            kn = min(k + 1, _V - 1)
            wrap = (k + 1) >= count
            nx = torch.where(wrap, vx[0], vx[kn])
            ny = torch.where(wrap, vy[0], vy[kn])
            ns = torch.where(wrap, side[0], side[kn])
            valid_slot = k < count
            inside = side[k] >= 0
            denom = side[k] - ns
            t = side[k] / torch.where(denom.abs() > _EPS, denom,
                                      torch.full_like(denom, _EPS))
            ix = vx[k] + t * (nx - vx[k])
            iy = vy[k] + t * (ny - vy[k])
            for ok, cx, cy in ((inside & valid_slot, vx[k], vy[k]),
                               ((inside != (ns >= 0)) & valid_slot, ix, iy)):
                pos = pos + ok.to(torch.int32)
                for j in range(_V):
                    sel = ok & (pos == j)
                    new_vx[j] = torch.where(sel, cx, new_vx[j])
                    new_vy[j] = torch.where(sel, cy, new_vy[j])
        vx, vy = new_vx, new_vy
        count = torch.clamp(pos + 1, max=_V)

    area = zeros
    for k in range(_V):
        kn = min(k + 1, _V - 1)
        wrap = (k + 1) >= count
        nx = torch.where(wrap, vx[0], vx[kn])
        ny = torch.where(wrap, vy[0], vy[kn])
        cross = vx[k] * ny - vy[k] * nx
        area = area + torch.where(k < count, cross, zeros)
    area = 0.5 * area.abs()
    return torch.where(count >= 3, area, zeros)


def overlap_matrix_cuda(corners_a, corners_b):
    n, m = corners_a.shape[0], corners_b.shape[0]
    check_tensor(corners_a, 'corners_a', torch.float32, (n, 4, 2))
    check_tensor(corners_b, 'corners_b', torch.float32, (m, 4, 2))
    out = torch.empty((n, m), dtype=torch.float32, device=corners_a.device)
    lib = library('rotated_iou')
    code = lib.fv2p_overlap_matrix(corners_a.data_ptr(), corners_b.data_ptr(),
                                   out.data_ptr(), n, m,
                                   stream_handle(corners_a.device))
    check_launch('rotated_iou', lib, code)
    launch_counts['rotated_iou'] += 1
    return out


def overlap_matrix(corners_a, corners_b):
    """Dispatch: plain version for CPU tensors, the CUDA kernel otherwise."""
    if corners_a.device.type == 'cpu':
        return overlap_matrix_plain(corners_a, corners_b)
    return overlap_matrix_cuda(corners_a.float().contiguous(),
                               corners_b.float().contiguous())
