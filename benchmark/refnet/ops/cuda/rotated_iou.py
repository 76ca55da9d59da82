# Frozen at commit c8e3fcd from fv2p_torch/ops/cuda/rotated_iou.py; the CUDA launches left out: the dispatchers run the plain versions.
"""Rotated-BEV box overlap (kernel B1): intersection areas and IoU.

CUDA kernel: ``ops/csrc/rotated_iou.cu``; it replaces the Pallas kernel
``fv2p_tpu/ops/pallas/rotated_iou.py:overlap_matrix``. Three entry points,
each with its plain version and a dispatch on the tensor's device:

  * ``overlap_matrix(corners_a, corners_b)``: intersection areas (N, M);
  * ``iou_bev(boxes_a, boxes_b)``: the BEV IoU (N, M) of (., 7) boxes, with
    the corners, the box areas and the division inside the kernel;
  * ``iou_bev_upper(boxes)``: the IoU of a set against itself for i < j and
    0 elsewhere, which is all that greedy NMS reads.

The kernel culls the pairs whose boxes lie certainly apart (their clip is
exactly 0), compacts the rest and clips those. The plain version is the
same Sutherland-Hodgman clip (at most 8 vertices, eps 1e-8) and shoelace
area over (N, M) tensors, without a cull.
"""
import torch

from ...utils import box_utils

_EPS = 1e-8
_V = 8
_MAX_ROWS = 65535 * 32   # row tiles of 32 are the grid's second dimension


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


def bev_corners_ccw(boxes):
    """(N, 7) -> (N, 4, 2) BEV corners in CCW order for the clipper."""
    return box_utils.boxes_to_corners_bev(boxes).flip(1)


def iou_bev_plain(boxes_a, boxes_b):
    """(N, 7) x (M, 7) boxes -> (N, M) rotated BEV IoU."""
    ov = overlap_matrix_plain(bev_corners_ccw(boxes_a), bev_corners_ccw(boxes_b))
    area_a = boxes_a[:, 3] * boxes_a[:, 4]
    area_b = boxes_b[:, 3] * boxes_b[:, 4]
    return ov / torch.clamp(area_a[:, None] + area_b[None, :] - ov, min=1e-6)


def iou_bev_upper_plain(boxes):
    """(N, 7) -> (N, N): iou_bev_plain(boxes, boxes) for i < j, 0 elsewhere."""
    return torch.triu(iou_bev_plain(boxes, boxes), diagonal=1)


def overlap_matrix(corners_a, corners_b):
    return overlap_matrix_plain(corners_a, corners_b)


def iou_bev(boxes_a, boxes_b):
    return iou_bev_plain(boxes_a, boxes_b)


def iou_bev_upper(boxes):
    return iou_bev_upper_plain(boxes)
