"""Rotated-box overlap and IoU in plain numpy, for evaluators that run on
the host (the native Waymo metrics): float64 Sutherland-Hodgman clipping of
the boxes' BEV quads, vectorised over pairs, with the clip semantics of the
rotated-IoU kernel (B1) but none of its devices.

Boxes are lidar-frame ``(x, y, z, dx, dy, dz, heading)`` with z at the box
center, as everywhere in this package.
"""
import numpy as np

_EPS = 1e-8


def boxes_to_corners_bev_np(boxes):
    """(N, 7) -> (N, 4, 2) BEV corner xy in CCW order."""
    # CCW template of the box_utils bottom face: (+,+) (-,+) (-,-) (+,-)
    template = np.array(
        [[1, 1], [-1, 1], [-1, -1], [1, -1]], dtype=np.float64) / 2
    corners = boxes[:, None, 3:5] * template[None]            # (N, 4, 2)
    cosa = np.cos(boxes[:, 6])[:, None]
    sina = np.sin(boxes[:, 6])[:, None]
    x = corners[..., 0] * cosa - corners[..., 1] * sina
    y = corners[..., 0] * sina + corners[..., 1] * cosa
    return np.stack([x, y], axis=-1) + boxes[:, None, 0:2]


def _polygon_clip_area_np(poly_a, poly_b):
    """Intersection area of convex quads, vectorized over pairs.

    Args:
        poly_a: (P, 4, 2) subject polygons, CCW.
        poly_b: (P, 4, 2) clip polygons, CCW.
    Returns:
        (P,) intersection areas.
    """
    p = poly_a.shape[0]
    v_max = 8  # convex quad ∩ convex quad has <= 8 vertices
    vx = np.zeros((p, v_max), np.float64)
    vy = np.zeros((p, v_max), np.float64)
    vx[:, :4] = poly_a[..., 0]
    vy[:, :4] = poly_a[..., 1]
    count = np.full(p, 4, np.int64)
    rows = np.arange(p)
    iota = np.arange(v_max)[None, :]                          # (1, V)

    for e in range(4):
        p1x, p1y = poly_b[:, e, 0], poly_b[:, e, 1]
        p2x, p2y = poly_b[:, (e + 1) % 4, 0], poly_b[:, (e + 1) % 4, 1]
        ex, ey = (p2x - p1x)[:, None], (p2y - p1y)[:, None]

        side = ex * (vy - p1y[:, None]) - ey * (vx - p1x[:, None])  # (P, V)
        inside = side >= 0
        nxt_idx = np.where(iota + 1 < count[:, None], iota + 1, 0)
        nxt_x = vx[rows[:, None], nxt_idx]
        nxt_y = vy[rows[:, None], nxt_idx]
        nxt_side = ex * (nxt_y - p1y[:, None]) - ey * (nxt_x - p1x[:, None])
        nxt_inside = nxt_side >= 0
        valid_slot = iota < count[:, None]

        denom = side - nxt_side
        t = side / np.where(np.abs(denom) > _EPS, denom, _EPS)
        ix = vx + t * (nxt_x - vx)
        iy = vy + t * (nxt_y - vy)

        emit_cur = inside & valid_slot
        emit_int = (inside != nxt_inside) & valid_slot

        # interleave candidates: 2i = current vertex, 2i+1 = edge intersection
        cand_x = np.stack([vx, ix], axis=2).reshape(p, 2 * v_max)
        cand_y = np.stack([vy, iy], axis=2).reshape(p, 2 * v_max)
        cand_ok = np.stack([emit_cur, emit_int], axis=2).reshape(p, 2 * v_max)

        pos = np.cumsum(cand_ok, axis=1) - 1                  # (P, 2V)
        new_vx = np.zeros_like(vx)
        new_vy = np.zeros_like(vy)
        slot = np.where(cand_ok, pos, v_max)
        # scatter candidates into their compacted slots (one writer per slot)
        flat = rows[:, None] * (v_max + 1) + np.minimum(slot, v_max)
        buf_x = np.zeros(p * (v_max + 1), np.float64)
        buf_y = np.zeros(p * (v_max + 1), np.float64)
        np.add.at(buf_x, flat.ravel(), np.where(cand_ok, cand_x, 0.0).ravel())
        np.add.at(buf_y, flat.ravel(), np.where(cand_ok, cand_y, 0.0).ravel())
        new_vx = buf_x.reshape(p, v_max + 1)[:, :v_max]
        new_vy = buf_y.reshape(p, v_max + 1)[:, :v_max]
        vx, vy = new_vx, new_vy
        count = np.minimum(pos[:, -1] + 1, v_max)

    nxt_idx = np.where(iota + 1 < count[:, None], iota + 1, 0)
    nxt_x = vx[rows[:, None], nxt_idx]
    nxt_y = vy[rows[:, None], nxt_idx]
    cross = np.where(iota < count[:, None], vx * nxt_y - vy * nxt_x, 0.0)
    area = 0.5 * np.abs(cross.sum(axis=1))
    return np.where(count >= 3, area, 0.0)


def boxes_overlap_bev_np(boxes_a, boxes_b):
    """(N, 7) x (M, 7) -> (N, M) rotated BEV intersection areas."""
    n, m = len(boxes_a), len(boxes_b)
    if n == 0 or m == 0:
        return np.zeros((n, m), np.float64)
    ca = boxes_to_corners_bev_np(np.asarray(boxes_a, np.float64))
    cb = boxes_to_corners_bev_np(np.asarray(boxes_b, np.float64))
    pa = np.broadcast_to(ca[:, None], (n, m, 4, 2)).reshape(n * m, 4, 2)
    pb = np.broadcast_to(cb[None, :], (n, m, 4, 2)).reshape(n * m, 4, 2)
    return _polygon_clip_area_np(pa, pb).reshape(n, m)


def boxes_iou_bev_np(boxes_a, boxes_b):
    """(N, M) rotated BEV IoU."""
    overlap = boxes_overlap_bev_np(boxes_a, boxes_b)
    area_a = (boxes_a[:, 3] * boxes_a[:, 4])[:, None]
    area_b = (boxes_b[:, 3] * boxes_b[:, 4])[None, :]
    return overlap / np.clip(area_a + area_b - overlap, 1e-6, None)


def boxes_iou3d_np(boxes_a, boxes_b):
    """(N, M) 3D IoU, z-extent from box center (iou3d.boxes_iou3d twin)."""
    boxes_a = np.asarray(boxes_a, np.float64)
    boxes_b = np.asarray(boxes_b, np.float64)
    overlap_bev = boxes_overlap_bev_np(boxes_a, boxes_b)
    a_zmin = (boxes_a[:, 2] - boxes_a[:, 5] / 2)[:, None]
    a_zmax = (boxes_a[:, 2] + boxes_a[:, 5] / 2)[:, None]
    b_zmin = (boxes_b[:, 2] - boxes_b[:, 5] / 2)[None, :]
    b_zmax = (boxes_b[:, 2] + boxes_b[:, 5] / 2)[None, :]
    overlap_h = np.clip(np.minimum(a_zmax, b_zmax)
                        - np.maximum(a_zmin, b_zmin), 0.0, None)
    overlap_3d = overlap_bev * overlap_h
    vol_a = (boxes_a[:, 3] * boxes_a[:, 4] * boxes_a[:, 5])[:, None]
    vol_b = (boxes_b[:, 3] * boxes_b[:, 4] * boxes_b[:, 5])[None, :]
    return overlap_3d / np.clip(vol_a + vol_b - overlap_3d, 1e-6, None)
