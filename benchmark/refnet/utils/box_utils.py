# Frozen at commit c8e3fcd from fv2p_torch/utils/box_utils.py, unchanged.
"""3D box geometry (reference ``pcdet/utils/box_utils.py``). Boxes are
(N, 7): [x, y, z, dx, dy, dz, heading] with (x, y, z) the box center and
heading a CCW rotation about +z. Tensor functions serve the model; the
numpy ones (``*_np`` and the frame conversions) serve the data pipeline and
the evaluator, on the host."""
import math

import numpy as np
import torch

from .common_utils import (device_constant, rotate_points_along_z,
                           rotate_points_along_z_np)

# Corner template of the reference boxes_to_corners_3d:
#     7 -------- 4
#    /|         /|
#   6 -------- 5 .
#   | |        | |
#   . 3 -------- 0
#   |/         |/
#   2 -------- 1
_CORNER_TEMPLATE = [
    [1, 1, -1], [1, -1, -1], [-1, -1, -1], [-1, 1, -1],
    [1, 1, 1], [1, -1, 1], [-1, -1, 1], [-1, 1, 1],
]
_CORNER_TEMPLATE_NP = np.array(_CORNER_TEMPLATE, dtype=np.float32) / 2


def _template(boxes, rows, cols):
    t = device_constant(_CORNER_TEMPLATE, boxes.dtype, boxes.device)
    return t[:rows, :cols] / 2


def boxes_to_corners_3d(boxes3d):
    """(N, 7) -> (N, 8, 3) corners in the template's order."""
    corners = boxes3d[:, None, 3:6] * _template(boxes3d, 8, 3)[None]
    corners = rotate_points_along_z(corners, boxes3d[:, 6])
    return corners + boxes3d[:, None, 0:3]


def boxes_to_corners_bev(boxes3d):
    """(N, 7) -> (N, 4, 2) BEV corner xy (bottom face order 0,1,2,3)."""
    corners = boxes3d[:, None, 3:5] * _template(boxes3d, 4, 2)[None]
    cosa = torch.cos(boxes3d[:, 6])[:, None]
    sina = torch.sin(boxes3d[:, 6])[:, None]
    x = corners[..., 0] * cosa - corners[..., 1] * sina
    y = corners[..., 0] * sina + corners[..., 1] * cosa
    return torch.stack([x, y], dim=-1) + boxes3d[:, None, 0:2]


def boxes_to_CTcorners_3d(boxes3d):
    """Canonical (un-rotated, un-translated) corners (N, 8, 3) for the
    corner-geometry stream."""
    return boxes3d[:, None, 3:6] * _template(boxes3d, 8, 3)[None]


def enlarge_box3d(boxes3d, extra_width=(0, 0, 0)):
    """(N, 7+) center-based boxes with dx, dy, dz grown by ``extra_width``;
    the centre and the heading stay."""
    large = boxes3d.clone()
    large[:, 3:6] += torch.as_tensor(extra_width, dtype=boxes3d.dtype, device=boxes3d.device)
    return large


def decode_rot_binres(pred_reg, num_head_bin=None):
    """Bin + residual heading decode: pred_reg (N, 2 * bins) -> (N, 1) in
    (-pi, pi]. Bin centers at k * (2 pi / bins), the residual scaled by half
    a bin; the first of equal bin scores wins, and the wrap is a floor
    modulo (``torch.remainder``, as JAX's ``%``)."""
    n, c = pred_reg.shape
    if num_head_bin is None:
        num_head_bin = c // 2
    bins = pred_reg[:, :num_head_bin]
    res = pred_reg[:, num_head_bin:2 * num_head_bin]
    ry_bin = torch.argmax(bins, dim=1)
    ry_res_norm = torch.gather(res, 1, ry_bin[:, None])[:, 0]
    angle_per_class = (2 * math.pi) / num_head_bin
    ry_res = ry_res_norm * (angle_per_class / 2)
    ry = torch.remainder(ry_bin.to(pred_reg.dtype) * angle_per_class + ry_res,
                         2 * math.pi)
    ry = torch.where(ry > math.pi, ry - 2 * math.pi, ry)
    return ry.reshape(n, 1)


def encode_rot_binres(ry_label, num_head_bin):
    """The training encoding of a heading for the bin + residual loss:
    (bin label int64, residual normalised by half a bin). Bin k covers
    [k - 1/2, k + 1/2) bins around k * (2 pi / bins); both wraps are floor
    modulos (``torch.remainder``, as JAX's ``%``)."""
    angle_per_class = (2 * math.pi) / num_head_bin
    heading = torch.remainder(ry_label, 2 * math.pi)
    shift = torch.remainder(heading + angle_per_class / 2, 2 * math.pi)
    bin_label = torch.floor(shift / angle_per_class).to(torch.int64)
    res = shift - (bin_label.to(shift.dtype) * angle_per_class + angle_per_class / 2)
    return bin_label, res / (angle_per_class / 2)


# ---------------------------------------------------------------------------
# numpy, for the host-side data pipeline and the evaluator
# ---------------------------------------------------------------------------

def boxes_to_corners_3d_np(boxes3d):
    corners = boxes3d[:, None, 3:6] * _CORNER_TEMPLATE_NP[None, :, :]
    corners = rotate_points_along_z_np(corners.astype(np.float32), boxes3d[:, 6])
    return corners + boxes3d[:, None, 0:3]


def mask_boxes_outside_range_numpy(boxes, limit_range, min_num_corners=1):
    """Reference box_utils.py:86-103."""
    if boxes.shape[1] > 7:
        boxes = boxes[:, 0:7]
    corners = boxes_to_corners_3d_np(boxes)  # (N, 8, 3)
    mask = ((corners >= limit_range[0:3]) & (corners <= limit_range[3:6])).all(axis=2)
    return mask.sum(axis=1) >= min_num_corners


def boxes3d_lidar_to_kitti_camera(boxes3d_lidar, calib):
    """lidar [x,y,z(center),dx,dy,dz,heading] -> camera [x,y,z(bottom),l,h,w,ry].

    Reference box_utils.py:214-236: l=dx, h=dz, w=dy; ry = -heading - pi/2.
    """
    boxes3d_lidar = boxes3d_lidar.copy()
    xyz_lidar = boxes3d_lidar[:, 0:3].copy()
    l, w, h = boxes3d_lidar[:, 3:4], boxes3d_lidar[:, 4:5], boxes3d_lidar[:, 5:6]
    r = boxes3d_lidar[:, 6:7]
    xyz_lidar[:, 2] -= h.reshape(-1) / 2
    xyz = calib.lidar_to_rect(xyz_lidar)
    r_cam = -r - np.pi / 2
    return np.concatenate([xyz, l, h, w, r_cam], axis=-1)


def boxes3d_kitti_camera_to_lidar(boxes3d_camera, calib):
    """camera [x,y,z(bottom),l,h,w,ry] -> lidar [x,y,z(center),dx,dy,dz,heading]."""
    boxes3d_camera = boxes3d_camera.copy()
    xyz_camera = boxes3d_camera[:, 0:3]
    l, h, w = boxes3d_camera[:, 3:4], boxes3d_camera[:, 4:5], boxes3d_camera[:, 5:6]
    r = boxes3d_camera[:, 6:7]
    xyz_lidar = calib.rect_to_lidar(xyz_camera)
    xyz_lidar[:, 2] += h.reshape(-1) / 2
    heading = -r - np.pi / 2
    return np.concatenate([xyz_lidar, l, w, h, heading], axis=-1)


def boxes3d_to_corners3d_kitti_camera(boxes3d, bottom_center=True):
    """(N, 7) camera boxes [x,y,z,l,h,w,ry] -> (N, 8, 3) corners.

    Reference box_utils.py:241-276: y is down; box origin at bottom center.
    """
    boxes_num = boxes3d.shape[0]
    l, h, w = boxes3d[:, 3], boxes3d[:, 4], boxes3d[:, 5]
    x_corners = np.array([l / 2., l / 2., -l / 2., -l / 2.,
                          l / 2., l / 2., -l / 2., -l / 2.], dtype=np.float32).T
    z_corners = np.array([w / 2., -w / 2., -w / 2., w / 2.,
                          w / 2., -w / 2., -w / 2., w / 2.], dtype=np.float32).T
    if bottom_center:
        y_corners = np.zeros((boxes_num, 8), dtype=np.float32)
        y_corners[:, 4:8] = -h.reshape(boxes_num, 1).repeat(4, axis=1)
    else:
        y_corners = np.array([h / 2., h / 2., h / 2., h / 2.,
                              -h / 2., -h / 2., -h / 2., -h / 2.],
                             dtype=np.float32).T
    ry = boxes3d[:, 6]
    zeros, ones = np.zeros(ry.size, dtype=np.float32), np.ones(ry.size, dtype=np.float32)
    rot_list = np.array([[np.cos(ry), zeros, -np.sin(ry)],
                         [zeros, ones, zeros],
                         [np.sin(ry), zeros, np.cos(ry)]])
    R_list = np.transpose(rot_list, (2, 0, 1))
    temp_corners = np.concatenate((
        x_corners.reshape(-1, 8, 1), y_corners.reshape(-1, 8, 1),
        z_corners.reshape(-1, 8, 1)), axis=2)
    rotated_corners = np.matmul(temp_corners, R_list)
    x_loc, y_loc, z_loc = boxes3d[:, 0], boxes3d[:, 1], boxes3d[:, 2]
    x = x_loc.reshape(-1, 1) + rotated_corners[:, :, 0]
    y = y_loc.reshape(-1, 1) + rotated_corners[:, :, 1]
    z = z_loc.reshape(-1, 1) + rotated_corners[:, :, 2]
    return np.concatenate((
        x.reshape(-1, 8, 1), y.reshape(-1, 8, 1), z.reshape(-1, 8, 1)),
        axis=2).astype(np.float32)


def boxes3d_kitti_camera_to_imageboxes(boxes3d, calib, image_shape=None):
    """camera boxes -> (N, 4) [x1, y1, x2, y2] image boxes
    (reference box_utils.py:291-312). Projects through ``calib.rect_to_img``
    (raw rect-z divide), NOT ``corners3d_to_img_boxes`` (homogeneous
    divide incl. P2's (2,3) term) — the two differ by ~0.25 px on real
    KITTI calibrations and the reference eval chain uses the former."""
    corners3d = boxes3d_to_corners3d_kitti_camera(boxes3d)
    pts_img, _ = calib.rect_to_img(corners3d.reshape(-1, 3))
    corners_in_image = pts_img.reshape(-1, 8, 2)
    min_uv = np.min(corners_in_image, axis=1)
    max_uv = np.max(corners_in_image, axis=1)
    boxes2d_image = np.concatenate([min_uv, max_uv], axis=1)
    if image_shape is not None:
        boxes2d_image[:, 0] = np.clip(boxes2d_image[:, 0], a_min=0,
                                      a_max=image_shape[1] - 1)
        boxes2d_image[:, 1] = np.clip(boxes2d_image[:, 1], a_min=0,
                                      a_max=image_shape[0] - 1)
        boxes2d_image[:, 2] = np.clip(boxes2d_image[:, 2], a_min=0,
                                      a_max=image_shape[1] - 1)
        boxes2d_image[:, 3] = np.clip(boxes2d_image[:, 3], a_min=0,
                                      a_max=image_shape[0] - 1)
    return boxes2d_image


def bev_corners_np(boxes3d):
    """(N,7) lidar boxes -> (N,4,2) BEV corner polygons, CCW order (numpy)."""
    dx, dy = boxes3d[:, 3] / 2, boxes3d[:, 4] / 2
    local = np.stack([np.stack([dx, dy], -1), np.stack([-dx, dy], -1),
                      np.stack([-dx, -dy], -1), np.stack([dx, -dy], -1)],
                     axis=1)                                   # (N, 4, 2)
    c, s = np.cos(boxes3d[:, 6]), np.sin(boxes3d[:, 6])
    # row-vector rotation matching rotate_points_along_z: x' = x*c - y*s
    rot = np.stack([np.stack([c, s], -1), np.stack([-s, c], -1)], axis=1)
    return local @ rot + boxes3d[:, None, 0:2]


def _clip_poly_np(subject, clip):
    """Sutherland-Hodgman: clip polygon ``subject`` (S,2) by convex CCW
    ``clip`` (4,2); returns the intersection area (host float64)."""
    out = [subject[i] for i in range(subject.shape[0])]
    for i in range(clip.shape[0]):
        a = clip[i]
        b = clip[(i + 1) % clip.shape[0]]
        edge = b - a
        inp, out = out, []
        if not inp:
            return 0.0
        prev = inp[-1]
        prev_in = edge[0] * (prev[1] - a[1]) - edge[1] * (prev[0] - a[0]) >= 0
        for q in inp:
            q_in = edge[0] * (q[1] - a[1]) - edge[1] * (q[0] - a[0]) >= 0
            if q_in != prev_in:
                d = q - prev
                denom = edge[0] * d[1] - edge[1] * d[0]
                if denom != 0:
                    t = (edge[0] * (a[1] - prev[1])
                         - edge[1] * (a[0] - prev[0])) / denom
                    out.append(prev + t * d)
            if q_in:
                out.append(q)
            prev, prev_in = q, q_in
    if len(out) < 3:
        return 0.0
    poly = np.asarray(out)
    x, y = poly[:, 0], poly[:, 1]
    return float(np.abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))
                 / 2)


def boxes_bev_iou_cpu_np(boxes_a, boxes_b):
    """Exact rotated BEV IoU, pure numpy, for host-side use (dataloader
    workers). Matches the reference's ``boxes_bev_iou_cpu``
    (``pcdet/ops/iou3d_nms/iou3d_nms_utils.py`` -> ``iou3d_cpu.cpp``
    rotated-rectangle polygon clipping). An axis-aligned enclosing-box
    prefilter skips the exact clip for clearly-disjoint pairs."""
    n, m = boxes_a.shape[0], boxes_b.shape[0]
    iou = np.zeros((n, m), np.float32)
    if n == 0 or m == 0:
        return iou
    ca = bev_corners_np(boxes_a.astype(np.float64))
    cb = bev_corners_np(boxes_b.astype(np.float64))
    lo_a, hi_a = ca.min(axis=1), ca.max(axis=1)
    lo_b, hi_b = cb.min(axis=1), cb.max(axis=1)
    overlap = ((lo_a[:, None, 0] <= hi_b[None, :, 0])
               & (hi_a[:, None, 0] >= lo_b[None, :, 0])
               & (lo_a[:, None, 1] <= hi_b[None, :, 1])
               & (hi_a[:, None, 1] >= lo_b[None, :, 1]))
    area_a = (boxes_a[:, 3] * boxes_a[:, 4]).astype(np.float64)
    area_b = (boxes_b[:, 3] * boxes_b[:, 4]).astype(np.float64)
    for i, j in zip(*np.nonzero(overlap)):
        inter = _clip_poly_np(ca[i], cb[j])
        denom = max(area_a[i] + area_b[j] - inter, 1e-6)
        iou[i, j] = inter / denom
    return iou


def in_box_bev_np(points_xy, boxes3d):
    """(N,2) points x (M,7) boxes -> (M,N) bool BEV containment (numpy)."""
    shift = points_xy[None, :, :] - boxes3d[:, None, 0:2]  # (M, N, 2)
    cosa = np.cos(-boxes3d[:, 6])[:, None]
    sina = np.sin(-boxes3d[:, 6])[:, None]
    local_x = shift[..., 0] * cosa - shift[..., 1] * sina
    local_y = shift[..., 0] * sina + shift[..., 1] * cosa
    return (np.abs(local_x) <= boxes3d[:, None, 3] / 2) & \
           (np.abs(local_y) <= boxes3d[:, None, 4] / 2)


def points_in_boxes_np(points, boxes3d):
    """(N, >=3) points x (M, 7) boxes -> (M, N) bool: inside in BEV and
    within half the box's height of its centre (numpy; the gt databases'
    test)."""
    dz = np.abs(points[None, :, 2] - boxes3d[:, None, 2]) <= boxes3d[:, None, 5] / 2
    return in_box_bev_np(points[:, :2], boxes3d) & dz
