"""3D box geometry (reference ``pcdet/utils/box_utils.py``). Boxes are
(N, 7): [x, y, z, dx, dy, dz, heading] with (x, y, z) the box center and
heading a CCW rotation about +z."""
import math

import torch

from .common_utils import device_constant, rotate_points_along_z

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
