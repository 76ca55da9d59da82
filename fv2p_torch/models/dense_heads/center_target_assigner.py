"""CenterNet target assignment on the device (counterpart of
``fv2p_tpu/models/dense_heads/center_target_assigner.py``).

Each scan's targets are fixed-shape: per-object rows padded to
``MAX_OBJS`` and (H, W, C) maps at the head's stride. The objects are
handled at once rather than in JAX's sequential loop; the result is the
loop's: the heat map takes the max of the Gaussians, the segmentation map
is 1 wherever any object's quad covers a cell, and the height map holds the
z of the last such object (later objects overwrite)."""
from functools import partial

import torch

from ...utils import box_utils, center_utils


def _quad_mask(h, w, corners_xy):
    """(M, 4, 2) convex quads of corner pixel coordinates -> (M, H, W) bool
    masks of the cells inside (a cross product of at least -1e-6 counts);
    the winding comes from the sign of twice the signed area, 0 counting as
    counter-clockwise."""
    ys, xs = center_utils.pixel_grid(h, w, corners_xy.device)
    x, y = corners_xy[..., 0], corners_xy[..., 1]
    area2 = (x * torch.roll(y, -1, dims=-1) - torch.roll(x, -1, dims=-1) * y).sum(-1)
    sgn = torch.where(area2 >= 0, 1.0, -1.0)[:, None, None]
    inside = torch.ones((corners_xy.shape[0], h, w), dtype=torch.bool,
                        device=corners_xy.device)
    for e in range(4):
        p1 = corners_xy[:, e]
        p2 = corners_xy[:, (e + 1) % 4]
        cross = ((p2[:, 0] - p1[:, 0])[:, None, None] * (ys - p1[:, 1][:, None, None])
                 - (p2[:, 1] - p1[:, 1])[:, None, None] * (xs - p1[:, 0][:, None, None]))
        inside = inside & (cross * sgn >= -1e-6)
    return inside


def assign_single(gt_boxes, gt_classes, *, num_classes, max_objs, fm_h, fm_w,
                  voxel_size, pc_range, stride, min_overlap, min_radius):
    """One scan's targets. gt_boxes (M, 7), gt_classes (M,) integer with 0
    for padding. An object counts if its class is > 0, its row is not all
    zero, its size on the map is positive and its rounded center (half to
    even) lies on the map. Returns the dict of ``CenterTargetAssigner``
    without the batch axis."""
    m = min(gt_boxes.shape[0], max_objs)
    gt_boxes, gt_classes = gt_boxes[:m], gt_classes[:m]
    vx, vy = float(voxel_size[0]), float(voxel_size[1])
    x0, y0 = float(pc_range[0]), float(pc_range[1])

    obj_valid = (gt_classes > 0) & (gt_boxes.abs().sum(1) > 0)
    dimx_fm = gt_boxes[:, 3] / vx / stride
    dimy_fm = gt_boxes[:, 4] / vy / stride
    radius = center_utils.gaussian_radius(torch.ceil(dimx_fm), torch.ceil(dimy_fm),
                                          min_overlap)
    radius = torch.clamp(torch.floor(radius), min=float(min_radius))
    size_ok = (dimx_fm > 0) & (dimy_fm > 0)

    coor_x = (gt_boxes[:, 0] - x0) / vx / stride
    coor_y = (gt_boxes[:, 1] - y0) / vy / stride
    ct = torch.stack([coor_x, coor_y], dim=1)
    ct_int = torch.round(ct)                     # half to even, as jnp.round
    in_range = ((ct_int[:, 0] >= 0) & (ct_int[:, 0] < fm_w)
                & (ct_int[:, 1] >= 0) & (ct_int[:, 1] < fm_h))
    use = obj_valid & size_ok & in_range

    ct_i = ct_int.to(torch.int64)
    ind = torch.where(use, fm_w * ct_i[:, 1] + ct_i[:, 0], 0)
    mask = use.to(torch.float32)
    anno_box = torch.cat([ct - ct_int, gt_boxes[:, 2:7]], dim=1) * mask[:, None]
    xsys = ct_int * mask[:, None]
    src_box = gt_boxes[:, :7] * mask[:, None]

    # BEV corner pixel coordinates for the segmentation and height rasters
    corners = box_utils.boxes_to_corners_3d(gt_boxes)[:, 0:4, 0:2]
    cx = torch.clamp(corners[..., 0], x0, float(pc_range[3]))
    cy = torch.clamp(corners[..., 1], y0, float(pc_range[4]))
    corner_px = torch.round(torch.stack(
        [(cx - x0) / vx / stride, (cy - y0) / vy / stride], dim=-1))

    cls_idx = torch.clamp(gt_classes - 1, 0, num_classes - 1).to(torch.int64)
    splats = center_utils.gaussian_splats(ct_int, radius, use, fm_h, fm_w)
    hm = torch.zeros((num_classes, fm_h * fm_w), dtype=torch.float32,
                     device=gt_boxes.device)
    hm = hm.scatter_reduce(0, cls_idx[:, None].expand(-1, fm_h * fm_w),
                           splats.view(m, -1), 'amax')
    fg = _quad_mask(fm_h, fm_w, corner_px) & use[:, None, None]
    order = torch.arange(m, device=gt_boxes.device)[:, None, None]
    last = torch.where(fg, order, -1).amax(dim=0)            # (H, W)
    segm = (last >= 0).to(torch.float32)
    height = torch.where(last >= 0, gt_boxes[last.clamp(min=0), 2], 0.0)

    def pad(a):
        return torch.nn.functional.pad(a, [0, 0] * (a.dim() - 1) + [0, max_objs - m])

    return {
        'hm_target': hm.view(num_classes, fm_h, fm_w).permute(1, 2, 0),
        'anno_box_target': pad(anno_box),
        'ind_target': pad(ind),
        'mask_target': pad(mask),
        'segm_target': segm[..., None],
        'height_target': height[..., None],
        'src_box_target': pad(src_box),
        'xsys_target': pad(xsys),
    }


class CenterTargetAssigner:
    """Targets of a batch: ``assign_targets(gt (B, M, 8))``, gt rows
    [x, y, z, dx, dy, dz, heading, class], each scan by ``assign_single``
    and stacked; ``batch_gtboxes_src`` is the gt itself."""

    def __init__(self, model_cfg, num_classes, voxel_size, point_cloud_range):
        tc = model_cfg.TARGET_ASSIGNER_CONFIG
        self.num_classes = int(num_classes)
        self.max_objs = int(tc.MAX_OBJS)
        self.min_overlap = float(tc.GAUSSIAN_MINOVERLAP)
        self.min_radius = int(tc.GAUSSIAN_MINRADIUS)
        self.stride = int(tc.FEATURE_MAP_STRIDE)
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.pc_range = tuple(float(v) for v in point_cloud_range)
        self.fm_h = int(round((self.pc_range[4] - self.pc_range[1])
                              / self.voxel_size[1] / self.stride))
        self.fm_w = int(round((self.pc_range[3] - self.pc_range[0])
                              / self.voxel_size[0] / self.stride))

    def assign_targets(self, gt_boxes_with_classes):
        fn = partial(
            assign_single, num_classes=self.num_classes, max_objs=self.max_objs,
            fm_h=self.fm_h, fm_w=self.fm_w, voxel_size=self.voxel_size,
            pc_range=self.pc_range, stride=self.stride,
            min_overlap=self.min_overlap, min_radius=self.min_radius)
        per_scan = [fn(gt[:, :7], gt[:, 7].to(torch.int64))
                    for gt in gt_boxes_with_classes]
        out = {k: torch.stack([s[k] for s in per_scan]) for k in per_scan[0]}
        out['batch_gtboxes_src'] = gt_boxes_with_classes
        return out
