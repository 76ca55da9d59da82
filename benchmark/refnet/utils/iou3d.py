# Frozen at commit c8e3fcd from fv2p_torch/utils/iou3d.py, unchanged.
"""Rotated-box IoU + greedy NMS (counterpart of ``fv2p_tpu/utils/iou3d.py``).

The IoU comes from kernel B1 (``ops/cuda/rotated_iou.py``), which for a
set against itself computes only the pairs i < j that greedy NMS reads; the
greedy suppression is an exact fixed-point iteration over the thresholded
IoU matrix, blocked for long candidate lists so that it stops once
``post_max`` boxes are kept. The iteration runs on the device in rounds of
``_FIXED_POINT_ROUND`` steps, and the host reads one pair of numbers a
round (whether the last step changed anything, and the kept count): those
reads are the only waits on the device in an NMS call.
"""
import torch

from ..ops.cuda.rotated_iou import bev_corners_ccw as _bev_corners_ccw
from ..ops.cuda.rotated_iou import iou_bev, iou_bev_upper, overlap_matrix

_FIXED_POINT_ROUND = 8


def boxes_iou_bev(boxes_a, boxes_b):
    """Rotated BEV IoU (N, M)."""
    return iou_bev(boxes_a, boxes_b)


def boxes_overlap_bev(boxes_a, boxes_b):
    """Rotated BEV intersection areas (N, M) of (N, 7) and (M, 7) boxes,
    through kernel B1's overlap entry point."""
    return overlap_matrix(_bev_corners_ccw(boxes_a), _bev_corners_ccw(boxes_b))


def boxes_iou3d(boxes_a, boxes_b):
    """3D IoU (N, M): the BEV overlap times the overlap of the z extents
    [z - dz/2, z + dz/2], over the union of the volumes (clamped to 1e-6)."""
    overlap_bev = boxes_overlap_bev(boxes_a, boxes_b)
    a_zmin = (boxes_a[:, 2] - boxes_a[:, 5] / 2)[:, None]
    a_zmax = (boxes_a[:, 2] + boxes_a[:, 5] / 2)[:, None]
    b_zmin = (boxes_b[:, 2] - boxes_b[:, 5] / 2)[None, :]
    b_zmax = (boxes_b[:, 2] + boxes_b[:, 5] / 2)[None, :]
    overlap_h = torch.clamp(torch.minimum(a_zmax, b_zmax)
                            - torch.maximum(a_zmin, b_zmin), min=0.0)
    overlap_3d = overlap_bev * overlap_h
    vol_a = (boxes_a[:, 3] * boxes_a[:, 4] * boxes_a[:, 5])[:, None]
    vol_b = (boxes_b[:, 3] * boxes_b[:, 4] * boxes_b[:, 5])[None, :]
    return overlap_3d / torch.clamp(vol_a + vol_b - overlap_3d, min=1e-6)


def _greedy_by_fixed_point(overlap, valid):
    """Exact greedy suppression: keep_i = valid_i and no kept j < i overlaps
    i; ``overlap`` (n, n) is True only above the diagonal. Iterating this map
    from all-valid reaches the greedy solution (box 0 is stable at once; once
    boxes < i are stable, box i is one step later), which is the map's only
    fixed point, so a step that changes nothing ends the search. Returns
    (keep, number kept)."""
    n = overlap.shape[0]
    ov_lower = overlap.to(torch.float32)
    keep = valid
    for _ in range(0, n + 1, _FIXED_POINT_ROUND):    # n + 1 steps suffice
        for _ in range(_FIXED_POINT_ROUND):
            prev = keep
            keep = valid & ~((keep.to(torch.float32) @ ov_lower) > 0)
        changed, n_kept = torch.stack([(keep ^ prev).sum(), keep.sum()]).tolist()
        if not changed:
            break
    return keep, n_kept


def _nms_keep_flags(boxes_s, valid, thresh):
    overlap = iou_bev_upper(boxes_s) > thresh
    overlap = overlap & valid[None, :] & valid[:, None]
    return _greedy_by_fixed_point(overlap, valid)


def _nms_keep_flags_blocked(boxes_s, valid, thresh, post_max, block=1024):
    """Blocked greedy NMS over score-sorted boxes: exact greedy semantics for
    the first post_max kept boxes. Blocks run in score order, each checked
    against the kept buffer and then greedily within itself, until the
    buffer holds post_max boxes; later candidates cannot change the result.
    Returns (keep flags, number kept up to post_max).
    """
    n = boxes_s.shape[0]
    n_blocks = (n + block - 1) // block
    pad = n_blocks * block - n
    boxes_p = torch.nn.functional.pad(boxes_s, (0, 0, 0, pad))
    valid_p = torch.nn.functional.pad(valid, (0, pad))
    kept_boxes = boxes_s.new_zeros((post_max + 1, 7))   # last row: overflow
    kept_cnt = 0
    keep_flags = torch.zeros(n_blocks * block, dtype=torch.bool,
                             device=boxes_s.device)
    for bi in range(n_blocks):
        if kept_cnt >= post_max:
            break
        blk = boxes_p[bi * block:(bi + 1) * block]
        blk_ok = valid_p[bi * block:(bi + 1) * block]
        if kept_cnt:
            sup_x = (boxes_iou_bev(blk, kept_boxes[:kept_cnt]) > thresh).any(dim=1)
            blk_ok = blk_ok & ~sup_x
        ov = iou_bev_upper(blk) > thresh
        ov = ov & blk_ok[None, :] & blk_ok[:, None]
        blk_keep, blk_kept = _greedy_by_fixed_point(ov, blk_ok)

        pos = kept_cnt + torch.cumsum(blk_keep.to(torch.int64), 0) - 1
        slot = torch.where(blk_keep & (pos < post_max), pos, post_max)
        kept_boxes.index_copy_(0, slot, blk)
        kept_cnt = min(kept_cnt + blk_kept, post_max)
        keep_flags[bi * block:(bi + 1) * block] = blk_keep
    return keep_flags[:n], kept_cnt


def nms_rotated(boxes, scores, thresh, pre_max=4096, post_max=500):
    """Greedy rotated NMS on score-sorted boxes (the reference ``nms_gpu``).

    boxes (N, 7), scores (N,); invalid entries carry -inf scores. Returns
    keep_idx (post_max,) int64 indices into the inputs, ordered by score,
    and keep_valid (post_max,) bool.
    """
    boxes = boxes.detach()
    scores = scores.detach()
    n = min(pre_max, boxes.shape[0])
    # stable descending sort: equal scores keep the lower index first
    top_scores, order = torch.sort(scores, descending=True, stable=True)
    top_scores, order = top_scores[:n], order[:n]
    boxes_s = boxes[order]
    valid = top_scores > float('-inf')

    if n > 2048:
        keep, n_kept = _nms_keep_flags_blocked(boxes_s, valid, thresh, post_max)
    else:
        keep, n_kept = _nms_keep_flags(boxes_s, valid, thresh)

    kpos = torch.cumsum(keep.to(torch.int64), 0) - 1
    slot = torch.where(keep & (kpos < post_max), kpos, post_max)
    keep_idx = torch.zeros(post_max + 1, dtype=torch.int64, device=boxes.device)
    keep_idx = keep_idx.index_copy_(0, slot, order)[:post_max]
    keep_valid = torch.arange(post_max, device=boxes.device) < min(n_kept, post_max)
    return keep_idx, keep_valid


def points_in_rotated_boxes(points, boxes):
    """(N, 3) points x (M, 7) boxes -> (M, N) bool containment (z about the
    box center)."""
    shift = points[None, :, :3] - boxes[:, None, 0:3]     # (M, N, 3)
    cosa = torch.cos(-boxes[:, 6])[:, None]
    sina = torch.sin(-boxes[:, 6])[:, None]
    local_x = shift[..., 0] * cosa - shift[..., 1] * sina
    local_y = shift[..., 0] * sina + shift[..., 1] * cosa
    return ((local_x.abs() <= boxes[:, None, 3] / 2)
            & (local_y.abs() <= boxes[:, None, 4] / 2)
            & (shift[..., 2].abs() <= boxes[:, None, 5] / 2))
