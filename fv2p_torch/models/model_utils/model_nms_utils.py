"""Per-sample NMS entry points (counterpart of
``fv2p_tpu/models/model_utils/model_nms_utils.py``), on the port's rotated
NMS and so on kernel B1 for a CUDA tensor. Fixed shapes, as JAX's: each
returns (post_max,) rows and a validity mask in place of ragged lists."""
import torch

from ...utils import iou3d, tracing


def _nms(box_preds, nms_scores, nms_config):
    pre = int(min(nms_config.NMS_PRE_MAXSIZE, box_preds.shape[0]))
    with tracing.span('slot:post_processing.nms'):
        return iou3d.nms_rotated(box_preds[:, :7], nms_scores, float(nms_config.NMS_THRESH),
                                 pre_max=pre, post_max=int(nms_config.NMS_POST_MAXSIZE))


def _thresholded(scores, thresh):
    if thresh is None:
        return scores
    return torch.where(scores >= thresh, scores, float('-inf'))


def class_agnostic_nms(box_scores, box_preds, nms_config, score_thresh=None):
    """box_scores (N,), box_preds (N, 7+) -> (kept rows (post_max,) int64,
    their scores, 0 where not valid, valid (post_max,) bool)."""
    keep_idx, keep_valid = _nms(box_preds, _thresholded(box_scores, score_thresh),
                                nms_config)
    return keep_idx, torch.where(keep_valid, box_scores[keep_idx], 0.0), keep_valid


def class_agnostic_nms_withfgscore(box_fgscores, box_locscores, box_preds,
                                   nms_config, fgscore_thresh=None):
    """Filter by the foreground (class) score, rank by the localisation
    (IoU) score: (kept rows, their locscores, valid)."""
    scores = box_locscores
    if fgscore_thresh is not None:
        scores = torch.where(box_fgscores >= fgscore_thresh, box_locscores,
                             float('-inf'))
    keep_idx, keep_valid = _nms(box_preds, scores, nms_config)
    return keep_idx, torch.where(keep_valid, box_locscores[keep_idx], 0.0), keep_valid


def multi_classes_nms(cls_scores, box_preds, nms_config, score_thresh=None):
    """One NMS per class: cls_scores (N, C), box_preds (N, 7+) shared by the
    classes or (N, C, 7+) per class -> boxes (C*post, 7+), scores (C*post,),
    labels (C*post,) 1-based, valid (C*post,)."""
    n, c = cls_scores.shape
    post = int(nms_config.NMS_POST_MAXSIZE)
    scores = _thresholded(cls_scores, score_thresh)
    boxes, sel_scores, valid = [], [], []
    for ci in range(c):
        bx = box_preds[:, ci] if box_preds.dim() == 3 else box_preds
        keep_idx, keep_valid = _nms(bx, scores[:, ci], nms_config)
        boxes.append(bx[keep_idx])
        sel_scores.append(torch.where(keep_valid, cls_scores[keep_idx, ci], 0.0))
        valid.append(keep_valid)
    labels = torch.arange(1, c + 1, dtype=torch.int32, device=cls_scores.device)
    return (torch.cat(boxes), torch.cat(sel_scores),
            labels.repeat_interleave(post), torch.cat(valid))
