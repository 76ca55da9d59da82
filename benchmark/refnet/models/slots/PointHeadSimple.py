"""The ``POINT_HEAD`` slot ``PointHeadSimple``, on the decoder's point
features."""
from ..dense_heads.point_head_simple import PointHeadSimple


def build(det):
    cfg = det.model_cfg
    return PointHeadSimple(cfg.POINT_HEAD, int(cfg.POST_PFE.OUT_BLOCK.OUT_CHANNELS),
                           det.num_class, det.compute_dtype)
