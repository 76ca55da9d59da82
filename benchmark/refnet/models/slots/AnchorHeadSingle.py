"""The ``DENSE_HEAD`` slot ``AnchorHeadSingle``."""
from ..backbones_2d.base_bev_backbone import out_channels
from ..dense_heads.anchor_head import AnchorHeadSingle


def build(det):
    cfg, meta = det.model_cfg.DENSE_HEAD, det.dataset_meta
    return AnchorHeadSingle(cfg, out_channels(det.model_cfg.BACKBONE_2D), det.num_class,
                            meta['grid_size'], meta['point_cloud_range'])
