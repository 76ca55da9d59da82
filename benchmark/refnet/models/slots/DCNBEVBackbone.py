"""The ``BACKBONE_2D`` slot ``DCNBEVBackbone``."""
from ..backbones_2d.base_bev_backbone import DCNBEVBackbone


def build(det):
    cfg = det.model_cfg
    return DCNBEVBackbone(cfg.BACKBONE_2D, int(cfg.MAP_TO_BEV.NUM_BEV_FEATURES),
                          det.compute_dtype)
