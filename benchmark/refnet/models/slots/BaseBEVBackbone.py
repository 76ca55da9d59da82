"""The ``BACKBONE_2D`` slot ``BaseBEVBackbone``."""
from ..backbones_2d.base_bev_backbone import BaseBEVBackbone


def build(det):
    cfg = det.model_cfg
    return BaseBEVBackbone(cfg.BACKBONE_2D, int(cfg.MAP_TO_BEV.NUM_BEV_FEATURES),
                           det.compute_dtype)
