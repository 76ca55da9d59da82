"""The ``MAP_TO_BEV`` slot ``HeightCompression``."""
from ..backbones_2d.map_to_bev.height_compression import HeightCompression


def build(det):
    return HeightCompression()
