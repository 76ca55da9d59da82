"""The ``VFE`` slot ``MeanVFE``."""
from ..backbones_3d.vfe.mean_vfe import MeanVFE


def build(det):
    return MeanVFE()
