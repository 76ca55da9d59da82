"""The ``POST_PFE`` slot ``ResidualVoxelToPointDecoder``."""
from ..backbones_3d.pfe.residual_v2p_decoder import ResidualVoxelToPointDecoder


def build(det):
    meta = det.dataset_meta
    return ResidualVoxelToPointDecoder(det.model_cfg.POST_PFE, tuple(meta['voxel_size']),
                                       tuple(meta['point_cloud_range']), det.compute_dtype)
