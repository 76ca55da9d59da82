"""The ``BACKBONE_3D`` slot ``VoxelResBackBone8x`` (its host tables: the
shared topology of ``host_rulebook.backbone_spec``)."""
from ..backbones_3d.spconv_backbone import VoxelResBackBone8x


def build(det):
    cfg, meta = det.model_cfg.BACKBONE_3D, det.dataset_meta
    return VoxelResBackBone8x(meta['num_point_features'], meta['grid_size'],
                              det.compute_dtype, level_caps=cfg.get('LEVEL_CAPACITIES'))
