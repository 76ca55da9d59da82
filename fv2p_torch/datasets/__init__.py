"""Dataset package. Exposes the meta derivation used by model building."""
import numpy as np


def dataset_meta_from_cfg(data_cfg, split='train'):
    """Static model-construction metadata from a DATA_CONFIG: grid and voxel
    size, point cloud range, point features and the voxel capacity."""
    pc_range = np.array(data_cfg.POINT_CLOUD_RANGE, np.float32)
    voxel_size = None
    voxel_caps = None
    max_ppv = 0
    for proc in data_cfg.DATA_PROCESSOR:
        if proc.NAME == 'transform_points_to_voxels':
            voxel_size = np.array(proc.VOXEL_SIZE, np.float32)
            voxel_caps = proc.MAX_NUMBER_OF_VOXELS
            max_ppv = int(proc.MAX_POINTS_PER_VOXEL)
    if voxel_size is None:
        # point-only pipelines: nominal 0.05 m grid for the modules that
        # consume voxel_size/grid_size metadata
        voxel_size = np.array([0.05, 0.05, 0.1], np.float32)
        voxel_caps = {split: 0}
    grid_size = np.round((pc_range[3:6] - pc_range[0:3]) / voxel_size).astype(int)
    num_point_features = len(data_cfg.POINT_FEATURE_ENCODING['used_feature_list'])
    return {
        'grid_size': tuple(int(g) for g in grid_size),  # (nx, ny, nz)
        'voxel_size': tuple(float(v) for v in voxel_size),
        'point_cloud_range': tuple(float(v) for v in pc_range),
        'num_point_features': num_point_features,
        'voxel_capacity': int(voxel_caps[split]),
        'max_points_per_voxel': max_ppv,
    }
