"""Mean voxel feature encoder (counterpart of
``fv2p_tpu/models/backbones_3d/vfe/mean_vfe.py``)."""
from torch import nn


class MeanVFE(nn.Module):
    """Per-voxel mean over the (padded) points of each voxel."""

    def forward(self, batch_dict):
        voxels = batch_dict['voxels']                    # (B, N_cap, P, C)
        num_points = batch_dict['voxel_num_points']      # (B, N_cap)
        normalizer = num_points.clamp(min=1).to(voxels.dtype)[..., None]
        batch_dict['voxel_features'] = voxels.sum(dim=-2) / normalizer
        return batch_dict
