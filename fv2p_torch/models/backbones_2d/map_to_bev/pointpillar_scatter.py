"""Pillar features onto the dense BEV canvas (counterpart of
``fv2p_tpu/models/backbones_2d/map_to_bev/pointpillar_scatter.py``):
channels-last ``spatial_features`` (B, ny, nx, C), zero where no pillar
is."""
import torch
from torch import nn


class PointPillarScatter(nn.Module):
    def __init__(self, grid_size):
        super().__init__()
        self.nx, self.ny = int(grid_size[0]), int(grid_size[1])

    def forward(self, batch_dict):
        feats = batch_dict['pillar_features']             # (B, N, C)
        coords = batch_dict['voxel_coords']               # (B, N, 3) (z, y, x)
        valid = batch_dict['voxel_valid']
        b, n, c = feats.shape
        cells = self.ny * self.nx
        # invalid pillars land on one extra cell per sample, dropped after
        flat = coords[..., 1].long() * self.nx + coords[..., 2].long()
        flat = flat.masked_fill(~valid, cells)
        flat = flat + (cells + 1) * torch.arange(b, device=feats.device)[:, None]
        canvas = feats.new_zeros((b * (cells + 1), c))
        canvas.index_copy_(0, flat.reshape(-1), feats.reshape(b * n, c))
        canvas = canvas.view(b, cells + 1, c)[:, :cells]
        batch_dict['spatial_features'] = canvas.reshape(b, self.ny, self.nx, c)
        batch_dict['spatial_features_stride'] = 1
        return batch_dict

