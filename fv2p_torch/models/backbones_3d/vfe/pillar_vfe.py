"""Pillar feature encoder (counterpart of
``fv2p_tpu/models/backbones_3d/vfe/pillar_vfe.py``): a PointNet over each
pillar's decorated points (xyz + intensity, the offset from the pillar's
point mean, the offset from the pillar's center in x and y), max-pooled
over the pillar's points.

The numerics are JAX's: in training a PFN layer's BatchNorm takes its
statistics over all N x P point slots, padded ones included, and the mask
applies only after the ReLU."""
import torch
from torch import nn

from ...layers import BatchNorm, Dense


class PFNLayer(nn.Module):
    """Linear (+ BatchNorm) + ReLU over (N, P, C) points, then the max over
    the valid points; a layer that is not the last concatenates the max to
    every point."""

    def __init__(self, in_channels, out_channels, use_norm=True, last_layer=False):
        super().__init__()
        self.last_layer = last_layer
        out_ch = out_channels if last_layer else out_channels // 2
        self.linear = Dense(in_channels, out_ch, bias=not use_norm)
        self.norm = BatchNorm(out_ch) if use_norm else None

    def forward(self, inputs, mask):
        x = self.linear(inputs)
        if self.norm is not None:
            s = x.shape
            x = self.norm(x.reshape(-1, s[-1])).reshape(s)
        x = torch.relu(x)
        x = x.masked_fill(~mask[..., None], -1e9)
        x_max = x.amax(dim=1, keepdim=True)
        if self.last_layer:
            return x_max[:, 0]
        return torch.cat([x.masked_fill(~mask[..., None], 0.0),
                          x_max.expand_as(x)], dim=-1)


class PillarVFE(nn.Module):
    def __init__(self, model_cfg, num_point_features, voxel_size, point_cloud_range):
        super().__init__()
        self.model_cfg = model_cfg
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.point_cloud_range = tuple(float(v) for v in point_cloud_range)
        self.use_absolute_xyz = model_cfg.get(
            'USE_ABSLOTE_XYZ', model_cfg.get('USE_ABSOLUTE_XYZ', True)) is not False
        self.with_distance = bool(model_cfg.get('WITH_DISTANCE', False))
        cin = num_point_features + 5 - (0 if self.use_absolute_xyz else 3)
        cin += int(self.with_distance)
        filters = list(model_cfg.NUM_FILTERS)
        use_norm = model_cfg.get('USE_NORM', True)
        for i, ch in enumerate(filters):
            setattr(self, f'pfn{i}', PFNLayer(cin, ch, use_norm,
                                              last_layer=i == len(filters) - 1))
            cin = ch
        self.n_layers = len(filters)

    def forward(self, batch_dict):
        voxels = batch_dict['voxels']                     # (B, N, P, C)
        num_points = batch_dict['voxel_num_points']       # (B, N)
        coords = batch_dict['voxel_coords']               # (B, N, 3) (z, y, x)
        b, n, p, _ = voxels.shape
        mask = torch.arange(p, device=voxels.device) < num_points[..., None]
        pts_sum = voxels[..., :3].sum(dim=2, keepdim=True)
        denom = num_points.clamp(min=1).to(voxels.dtype)[..., None, None]
        f_cluster = voxels[..., :3] - pts_sum / denom

        vx, vy = self.voxel_size[0], self.voxel_size[1]
        x0, y0 = self.point_cloud_range[0], self.point_cloud_range[1]
        cx = coords[..., 2:3].to(voxels.dtype) * vx + (vx / 2 + x0)
        cy = coords[..., 1:2].to(voxels.dtype) * vy + (vy / 2 + y0)
        f_center = torch.stack([voxels[..., 0] - cx, voxels[..., 1] - cy], dim=-1)

        feats = [voxels if self.use_absolute_xyz else voxels[..., 3:],
                 f_cluster, f_center]
        if self.with_distance:
            feats.append(torch.linalg.vector_norm(voxels[..., :3], dim=-1, keepdim=True))
        x = torch.cat(feats, dim=-1).masked_fill(~mask[..., None], 0.0)
        x = x.reshape(b * n, p, -1)
        m = mask.reshape(b * n, p)
        for i in range(self.n_layers):
            x = getattr(self, f'pfn{i}')(x, m)
        batch_dict['pillar_features'] = x.reshape(b, n, -1)
        batch_dict['voxel_features'] = batch_dict['pillar_features']
        return batch_dict
