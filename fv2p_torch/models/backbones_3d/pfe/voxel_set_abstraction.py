"""Voxel set abstraction for PV-RCNN (counterpart of
``fv2p_tpu/models/backbones_3d/pfe/voxel_set_abstraction.py``).

Farthest-point samples NUM_KEYPOINTS keypoints from each scan's raw points
(kernel B2), then gives each keypoint the features of every source in
FEATURES_SOURCE: bilinear samples of the BEV map (``bev``, HeightCompression's
``spatial_features``), and multi-scale grouping of the raw points
(``raw_points``) and of each sparse level's voxel centers (``x_conv1`` ..
``x_conv4``). Concatenated in JAX's order (bev, raw_points, then the levels
in config order) they are ``point_features_before_fusion``; a Linear +
BatchNorm + ReLU fuses them into ``point_features``.

The grouping finds each query's first NSAMPLE rows within a radius as
JAX's dense search does, but over each sample's own rows in query chunks
(``pointops.ball_query_rows``): JAX broadcasts a batch-flat level to every
sample and masks the other samples' rows, which at full width is a
distance matrix of several GB.
"""
import torch
from torch import nn

from ....ops import pointops
from ....ops.sparse.sparse_tensor import sample_row_bounds
from ....utils import common_utils, tracing
from ...layers import BatchNorm, Dense


def add_msg_mlps(owner, prefix, in_channels, mlps):
    """The MLPs of a multi-scale grouping on ``owner``, one per radius,
    named as flax names them: ``{prefix}mlp{i}_{j}`` (Dense without bias)
    and ``{prefix}bn{i}_{j}``. Each reads 3 + ``in_channels``: the relative
    xyz, then the features."""
    for i, layers in enumerate(mlps):
        ch = 3 + int(in_channels)
        for j, out in enumerate(layers):
            setattr(owner, f'{prefix}mlp{i}_{j}', Dense(ch, int(out), False))
            setattr(owner, f'{prefix}bn{i}_{j}', BatchNorm(int(out)))
            ch = int(out)


def msg_pool(owner, prefix, mlps, radii, nsamples, query, xyz, valid, feats, bounds):
    """Multi-scale grouping through ``owner``'s MLPs (``add_msg_mlps``):
    query (B, M, 3); xyz (N, 3), valid (N,), feats (N, C) of the whole
    batch, sample b's rows ``[bounds[b], bounds[b + 1])`` -> (B, M,
    sum(mlp[-1])), per radius the max over the ball's slots of
    Dense -> BatchNorm over the (B * M * S) rows -> ReLU."""
    idxs = pointops.ball_query_rows(query, xyz, valid, bounds, radii, nsamples)
    outs = []
    for i, idx in enumerate(idxs):
        gx, gf, _ = pointops.group_rows(query, xyz, feats, idx)
        g = torch.cat([gx, gf], dim=-1)
        for j in range(len(mlps[i])):
            g = getattr(owner, f'{prefix}mlp{i}_{j}')(g)
            g = torch.relu(getattr(owner, f'{prefix}bn{i}_{j}')(g))
        outs.append(g.amax(dim=2))
    return torch.cat(outs, dim=-1)


class StackSAModuleMSG(nn.Module):
    """Multi-scale grouping around the keypoints from one source."""

    def __init__(self, sa_cfg, in_channels):
        super().__init__()
        self.radii = tuple(float(r) for r in sa_cfg.POOL_RADIUS)
        self.nsamples = tuple(int(n) for n in sa_cfg.NSAMPLE)
        self.mlps = tuple(tuple(int(c) for c in m) for m in sa_cfg.MLPS)
        self.out_channels = sum(m[-1] for m in self.mlps)
        add_msg_mlps(self, '', in_channels, self.mlps)

    def forward(self, query, xyz, valid, feats, bounds):
        return msg_pool(self, '', self.mlps, self.radii, self.nsamples, query, xyz,
                        valid, feats, bounds)


class VoxelSetAbstraction(nn.Module):
    """``level_channels`` gives the backbone's channels per sparse level,
    ``num_bev_features`` the BEV map's, ``num_point_features`` the raw
    points' (xyz first)."""

    def __init__(self, model_cfg, voxel_size, point_cloud_range, num_bev_features,
                 num_point_features, level_channels):
        super().__init__()
        self.model_cfg = model_cfg
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        self.num_keypoints = int(model_cfg.NUM_KEYPOINTS)
        sources = list(model_cfg.FEATURES_SOURCE)
        self.levels = [s for s in sources if s not in ('bev', 'raw_points')]
        width = int(num_bev_features) if 'bev' in sources else 0
        if 'raw_points' in sources:
            self.sa_rawpoints = StackSAModuleMSG(model_cfg.SA_LAYER['raw_points'],
                                                 int(num_point_features) - 3)
            width += self.sa_rawpoints.out_channels
        for name in self.levels:
            sa = StackSAModuleMSG(model_cfg.SA_LAYER[name], level_channels[name])
            setattr(self, f'sa_{name}', sa)
            width += sa.out_channels
        self.num_point_features_before_fusion = width
        self.num_point_features = int(model_cfg.NUM_OUTPUT_FEATURES)
        self.fusion_fc = Dense(width, self.num_point_features, False)
        self.fusion_bn = BatchNorm(self.num_point_features)

    def forward(self, batch_dict):
        sources = self.model_cfg.FEATURES_SOURCE
        points = batch_dict['points']
        points_valid = batch_dict['points_valid']
        b, n = points_valid.shape
        kp_idx = pointops.farthest_point_sample_batch(points[..., :3], points_valid,
                                                      self.num_keypoints)
        keypoints = torch.gather(points[..., :3], 1, kp_idx[..., None].expand(-1, -1, 3))

        feats = []
        if 'bev' in sources:
            bev = batch_dict['spatial_features']                 # (B, H, W, C)
            stride = batch_dict['spatial_features_stride']
            vx, vy = self.voxel_size[0], self.voxel_size[1]
            x0, y0 = self.point_cloud_range[0], self.point_cloud_range[1]
            xi = (keypoints[..., 0] - x0) / vx / stride
            yi = (keypoints[..., 1] - y0) / vy / stride
            feats.append(torch.stack([pointops.bilinear_interpolate_bev(bev[i], xi[i], yi[i])
                                      for i in range(b)]).float())
        if 'raw_points' in sources:
            feats.append(self.sa_rawpoints(
                keypoints, points[..., :3].reshape(b * n, 3), points_valid.reshape(b * n),
                points[..., 3:].reshape(b * n, -1), [i * n for i in range(b + 1)]))

        ms = batch_dict.get('multi_scale_3d_features', {})
        strides = batch_dict.get('multi_scale_3d_strides', {})
        # every level's sample bounds in one read of the card
        bounds = torch.stack([sample_row_bounds(ms[name]) for name in self.levels]).tolist() \
            if self.levels else []
        if self.levels:
            tracing.count('host_reads.voxel_set_abstraction.sample_bounds')
        for name, lb in zip(self.levels, bounds):
            st = ms[name]
            centers = common_utils.get_voxel_centers(
                st.coords()[:, 1:4], strides[name], self.voxel_size, self.point_cloud_range)
            feats.append(getattr(self, f'sa_{name}')(keypoints, centers, st.valid_mask(),
                                                      st.features, lb))

        before_fusion = torch.cat(feats, dim=-1)                 # (B, K, C_in)
        x = torch.relu(self.fusion_bn(self.fusion_fc(before_fusion)))
        batch_dict['point_features_before_fusion'] = before_fusion
        batch_dict['point_features'] = x
        batch_dict['point_coords'] = keypoints
        return batch_dict
