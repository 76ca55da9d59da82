"""Voxel R-CNN's RoI head (counterpart of
``fv2p_tpu/models/roi_heads/voxelrcnn_head.py``).

``PVRCNNHead``'s proposals, targets, grid and heads (``RoIGridHead``),
pooling straight from the sparse levels of ROI_GRID_POOL.FEATURES_SOURCE:
each level's features through its PRE_MLP (Linear + BatchNorm over all of
the level's rows + ReLU), then grouped around the grid points from the
level's voxel centers at each radius of POOL_LAYERS. As in JAX a radius
search over the voxel centers stands for the reference's voxel-query hash
walk, and QUERY_RANGES is not read. The loss is ``pvrcnn_head_loss``."""
import torch

from ...ops.sparse.sparse_tensor import sample_row_bounds
from ...utils import common_utils, tracing
from ..backbones_3d.pfe.voxel_set_abstraction import add_msg_mlps, msg_pool
from ..layers import BatchNorm, Dense
from .pvrcnn_head import RoIGridHead, pvrcnn_head_loss

voxelrcnn_head_loss = pvrcnn_head_loss


class VoxelRCNNHead(RoIGridHead):
    """``level_channels``: the backbone's channels per sparse level."""

    def __init__(self, model_cfg, num_class, point_cloud_range, voxel_size,
                 level_channels):
        pool_cfg = model_cfg.ROI_GRID_POOL
        sources = list(pool_cfg.FEATURES_SOURCE)
        layers = {s: pool_cfg.POOL_LAYERS[s] for s in sources}
        mlps = {s: tuple(tuple(int(c) for c in m) for m in layers[s].MLPS) for s in sources}
        super().__init__(model_cfg, num_class,
                         sum(m[-1] for s in sources for m in mlps[s]))
        self.point_cloud_range = tuple(point_cloud_range)
        self.voxel_size = tuple(voxel_size)
        self.sources, self.mlps = sources, mlps
        self.radii = {s: tuple(float(x) for x in layers[s].POOL_RADIUS) for s in sources}
        self.nsamples = {s: tuple(int(x) for x in layers[s].NSAMPLE) for s in sources}
        self.pre_mlp = bool(pool_cfg.get('PRE_MLP', False))
        for s in sources:
            ch = int(level_channels[s])
            if self.pre_mlp:
                setattr(self, f'pre_mlp_{s}', Dense(ch, ch, False))
                setattr(self, f'pre_bn_{s}', BatchNorm(ch))
            add_msg_mlps(self, f'{s}_', ch, mlps[s])

    def pool(self, batch_dict, grid):
        ms = batch_dict['multi_scale_3d_features']
        strides = batch_dict['multi_scale_3d_strides']
        # every level's sample bounds in one read of the card
        bounds = torch.stack([sample_row_bounds(ms[s]) for s in self.sources]).tolist()
        tracing.count('host_reads.voxelrcnn_head.sample_bounds')
        pooled = []
        for s, lb in zip(self.sources, bounds):
            st = ms[s]
            centers = common_utils.get_voxel_centers(
                st.coords()[:, 1:4], strides[s], self.voxel_size, self.point_cloud_range)
            feats = st.features
            if self.pre_mlp:
                feats = torch.relu(getattr(self, f'pre_bn_{s}')(
                    getattr(self, f'pre_mlp_{s}')(feats)))
            pooled.append(msg_pool(self, f'{s}_', self.mlps[s], self.radii[s],
                                   self.nsamples[s], grid, centers, st.valid_mask(), feats, lb))
        return torch.cat(pooled, dim=-1)
