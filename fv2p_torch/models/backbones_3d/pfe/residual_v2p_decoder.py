"""Residual voxel-to-point decoder (counterpart of
``fv2p_tpu/models/backbones_3d/pfe/residual_v2p_decoder.py``).

Farthest-point samples keypoints from the raw points (kernel B2), then
decodes the sparse backbone's multi-scale voxel features onto them: per
level, voxel centers -> 3-NN inverse-distance interpolation (kernel B3) ->
residual MLP block."""
import torch
from torch import nn

from ....ops import pointops
from ....utils import common_utils
from ...layers import BatchNorm, Dense


class _ResMLPBlock(nn.Module):
    """relu(net(interp) + down(identity)), each branch Dense + BN."""

    def __init__(self, lateral_channels, identity_channels, out_channels,
                 compute_dtype=None):
        super().__init__()
        cd = compute_dtype
        self.net0 = Dense(lateral_channels, out_channels, False, cd)
        self.net_bn0 = BatchNorm(out_channels)
        self.net1 = Dense(out_channels, out_channels, False, cd)
        self.net_bn1 = BatchNorm(out_channels)
        self.down = Dense(identity_channels, out_channels, False, cd)
        self.down_bn = BatchNorm(out_channels)

    def forward(self, residual, identity):
        x = torch.relu(self.net_bn0(self.net0(residual)))
        x = self.net_bn1(self.net1(x))
        idn = self.down_bn(self.down(identity))
        return torch.relu(x + idn)


def _interpolate_level(st, downsample_times, voxel_size, pc_range, keypoints):
    """3-NN interpolate one sparse level's features onto keypoints (B, K, 3).
    Returns (B, K, C).

    Host-rulebook levels hold per-sample blocks of ``st.sample_cap`` rows,
    so each sample's search runs over its own block. A batch-flat level
    (device rulebooks) is searched whole for every sample with the other
    samples' rows masked, as JAX's ``vmap`` of the masked search does: the
    indices are rows of the level, so the features are gathered from the
    level as it is, never copied per sample."""
    b = keypoints.shape[0]
    centers = common_utils.get_voxel_centers(
        st.coords()[:, 1:4], downsample_times, voxel_size, pc_range)
    valid = st.valid_mask()
    if st.sample_cap > 0 and st.batch_size == b:
        cap = st.sample_cap
        return pointops.three_nn_interpolate(
            centers.reshape(b, cap, 3), valid.reshape(b, cap),
            st.features.reshape(b, cap, -1), keypoints)
    if st.sample_cap > 0 or st.batch_size != b:
        raise ValueError(f'a level of {st.batch_size} samples for {b} keypoint sets')
    n = centers.shape[0]
    own = valid[None, :] & (st.coords()[None, :, 0]
                            == torch.arange(b, device=valid.device)[:, None])
    return pointops.three_nn_interpolate_flat(
        centers.expand(b, n, 3), own, st.features, keypoints)


class ResidualVoxelToPointDecoder(nn.Module):
    def __init__(self, model_cfg, voxel_size, point_cloud_range,
                 compute_dtype=None):
        super().__init__()
        if model_cfg.POINT_SOURCE != 'raw_points':
            raise NotImplementedError(model_cfg.POINT_SOURCE)
        self.model_cfg = model_cfg
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        # channel plan: a level's lateral width is its backbone width
        lateral = {'x_conv1': 16, 'x_conv2': 32, 'x_conv3': 64, 'x_conv4': 128}
        ch = lateral[model_cfg.INIT_BLOCK.SOURCE]
        self.sources = [s for s in model_cfg.FEATURES_SOURCE
                        if s not in ('bev', 'raw_points')]
        for src in self.sources:
            out_ch = int(model_cfg.DECODE_BLOCKS[src].OUT_CHANNELS)
            setattr(self, f'decode_{src}', _ResMLPBlock(
                lateral[src], ch, out_ch, compute_dtype))
            ch = out_ch
        out_ch = int(model_cfg.OUT_BLOCK.OUT_CHANNELS)
        self.out_fc = Dense(ch, out_ch, False, compute_dtype)
        self.out_bn = BatchNorm(out_ch)

    def forward(self, batch_dict):
        num_kp = int(self.model_cfg.NUM_KEYPOINTS)
        points = batch_dict['points']                       # (B, P, 3+)
        kp_idx = pointops.farthest_point_sample_batch(
            points[..., :3], batch_dict['points_valid'], num_kp)
        keypoints = torch.gather(points[..., :3], 1,
                                 kp_idx[..., None].expand(-1, -1, 3))
        b = keypoints.shape[0]
        ms = batch_dict['multi_scale_3d_features']
        strides = batch_dict['multi_scale_3d_strides']

        interpolated = {}

        def interp(src):
            """A level's features on the keypoints, computed once: the
            published config names one level both as INIT_BLOCK.SOURCE and
            as the first of FEATURES_SOURCE."""
            if src not in interpolated:
                interpolated[src] = _interpolate_level(
                    ms[src], strides[src], self.voxel_size,
                    self.point_cloud_range, keypoints)
            return interpolated[src]

        feats = interp(self.model_cfg.INIT_BLOCK.SOURCE)
        for src in self.sources:
            lateral = interp(src)
            feats = getattr(self, f'decode_{src}')(
                lateral.reshape(-1, lateral.shape[-1]),
                feats.reshape(-1, feats.shape[-1])).reshape(b, num_kp, -1)

        out = torch.relu(self.out_bn(self.out_fc(feats.reshape(b * num_kp, -1))))
        batch_dict['point_features'] = out.reshape(b, num_kp, -1)
        batch_dict['point_coords'] = keypoints
        return batch_dict
