"""UNetV2, PartA2's sparse UNet (counterpart of
``fv2p_tpu/models/backbones_3d/spconv_unet.py``).

The encoder is ``VoxelBackBone8x``'s (16-32-64-64, ``conv_out`` 128), on
the same levels and tables (``spconv_backbone.Rulebooks``, from the host or
the device). The decoder climbs back to x_conv1: at each level a residual
block over the lateral features, the bottom features concatenated with
its output, a submanifold conv plus a skip that sums adjacent channel
pairs of the concatenation, then an inverse conv onto the level above
through the strided layer's tables swapped (``SparseInverseConv3d``).

``point_features`` (B, cap, 16) are the top level's features and
``point_coords`` the voxel centres, in per-sample blocks of the voxel
capacity, padding rows parked at 1e4 so that they fall in no box;
``point_valid`` marks the real rows. With host tables the level is already
laid out so. With device tables it is one batch-flat array in key order,
and each sample's rows are moved into its block. (JAX reshapes the
batch-flat array as it stands, so that a block there holds the tail of
one sample and the head of the next: ROADMAP C12.)
"""
import torch
from torch import nn

from ...ops.sparse.conv import SparseBasicBlock, SparseConvBNReLU
from ...ops.sparse.sparse_tensor import decode_keys
from ...utils import common_utils
from .spconv_backbone import DOWNS, LEVELS, _SparseBackbone


class UNetV2(_SparseBackbone):
    level_channels = {'x_conv1': 16, 'x_conv2': 32, 'x_conv3': 64, 'x_conv4': 64}
    num_point_features = 16

    def __init__(self, model_cfg, input_channels, grid_size, voxel_size,
                 point_cloud_range, compute_dtype=None):
        super().__init__(grid_size, model_cfg.get('LEVEL_CAPACITIES'))
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        self.return_encoded = bool(model_cfg.get('RETURN_ENCODED_TENSOR', True))
        cd = compute_dtype
        self.conv_input = SparseConvBNReLU(input_channels, 16, 3, 'subm', cd)
        self.conv1 = SparseConvBNReLU(16, 16, 3, 'subm', cd)
        self.down2 = SparseConvBNReLU(16, 32, 3, 'spconv', cd)
        self.conv2a = SparseConvBNReLU(32, 32, 3, 'subm', cd)
        self.conv2b = SparseConvBNReLU(32, 32, 3, 'subm', cd)
        self.down3 = SparseConvBNReLU(32, 64, 3, 'spconv', cd)
        self.conv3a = SparseConvBNReLU(64, 64, 3, 'subm', cd)
        self.conv3b = SparseConvBNReLU(64, 64, 3, 'subm', cd)
        self.down4 = SparseConvBNReLU(64, 64, 3, 'spconv', cd)
        self.conv4a = SparseConvBNReLU(64, 64, 3, 'subm', cd)
        self.conv4b = SparseConvBNReLU(64, 64, 3, 'subm', cd)
        if self.return_encoded:
            self.conv_out = SparseConvBNReLU(64, 128, (3, 1, 1), 'spconv', cd)
        # decoder: (name, channels, channels of the inverse conv's output)
        for name, ch, out_ch in (('up4', 64, 64), ('up3', 64, 32), ('up2', 32, 16),
                                 ('up1', 16, None)):
            setattr(self, f'{name}_t', SparseBasicBlock(ch, cd))
            setattr(self, f'{name}_m', SparseConvBNReLU(2 * ch, ch, 3, 'subm', cd))
            if out_ch is not None:
                setattr(self, f'{name}_inv', SparseConvBNReLU(ch, out_ch, 3, 'inverseconv', cd))
        self.conv5 = SparseConvBNReLU(16, 16, 3, 'subm', cd)

    def _ur_block(self, name, lateral, bottom, subm, inv=None):
        """conv_t, then concat(bottom, trans) -> conv_m plus the skip that
        sums channel pairs (2c, 2c + 1) of the concatenation, then the
        inverse conv ``inv`` = (level above, its down tables) if given."""
        trans = getattr(self, f'{name}_t')(lateral, subm)
        cat = torch.cat([bottom.features, trans.features], dim=-1)
        x_m = getattr(self, f'{name}_m')(trans.replace(features=cat), subm)
        red = cat.reshape(cat.shape[0], -1, 2).sum(dim=2)
        x = x_m.replace(features=x_m.features + red)
        if inv is None:
            return x
        above, (_, nbr, inv_table) = inv
        return getattr(self, f'{name}_inv')(x, above, inv_table, nbr)

    def forward(self, batch_dict):
        rb = self.rulebooks(batch_dict, DOWNS if self.return_encoded else DOWNS[:3])
        x = self.conv_input(rb.input, rb.subm['x_conv1'])
        levels = [self.conv1(x, rb.subm['x_conv1'])]
        for i, lvl in ((2, 'x_conv2'), (3, 'x_conv3'), (4, 'x_conv4')):
            x = getattr(self, f'down{i}')(levels[-1], *rb.down[lvl])
            x = getattr(self, f'conv{i}a')(x, rb.subm[lvl])
            levels.append(getattr(self, f'conv{i}b')(x, rb.subm[lvl]))
        x_conv1, x_conv2, x_conv3, x_conv4 = levels
        if self.return_encoded:
            batch_dict['encoded_spconv_tensor'] = self.conv_out(x_conv4, *rb.down['out'])
            batch_dict['encoded_spconv_tensor_stride'] = 8
        if rb.overflow is not None:
            batch_dict['rulebook_overflow'] = rb.overflow

        sub = rb.subm
        x_up4 = self._ur_block('up4', x_conv4, x_conv4, sub['x_conv4'],
                               (x_conv3, rb.down['x_conv4']))
        x_up3 = self._ur_block('up3', x_conv3, x_up4, sub['x_conv3'],
                               (x_conv2, rb.down['x_conv3']))
        x_up2 = self._ur_block('up2', x_conv2, x_up3, sub['x_conv2'],
                               (x_conv1, rb.down['x_conv2']))
        x_up1 = self._ur_block('up1', x_conv1, x_up2, sub['x_conv1'])
        x_up1 = self.conv5(x_up1, sub['x_conv1'])

        batch_dict['multi_scale_3d_features'] = dict(
            zip(LEVELS[:4], (x_up2, x_up3, x_up4, x_conv4)))
        batch_dict['multi_scale_3d_strides'] = {
            'x_conv1': 1, 'x_conv2': 2, 'x_conv3': 4, 'x_conv4': 8}
        batch_dict.update(self._point_outputs(x_up1, batch_dict['voxel_coords'].shape[:2]))
        return batch_dict

    def _point_outputs(self, st, batch_cap):
        """The top level's rows in per-sample blocks: features (B, cap, C),
        voxel centres (B, cap, 3) with padding at 1e4, and the valid mask."""
        b, cap = batch_cap
        valid = st.valid_mask()
        feats = st.features
        coords = decode_keys(st.keys, st.spatial_shape)            # (N, 4) b, z, y, x
        if st.sample_cap == 0:
            # batch-flat, key order: sample s's k-th row goes to s * cap + k
            n = valid.shape[0]
            sample = torch.where(valid, coords[:, 0], b)
            counts = torch.bincount(sample, minlength=b + 1)[:b]
            starts = torch.cumsum(counts, 0) - counts
            rows = torch.arange(n, device=valid.device)
            dest = torch.where(valid, sample * cap + rows - starts[sample.clamp(max=b - 1)],
                               b * cap)
            src = torch.full((b * cap + 1,), n, dtype=torch.int64, device=valid.device)
            src[dest] = rows
            src = src[:b * cap]
            pad = torch.cat([feats, feats.new_zeros((1, feats.shape[1]))], dim=0)
            feats = pad[src]
            coords = torch.cat([coords, coords.new_zeros((1, 4))], dim=0)[src]
            valid = torch.cat([valid, valid.new_zeros((1,))], dim=0)[src]
        centers = common_utils.get_voxel_centers(coords[:, 1:4], 1, self.voxel_size,
                                                 self.point_cloud_range)
        centers = torch.where(valid[:, None], centers, torch.full_like(centers, 1e4))
        return {'point_features': feats.reshape(b, cap, -1),
                'point_coords': centers.reshape(b, cap, 3),
                'point_valid': valid.reshape(b, cap)}
