"""Sparse 3D backbone (counterpart of
``fv2p_tpu/models/backbones_3d/spconv_backbone.py``, host-rulebook branch).

The voxel arrays arrive sorted in key order with their neighbour tables
built on the host (``ops/sparse/host_rulebook.py``); the device does no
integer bookkeeping. Every level keeps per-sample blocks of fixed capacity.
"""
import torch
from torch import nn

from ...ops.sparse.conv import SparseBasicBlock, SparseConvBNReLU
from ...ops.sparse.host_rulebook import _out_shape
from ...ops.sparse.sparse_tensor import from_host_coords


def _global_table(t, in_cap):
    """(B, K, cap_out) sample-local rows (-1 = missing) -> (B*cap_out, K)
    int64 rows into the source level (per-sample block size in_cap), with
    missing neighbours at the zero row B*in_cap. An inverse table (B, K,
    cap_in) of rows into the output level turns the same way, with in_cap
    the output level's block size."""
    nb = t.shape[0]
    off = torch.arange(nb, device=t.device).view(nb, 1, 1) * in_cap
    t = t.to(torch.int64)
    g = torch.where(t >= 0, t + off, nb * in_cap)
    return g.permute(0, 2, 1).reshape(-1, t.shape[1])


class VoxelResBackBone8x(nn.Module):
    """Residual sparse backbone of FV2P: 16 -> (16,16) res -> 32 stride 2 ->
    (32,32) res -> 64 stride 2 -> (64,64) res -> 128 stride 2 pad (0,1,1) ->
    (128,128) res -> conv_out 128, kernel (3,1,1) stride (2,1,1)."""

    def __init__(self, input_channels, grid_size, compute_dtype=None):
        super().__init__()
        self.grid_size = tuple(grid_size)
        cd = compute_dtype
        self.conv_input = SparseConvBNReLU(input_channels, 16, 3, 'subm', cd)
        self.res1a = SparseBasicBlock(16, cd)
        self.res1b = SparseBasicBlock(16, cd)
        self.down2 = SparseConvBNReLU(16, 32, 3, 'spconv', cd)
        self.res2a = SparseBasicBlock(32, cd)
        self.res2b = SparseBasicBlock(32, cd)
        self.down3 = SparseConvBNReLU(32, 64, 3, 'spconv', cd)
        self.res3a = SparseBasicBlock(64, cd)
        self.res3b = SparseBasicBlock(64, cd)
        self.down4 = SparseConvBNReLU(64, 128, 3, 'spconv', cd)
        self.res4a = SparseBasicBlock(128, cd)
        self.res4b = SparseBasicBlock(128, cd)
        self.conv_out = SparseConvBNReLU(128, 128, (3, 1, 1), 'spconv', cd)

    def forward(self, batch_dict):
        nx, ny, nz = self.grid_size
        s1 = (nz + 1, ny, nx)
        s2 = _out_shape(s1, 3, 2, 1)
        s3 = _out_shape(s2, 3, 2, 1)
        s4 = _out_shape(s3, 3, 2, (0, 1, 1))
        s5 = _out_shape(s4, (3, 1, 1), (2, 1, 1), 0)

        rb = batch_dict.get('rulebooks')
        if rb is None:
            raise NotImplementedError(
                'fv2p_torch builds sparse rulebooks on the host only: attach '
                'them with ops.sparse.host_rulebook.prepare_batch_rulebooks')
        feats = batch_dict['voxel_features']
        b, cap = feats.shape[0], feats.shape[1]
        st = from_host_coords(batch_dict['voxel_coords'],
                              batch_dict['voxel_valid'],
                              feats.reshape(b * cap, -1), s1, b)
        caps = {'x_conv1': cap}
        caps.update({k: rb[f'coords_{k}'].shape[1]
                     for k in ('x_conv2', 'x_conv3', 'x_conv4', 'out')})

        def out_level(lvl, shape):
            return from_host_coords(rb[f'coords_{lvl}'], rb[f'valid_{lvl}'],
                                    feats.new_zeros((b * caps[lvl], 0)),
                                    shape, b)

        def subm(lvl):
            return _global_table(rb[f'subm_{lvl}'], caps[lvl])

        def down(src, dst):
            """The strided layer's forward table and, for its backward, the
            inverse table: for each source row and tap, the output row."""
            return (_global_table(rb[f'down_{src}->{dst}'], caps[src]),
                    _global_table(rb[f'down_inv_{src}->{dst}'], caps[dst]))

        nbr1 = subm('x_conv1')
        x = self.conv_input(st, nbr1)
        x = self.res1a(x, nbr1)
        x_conv1 = self.res1b(x, nbr1)

        x = self.down2(x_conv1, out_level('x_conv2', s2),
                       *down('x_conv1', 'x_conv2'))
        nbr2 = subm('x_conv2')
        x = self.res2a(x, nbr2)
        x_conv2 = self.res2b(x, nbr2)

        x = self.down3(x_conv2, out_level('x_conv3', s3),
                       *down('x_conv2', 'x_conv3'))
        nbr3 = subm('x_conv3')
        x = self.res3a(x, nbr3)
        x_conv3 = self.res3b(x, nbr3)

        x = self.down4(x_conv3, out_level('x_conv4', s4),
                       *down('x_conv3', 'x_conv4'))
        nbr4 = subm('x_conv4')
        x = self.res4a(x, nbr4)
        x_conv4 = self.res4b(x, nbr4)

        out = self.conv_out(x_conv4, out_level('out', s5),
                            *down('x_conv4', 'out'))

        batch_dict.update({
            'encoded_spconv_tensor': out,
            'encoded_spconv_tensor_stride': 8,
            'multi_scale_3d_features': {
                'x_conv1': x_conv1, 'x_conv2': x_conv2,
                'x_conv3': x_conv3, 'x_conv4': x_conv4,
            },
            'multi_scale_3d_strides': {
                'x_conv1': 1, 'x_conv2': 2, 'x_conv3': 4, 'x_conv4': 8,
            },
        })
        return batch_dict
