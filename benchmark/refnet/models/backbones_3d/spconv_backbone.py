# Frozen at commit c8e3fcd from fv2p_torch/models/backbones_3d/spconv_backbone.py; its table of backbones by name left out (a backbone is found by its file under models/slots/).
"""Sparse 3D backbones (counterpart of
``fv2p_tpu/models/backbones_3d/spconv_backbone.py``).

Both backbones share one topology of levels: x_conv1 (stride 1), three
strided 3x3x3 convs down to x_conv4 (the last with z padding 0), and a
(3, 1, 1) stride (2, 1, 1) conv_out that squashes z. Their neighbour tables
come from one of two places (``Rulebooks``):

* the host (``rulebooks`` in the batch, built per sample by
  ``ops/sparse/host_rulebook.py``): the voxels arrive sorted, every level
  keeps per-sample blocks of fixed capacity;
* the device (``ops/sparse/rulebook.py``), from the voxel coordinates in any
  order: every level is one batch-flat array in key order. The capacities
  are ``level_capacities`` of the batch's whole voxel capacity, as JAX
  derives them, with the yaml's ``LEVEL_CAPACITIES`` (per-sample numbers)
  times the batch size in their place. Each level counts the active rows
  past its capacity, which it drops (``batch_dict['rulebook_overflow']``,
  a device tensor the runners read with their results).

``VoxelResBackBone8x`` (FV2P, MGAF-3DSSD) takes host tables when the batch
has them and builds its own otherwise; ``VoxelBackBone8x`` (SECOND) always
builds its own, as JAX's does.
"""
import torch
from torch import nn

from ...ops.sparse import rulebook
from ...ops.sparse.conv import SparseBasicBlock, SparseConvBNReLU
from ...ops.sparse.host_rulebook import level_capacities, select_mode_caps
from ...ops.sparse.sparse_tensor import from_coords, from_host_coords

LEVELS = ('x_conv1', 'x_conv2', 'x_conv3', 'x_conv4', 'out')
# (source, output, kernel, stride, padding) of the strided layers
DOWNS = (('x_conv1', 'x_conv2', 3, 2, 1), ('x_conv2', 'x_conv3', 3, 2, 1),
         ('x_conv3', 'x_conv4', 3, 2, (0, 1, 1)),
         ('x_conv4', 'out', (3, 1, 1), (2, 1, 1), 0))


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


def input_sparse_tensor(batch_dict, sparse_shape):
    """(B, N_cap, ...) per-sample voxel arrays, in any order -> one
    batch-flat SparseTensor in key order (JAX ``input_sparse_tensor``)."""
    coords = batch_dict['voxel_coords']           # (B, N_cap, 3) (z, y, x)
    feats = batch_dict['voxel_features']          # (B, N_cap, C)
    b, cap = coords.shape[:2]
    batch_col = torch.arange(b, device=coords.device).view(b, 1, 1).expand(b, cap, 1)
    coords4 = torch.cat([batch_col, coords.to(torch.int64)], -1).reshape(b * cap, 4)
    valid = batch_dict.get('voxel_valid')
    if valid is not None:
        valid = valid.reshape(b * cap)
    return from_coords(coords4, feats.reshape(b * cap, -1), sparse_shape, b, valid)


def device_capacities(batch_size, voxel_cap, caps_override, training):
    """Batch-flat level capacities: ``level_capacities`` of the batch's
    voxel capacity, each level the yaml sets (one mode's per-sample rows,
    ``select_mode_caps``) at that number times the batch size."""
    caps = level_capacities(batch_size * voxel_cap)
    sel = select_mode_caps(caps_override, training) if caps_override else None
    if sel:
        caps.update({k: int(v) * batch_size for k, v in sel.items()})
    return caps


class Rulebooks:
    """The levels and tables of one forward: ``input`` (x_conv1 with the
    voxel features), ``subm[lvl]`` (N, 27), ``down[dst]`` (the output level
    without features, nbr, inv), and ``overflow``: the (4,) rows dropped at
    x_conv2..out on the device, None from the host (whose builder raises
    instead of dropping)."""

    @classmethod
    def from_host(cls, batch_dict, shapes):
        rb = batch_dict['rulebooks']
        feats = batch_dict['voxel_features']
        b, cap = feats.shape[0], feats.shape[1]
        self = cls()
        self.input = from_host_coords(batch_dict['voxel_coords'],
                                      batch_dict['voxel_valid'],
                                      feats.reshape(b * cap, -1), shapes['x_conv1'], b)
        caps = {'x_conv1': cap}
        caps.update({k: rb[f'coords_{k}'].shape[1] for k in LEVELS[1:]})
        self.subm = {lvl: _global_table(rb[f'subm_{lvl}'], caps[lvl])
                     for lvl in LEVELS[:4]}
        self.down = {}
        for src, dst, *_ in DOWNS:
            out = from_host_coords(rb[f'coords_{dst}'], rb[f'valid_{dst}'],
                                   feats.new_zeros((b * caps[dst], 0)), shapes[dst], b)
            # the inverse table: for each source row and tap, the output row
            self.down[dst] = (out, _global_table(rb[f'down_{src}->{dst}'], caps[src]),
                              _global_table(rb[f'down_inv_{src}->{dst}'], caps[dst]))
        self.overflow = None
        return self

    @classmethod
    def on_device(cls, batch_dict, shapes, caps_override, training, downs=DOWNS):
        """The tables of the strided layers ``downs`` (a leading part of
        DOWNS) and of their levels, built from the voxels."""
        self = cls()
        st = self.input = input_sparse_tensor(batch_dict, shapes['x_conv1'])
        b, cap = batch_dict['voxel_coords'].shape[:2]
        caps = device_capacities(b, cap, caps_override, training)
        self.subm = {'x_conv1': rulebook.subm_rulebook(st, 3)}
        self.down, dropped = {}, []
        for src, dst, k, s, p in downs:
            out, nbr, inv, drop = rulebook.downsample_rulebook(st, k, s, p, caps[dst])
            self.down[dst] = (out, nbr, inv)
            dropped.append(drop)
            if dst != 'out':
                self.subm[dst] = rulebook.subm_rulebook(out, 3)
            st = out
        self.overflow = torch.stack(dropped)
        return self


class _SparseBackbone(nn.Module):
    """The level shapes, the choice of tables, and the batch dict both
    backbones leave; ``level_channels`` are the channels of the levels in
    ``multi_scale_3d_features``."""
    host_tables = True

    def __init__(self, grid_size, level_caps=None):
        super().__init__()
        self.grid_size = tuple(grid_size)
        self.level_caps = level_caps
        nx, ny, nz = self.grid_size
        self.shapes = {'x_conv1': (nz + 1, ny, nx)}
        for src, dst, k, s, p in DOWNS:
            self.shapes[dst] = rulebook.out_shape(self.shapes[src], k, s, p)

    def rulebooks(self, batch_dict, downs=DOWNS):
        if self.host_tables and batch_dict.get('rulebooks') is not None:
            return Rulebooks.from_host(batch_dict, self.shapes)
        return Rulebooks.on_device(batch_dict, self.shapes, self.level_caps,
                                   self.training, downs)

    @staticmethod
    def _output(batch_dict, levels, out, overflow):
        if overflow is not None:
            batch_dict['rulebook_overflow'] = overflow
        batch_dict.update({
            'encoded_spconv_tensor': out,
            'encoded_spconv_tensor_stride': 8,
            'multi_scale_3d_features': dict(zip(LEVELS[:4], levels)),
            'multi_scale_3d_strides': {
                'x_conv1': 1, 'x_conv2': 2, 'x_conv3': 4, 'x_conv4': 8,
            },
        })
        return batch_dict


class VoxelResBackBone8x(_SparseBackbone):
    """Residual sparse backbone of FV2P: 16 -> (16,16) res -> 32 stride 2 ->
    (32,32) res -> 64 stride 2 -> (64,64) res -> 128 stride 2 pad (0,1,1) ->
    (128,128) res -> conv_out 128, kernel (3,1,1) stride (2,1,1)."""
    level_channels = {'x_conv1': 16, 'x_conv2': 32, 'x_conv3': 64, 'x_conv4': 128}

    def __init__(self, input_channels, grid_size, compute_dtype=None,
                 level_caps=None):
        super().__init__(grid_size, level_caps)
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
        rb = self.rulebooks(batch_dict)
        x = self.conv_input(rb.input, rb.subm['x_conv1'])
        x = self.res1a(x, rb.subm['x_conv1'])
        x_conv1 = self.res1b(x, rb.subm['x_conv1'])
        levels = [x_conv1]
        for i, lvl in ((2, 'x_conv2'), (3, 'x_conv3'), (4, 'x_conv4')):
            x = getattr(self, f'down{i}')(levels[-1], *rb.down[lvl])
            x = getattr(self, f'res{i}a')(x, rb.subm[lvl])
            levels.append(getattr(self, f'res{i}b')(x, rb.subm[lvl]))
        out = self.conv_out(levels[-1], *rb.down['out'])
        return self._output(batch_dict, levels, out, rb.overflow)


class VoxelBackBone8x(_SparseBackbone):
    """Plain sparse backbone of SECOND: subm 16 -> subm 16 -> 32 stride 2 ->
    2 subm 32 -> 64 stride 2 -> 2 subm 64 -> 64 stride 2 pad (0,1,1) -> 2 subm
    64 -> conv_out 128, kernel (3,1,1) stride (2,1,1). It reads no host
    tables: it builds its rulebooks on the device from the voxels."""
    host_tables = False
    level_channels = {'x_conv1': 16, 'x_conv2': 32, 'x_conv3': 64, 'x_conv4': 64}

    def __init__(self, input_channels, grid_size, compute_dtype=None,
                 level_caps=None):
        super().__init__(grid_size, level_caps)
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
        self.conv_out = SparseConvBNReLU(64, 128, (3, 1, 1), 'spconv', cd)

    def forward(self, batch_dict):
        rb = self.rulebooks(batch_dict)
        x = self.conv_input(rb.input, rb.subm['x_conv1'])
        levels = [self.conv1(x, rb.subm['x_conv1'])]
        for i, lvl in ((2, 'x_conv2'), (3, 'x_conv3'), (4, 'x_conv4')):
            x = getattr(self, f'down{i}')(levels[-1], *rb.down[lvl])
            x = getattr(self, f'conv{i}a')(x, rb.subm[lvl])
            levels.append(getattr(self, f'conv{i}b')(x, rb.subm[lvl]))
        out = self.conv_out(levels[-1], *rb.down['out'])
        return self._output(batch_dict, levels, out, rb.overflow)

