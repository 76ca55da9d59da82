"""Sparse convolution forward and backward + modules (counterpart of
``fv2p_tpu/ops/sparse/conv.py``).

With an output-side gather table the whole conv is

    out[o] = sum_k  in_padded[nbr[o, k]] @ W[k]

one gather and one matmul per layer; the zero pad row at index N_in_cap
makes missing neighbours implicit. Tables are (N_out, K) int64 here (the
transpose of the reference's (K, N_out)), so the gathered rows reshape to
(N_out, K*Cin) without a copy.

The backward is JAX's scatter-free one (``_sparse_conv_core``'s custom VJP):
with the inverse table inv (N_in, K), which for input row i and tap k names
the output row that i feeds (the zero row N_out where none),

    dW[k]   = gathered[:, k]^T @ dout
    dfeat[i] = sum_k  dout_padded[inv[i, k]] @ W[k]^T

two gathers and two matmuls, no scatter-add. A submanifold layer's inverse
table is its forward table with the taps mirrored; a strided layer's comes
from the host rulebook (``down_inv_*``) or the device builder. The inverse
conv of a strided layer (UNetV2's decoder) runs that layer's two tables
swapped. ``sparse_maxpool`` and ``sparse_group`` gather through a table
without a matmul.
"""
import math

import torch
from torch import nn

from ...models.layers import BN_EPS, update_running_
from ...utils import tracing


def _pad_row(x):
    return torch.cat([x, x.new_zeros((1, x.shape[1]))], dim=0)


def _conv_fwd(features, weight, nbr):
    k, cin, cout = weight.shape
    with tracing.span('slot:sparse_conv.gather'):
        gathered = _pad_row(features)[nbr].reshape(nbr.shape[0], k * cin)
    return (gathered @ weight.reshape(k * cin, cout)).to(torch.float32)


class _SparseConvFn(torch.autograd.Function):
    """(features (N_in, Cin), weight (K, Cin, Cout), nbr (N_out, K),
    inv (N_in, K) or None) -> (N_out, Cout) float32, with the gather-matmul
    backward; inv None is a submanifold layer's, nbr with its taps mirrored,
    made only when the backward runs. As in JAX, the incoming gradient is
    cast to the features' type and both gradients come back in their
    operand's type."""

    @staticmethod
    def forward(ctx, features, weight, nbr, inv):
        ctx.save_for_backward(features, weight, nbr, inv)
        return _conv_fwd(features, weight, nbr)

    @staticmethod
    def backward(ctx, dout):
        features, weight, nbr, inv = ctx.saved_tensors
        k, cin, cout = weight.shape
        dfeat = dw = None
        with tracing.span('phase:sparse_conv.backward'):
            if inv is None:
                inv = nbr.flip(1)
            dout = dout.to(features.dtype)
            if ctx.needs_input_grad[1]:
                with tracing.span('phase:sparse_conv.backward.gather'):
                    gathered = _pad_row(features)[nbr].reshape(nbr.shape[0], k * cin)
                dw = (gathered.t() @ dout).reshape(k, cin, cout).to(weight.dtype)
            if ctx.needs_input_grad[0]:
                with tracing.span('phase:sparse_conv.backward.gather'):
                    gd = _pad_row(dout)[inv].reshape(inv.shape[0], k * cout)
                wt = weight.transpose(1, 2).reshape(k * cout, cin)
                dfeat = (gd @ wt).to(features.dtype)
        return dfeat, dw, None, None


def sparse_conv_apply(features, nbr, weight, compute_dtype=None, inv=None):
    """features (N_in_cap, Cin); nbr (N_out, K) int64 in [0, N_in_cap];
    weight (K, Cin, Cout) -> (N_out, Cout) float32. ``inv`` (N_in_cap, K) is
    the inverse table of a strided layer; None means a submanifold layer
    (N_out == N_in_cap, the taps mirrored)."""
    if compute_dtype is not None:
        features = features.to(compute_dtype)
        weight = weight.to(compute_dtype)
    else:
        weight = weight.to(features.dtype)
    return _SparseConvFn.apply(features, weight, nbr, inv)


class _SparseConvBase(nn.Module):
    def __init__(self, cin, cout, kernel_size=3, use_bias=False,
                 compute_dtype=None):
        super().__init__()
        ks = kernel_size if isinstance(kernel_size, (tuple, list)) \
            else (kernel_size,) * 3
        k = math.prod(ks)
        self.kernel = nn.Parameter(torch.zeros(k, cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout)) if use_bias else None
        self.compute_dtype = compute_dtype

    def _apply_conv(self, features, nbr, out_st, inv=None):
        with tracing.span('slot:sparse_conv'):
            feats = sparse_conv_apply(features, nbr, self.kernel,
                                      self.compute_dtype, inv)
            if self.bias is not None:
                feats = feats + self.bias
            feats = feats.masked_fill(~out_st.valid_mask()[:, None], 0.0)
        return out_st.replace(features=feats)


class SubMConv3d(_SparseConvBase):
    """Submanifold sparse conv (output rows == input rows); its inverse
    table is the forward table with the taps mirrored (the kernel's offsets
    are symmetric)."""

    def forward(self, st, nbr):
        return self._apply_conv(st.features, nbr, st)


class SparseConv3d(_SparseConvBase):
    """Strided sparse conv onto a precomputed output voxel set; ``inv`` is
    the host rulebook's inverse table."""

    def forward(self, in_st, out_st, nbr, inv):
        return self._apply_conv(in_st.features, nbr, out_st, inv)


class SparseInverseConv3d(_SparseConvBase):
    """Inverse (transposed) sparse conv of a strided layer: from that
    layer's output level back onto its source level's rows. It is the
    strided conv with the two tables swapped: the strided layer's inverse
    table (N_src, K) gathers, its forward table (N_down, K) is the backward's
    inverse table; each tap keeps its weight index."""

    def forward(self, down_st, out_st, inv_table, fwd_table):
        return self._apply_conv(down_st.features, inv_table, out_st, fwd_table)


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d over voxel rows; invalid rows stay zero. In training the
    statistics are those of the valid rows, mean then variance in two
    passes, and update the running ones as flax's BatchNorm does."""

    def __init__(self, channels):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer('running_mean', torch.zeros(channels))
        self.register_buffer('running_var', torch.ones(channels))

    def forward(self, x, mask):
        if self.training:
            m = mask.to(torch.float32)[:, None]
            n = torch.clamp(m.sum(), min=1.0)
            xf = x.to(torch.float32)
            mean = (xf * m).sum(dim=0) / n
            var = ((xf - mean) ** 2 * m).sum(dim=0) / n
            update_running_(self.running_mean, self.running_var, mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean) * torch.rsqrt(var + BN_EPS) * self.weight + self.bias
        return y.masked_fill(~mask[:, None], 0.0)


class SparseConvBNReLU(nn.Module):
    """conv -> masked BN -> ReLU (``post_act_block``)."""

    def __init__(self, cin, cout, kernel_size=3, conv_type='subm',
                 compute_dtype=None):
        super().__init__()
        cls = {'subm': SubMConv3d, 'spconv': SparseConv3d,
               'inverseconv': SparseInverseConv3d}[conv_type]
        self.conv = cls(cin, cout, kernel_size, compute_dtype=compute_dtype)
        self.bn = MaskedBatchNorm(cout)

    def forward(self, st, *rulebook_args):
        st = self.conv(st, *rulebook_args)
        return st.replace(features=torch.relu(
            self.bn(st.features, st.valid_mask())))


class SparseBasicBlock(nn.Module):
    """Residual block of two subm convs sharing the level's table."""

    def __init__(self, channels, compute_dtype=None):
        super().__init__()
        self.conv1 = SubMConv3d(channels, channels, 3, use_bias=True,
                                compute_dtype=compute_dtype)
        self.bn1 = MaskedBatchNorm(channels)
        self.conv2 = SubMConv3d(channels, channels, 3, use_bias=True,
                                compute_dtype=compute_dtype)
        self.bn2 = MaskedBatchNorm(channels)

    def forward(self, st, nbr):
        identity = st.features
        mask = st.valid_mask()
        out = self.conv1(st, nbr)
        out = out.replace(features=torch.relu(self.bn1(out.features, mask)))
        out = self.conv2(out, nbr)
        f = torch.relu(self.bn2(out.features, mask) + identity)
        return out.replace(features=f.masked_fill(~mask[:, None], 0.0))


def sparse_maxpool(features, nbr):
    """Sparse max pooling over a table (JAX ``sparse_maxpool``): output row
    o is the max over the taps of the rows ``nbr[o]`` names; a row no input
    reaches is 0. features (N_in_cap, C), nbr (N_out, K) -> (N_out, C)."""
    neg = features.new_full((1, features.shape[1]), float('-inf'))
    out = torch.cat([features, neg], dim=0)[nbr].amax(dim=1)
    return out.masked_fill(torch.isneginf(out), 0.0)


def sparse_group(features, nbr):
    """The neighbourhood of every output row without a conv (JAX
    ``sparse_group``): (N_out, K, C), zeros at missing taps (JAX's is the
    transpose, (K, N_out, C), as its tables are)."""
    return _pad_row(features)[nbr]
