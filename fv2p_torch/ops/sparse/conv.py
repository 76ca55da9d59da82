"""Sparse convolution forward + modules (counterpart of
``fv2p_tpu/ops/sparse/conv.py``).

With an output-side gather table the whole conv is

    out[o] = sum_k  in_padded[nbr[o, k]] @ W[k]

one gather and one matmul per layer; the zero pad row at index N_in_cap
makes missing neighbours implicit. Tables are (N_out, K) int64 here (the
transpose of the reference's (K, N_out)), so the gathered rows reshape to
(N_out, K*Cin) without a copy.
"""
import math

import torch
from torch import nn

from ...models.layers import BN_EPS


def sparse_conv_apply(features, nbr, weight, compute_dtype=None):
    """features (N_in_cap, Cin); nbr (N_out, K) int64 in [0, N_in_cap];
    weight (K, Cin, Cout) -> (N_out, Cout) float32."""
    if compute_dtype is not None:
        features = features.to(compute_dtype)
        weight = weight.to(compute_dtype)
    else:
        weight = weight.to(features.dtype)
    k, cin, cout = weight.shape
    pad = torch.cat([features, features.new_zeros((1, cin))], dim=0)
    gathered = pad[nbr].reshape(nbr.shape[0], k * cin)
    return (gathered @ weight.reshape(k * cin, cout)).to(torch.float32)


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

    def _apply_conv(self, features, nbr, out_st):
        feats = sparse_conv_apply(features, nbr, self.kernel,
                                  self.compute_dtype)
        if self.bias is not None:
            feats = feats + self.bias
        feats = feats.masked_fill(~out_st.valid_mask()[:, None], 0.0)
        return out_st.replace(features=feats)


class SubMConv3d(_SparseConvBase):
    """Submanifold sparse conv (output rows == input rows)."""

    def forward(self, st, nbr):
        return self._apply_conv(st.features, nbr, st)


class SparseConv3d(_SparseConvBase):
    """Strided sparse conv onto a precomputed output voxel set."""

    def forward(self, in_st, out_st, nbr):
        return self._apply_conv(in_st.features, nbr, out_st)


class MaskedBatchNorm(nn.Module):
    """Eval BatchNorm1d over voxel rows; invalid rows stay zero."""

    def __init__(self, channels):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer('running_mean', torch.zeros(channels))
        self.register_buffer('running_var', torch.ones(channels))

    def forward(self, x, mask):
        y = ((x - self.running_mean) * torch.rsqrt(self.running_var + BN_EPS)
             * self.weight + self.bias)
        return y.masked_fill(~mask[:, None], 0.0)


class SparseConvBNReLU(nn.Module):
    """conv -> masked BN -> ReLU (``post_act_block``)."""

    def __init__(self, cin, cout, kernel_size=3, conv_type='subm',
                 compute_dtype=None):
        super().__init__()
        cls = {'subm': SubMConv3d, 'spconv': SparseConv3d}[conv_type]
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
