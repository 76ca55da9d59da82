"""Point-neighbour cross-attention pooling (counterpart of
``fv2p_tpu/ops/transformer_pool.py``; reference
``pcdet/ops/pointnet2/pointnet2_stack/voxel_pool_trans_modules.py:167-284``,
``PointNeighborTransformer`` + ``TransformerDecoderLayerPreNorm``).

No shipped config uses it. Each grid point (the query) cross-attends over
its grouped voxel neighbours (the memory), with one xyz positional-encoding
MLP shared by both, a pre-norm decoder layer without self-attention, and a
final projection. The attention is plain tensor code: the projections,
the scaled scores, a softmax in f32 and the weighted sum, as flax's
``MultiHeadDotProductAttention`` computes them; the JAX package has no
Pallas kernel here. Module names follow flax's, so
``weights.load_flax_variables`` maps the trees one to one (the attention's
``query``/``key``/``value`` kernels (E, H, D) and ``out`` (H, D, E) stay in
flax's layout, ``layers.DenseGeneral``).

Dropout (``drop`` > 0, train mode only) draws from the ``torch.Generator``
passed to the forward, not from JAX's keys.
"""
import math

import torch
from torch import nn

from ..models.layers import BatchNorm, Dense, DenseGeneral, Dropout, LayerNorm


class _PosEnc(nn.Module):
    """Linear (no bias) -> BatchNorm over every row -> ReLU -> Linear, on
    xyz (reference ``self.pe``). In training each call normalises by its own
    rows and updates the running statistics, so the target's call and then
    the memory's update them in that order, as flax's do."""

    def __init__(self, out_channels):
        super().__init__()
        self.fc1 = Dense(3, out_channels // 2, bias=False)
        self.bn = BatchNorm(out_channels // 2)
        self.fc2 = Dense(out_channels // 2, out_channels)

    def forward(self, xyz):
        return self.fc2(torch.relu(self.bn(self.fc1(xyz))))


class MultiHeadDotProductAttention(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention`` (no mask, no qk norm): the
    query scaled by 1 / sqrt(D), the scores' softmax in f32, and in training
    at a rate above 0 a dropout of the weights shared over the batch and the
    heads (flax's ``broadcast_dropout``)."""

    def __init__(self, in_q, in_kv, num_heads, qkv_features, out_features, dropout=0.0):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = qkv_features // num_heads
        heads = (num_heads, self.head_dim)
        self.query = DenseGeneral((in_q,), heads)
        self.key = DenseGeneral((in_kv,), heads)
        self.value = DenseGeneral((in_kv,), heads)
        self.out = DenseGeneral(heads, (out_features,))
        self.rate = float(dropout)

    def forward(self, q, kv, generator=None):
        query = self.query(q) / math.sqrt(self.head_dim)       # (..., L1, H, D)
        key, value = self.key(kv), self.value(kv)              # (..., L2, H, D)
        scores = torch.einsum('...qhd,...khd->...hqk', query, key)
        weights = torch.softmax(scores.to(torch.float32), dim=-1)
        if self.training and self.rate > 0.0:
            keep_prob = 1.0 - self.rate
            keep = torch.rand(weights.shape[-2:], generator=generator,
                              device=weights.device) < keep_prob
            weights = torch.where(keep, weights / keep_prob, 0.0)
        return self.out(torch.einsum('...hqk,...khd->...qhd', weights, value))


class TransformerDecoderLayerPreNorm(nn.Module):
    """Pre-norm cross-attention + FFN, each with a residual (reference
    :167-224; no self-attention): tgt (M, L1, E), memory (M, L2, E_mem)."""

    def __init__(self, d_model, nc_mem, nhead=4, dim_feedforward=128, dropout=0.0):
        super().__init__()
        self.norm2 = LayerNorm(d_model)
        self.norm_mem = LayerNorm(nc_mem)
        self.multihead_attn = MultiHeadDotProductAttention(
            d_model, nc_mem, nhead, d_model, d_model, dropout)
        self.norm3 = LayerNorm(d_model)
        self.linear1 = Dense(d_model, dim_feedforward)
        self.linear2 = Dense(dim_feedforward, d_model)
        self.dropout = Dropout(dropout)

    def forward(self, tgt, memory, generator=None):
        mem = self.norm_mem(memory)
        tgt = tgt + self.multihead_attn(self.norm2(tgt), mem, generator)
        h = torch.relu(self.linear1(self.norm3(tgt)))
        h = self.dropout(h, generator)
        return tgt + self.linear2(h)


class PointNeighborTransformer(nn.Module):
    """xyz_tgt (M, 3) grid points, xyz_mem (M, N_mem, 3) their neighbours,
    features_tgt (M, dim_in), features_mem (M, N_mem, dim_feature) ->
    (M, 1, dim_out). The positional encoding is added to the memory's
    features too, so dim_feature must equal dim_in (as in the reference)."""

    def __init__(self, dim_in, dim_out, nhead=4, num_layers=1, drop=0.0, dim_feature=32):
        super().__init__()
        self.num_layers = num_layers
        self.pe = _PosEnc(dim_in)
        for i in range(num_layers):
            setattr(self, f'layer{i}', TransformerDecoderLayerPreNorm(
                d_model=dim_in, nc_mem=dim_feature, nhead=nhead,
                dim_feedforward=2 * dim_in, dropout=drop))
        self.fc = Dense(dim_in, dim_out)

    def forward(self, xyz_tgt, xyz_mem, features_tgt, features_mem, generator=None):
        tgt = features_tgt[:, None, :] + self.pe(xyz_tgt[:, None, :])
        mem = features_mem + self.pe(xyz_mem)
        for i in range(self.num_layers):
            tgt = getattr(self, f'layer{i}')(tgt, mem, generator)
        return self.fc(tgt)
