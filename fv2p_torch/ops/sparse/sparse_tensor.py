"""Fixed-capacity sparse voxel tensor (counterpart of
``fv2p_tpu/ops/sparse/sparse_tensor.py``, host-rulebook layout only).

Rows are per-sample blocks of ``sample_cap`` rows; each valid row carries a
z-last linearized key ``((b * H + y) * W + x) * D + z`` and invalid rows
carry ``INVALID_KEY``. Neighbour tables come from the host rulebook, so the
tensor needs no occupancy index.
"""
import dataclasses
from typing import Tuple

import torch

INVALID_KEY = 2 ** 31 - 1


@dataclasses.dataclass
class SparseTensor:
    features: torch.Tensor            # (N_cap, C); invalid rows are zeros
    keys: torch.Tensor                # (N_cap,) int64; invalid = INVALID_KEY
    spatial_shape: Tuple[int, int, int] = (0, 0, 0)   # (D, H, W)
    batch_size: int = 1
    sample_cap: int = 0

    @property
    def num_channels(self):
        return self.features.shape[-1]

    def valid_mask(self):
        return self.keys != INVALID_KEY

    def coords(self):
        """Decode keys -> (N_cap, 4) [b, z, y, x] (invalid rows: junk)."""
        return decode_keys(self.keys, self.spatial_shape)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def encode_keys(coords_bzyx, spatial_shape):
    d, h, w = spatial_shape
    b, z, y, x = coords_bzyx.unbind(-1)
    return ((b * h + y) * w + x) * d + z


def decode_keys(keys, spatial_shape):
    d, h, w = spatial_shape
    z = keys % d
    col = keys // d
    x = col % w
    y = (col // w) % h
    b = col // (w * h)
    return torch.stack([b, z, y, x], dim=1)


def from_host_coords(coords_zyx, valid, features_flat, spatial_shape,
                     batch_size):
    """SparseTensor from host-sorted per-sample coords.

    coords_zyx: (B, cap, 3) int (z, y, x) in key order per sample;
    valid: (B, cap) bool; features_flat: (B*cap, C).
    """
    b, cap = coords_zyx.shape[:2]
    batch_col = torch.arange(b, device=coords_zyx.device).view(b, 1, 1)
    coords4 = torch.cat([batch_col.expand(b, cap, 1),
                         coords_zyx.to(torch.int64)], dim=-1).reshape(b * cap, 4)
    vflat = valid.reshape(b * cap)
    keys = torch.where(vflat, encode_keys(coords4, spatial_shape), INVALID_KEY)
    feats = features_flat.masked_fill(~vflat[:, None], 0.0)
    return SparseTensor(features=feats, keys=keys,
                        spatial_shape=tuple(int(x) for x in spatial_shape),
                        batch_size=int(batch_size), sample_cap=int(cap))


def to_dense_zfolded(st):
    """Sparse -> dense BEV with z folded into channels, NHWC
    (B, H, W, C*D) with channel index c * D + z (HeightCompression)."""
    d, h, w = st.spatial_shape
    c = st.num_channels
    b, z, y, x = st.coords().unbind(-1)
    n_cols = st.batch_size * h * w
    # invalid rows land on one extra column that is dropped afterwards
    flat_sp = torch.where(st.valid_mask(), (b * h + y) * w + x, n_cols)
    dense = st.features.new_zeros((n_cols + 1, d, c))
    dense[flat_sp, z] = st.features
    dense = dense[:-1].reshape(st.batch_size, h, w, d, c)
    return dense.permute(0, 1, 2, 4, 3).reshape(st.batch_size, h, w, c * d)
