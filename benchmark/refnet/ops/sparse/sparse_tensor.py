# Frozen at commit c8e3fcd from fv2p_torch/ops/sparse/sparse_tensor.py, unchanged.
"""Fixed-capacity sparse voxel tensor (counterpart of
``fv2p_tpu/ops/sparse/sparse_tensor.py``).

Each valid row carries a z-last linearized key
``((b * H + y) * W + x) * D + z`` and invalid rows carry ``INVALID_KEY``.
Two layouts:

* host rulebooks (``from_host_coords``): per-sample blocks of
  ``sample_cap`` rows, the neighbour tables built on the host;
* device rulebooks (``from_coords``, ``from_candidate_keys``;
  ``sample_cap == 0``): one batch-flat array whose valid rows are in
  ascending key order across the whole batch, invalid rows at the tail.
  Since ``b`` is the key's high part, each sample's rows are contiguous.
  ``lookup`` finds a voxel's row by a binary search over the sorted keys
  (JAX finds the same row through per-column occupancy bits and popcounts,
  because sorts are slow on the TPU; the rows are the same).

Every key must stay below ``INVALID_KEY``: ``check_key_range`` raises
where ``B * D * H * W`` reaches it.
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

    @property
    def capacity(self):
        return self.keys.shape[0]

    def lookup(self, b, z, y, x, valid):
        """Row of voxel (b, z, y, x), or ``capacity`` (the zero row) where it
        is absent or ``valid`` is False; batch-flat layout only. All args
        broadcastable int64 tensors."""
        d, h, w = self.spatial_shape
        q = ((b * h + y) * w + x) * d + z
        q = torch.where(valid, q, INVALID_KEY)
        pos = torch.searchsorted(self.keys, q.reshape(-1)).reshape(q.shape)
        pos = pos.clamp(max=self.capacity - 1)
        found = valid & (self.keys[pos] == q)
        return torch.where(found, pos, self.capacity)


def sample_row_bounds(st):
    """(B + 1,) int64 on the device: sample b's rows are
    ``[bounds[b], bounds[b + 1])``, its block in the host layout, its key
    range in the batch-flat one (where the invalid rows follow the last)."""
    ar = torch.arange(st.batch_size + 1, device=st.keys.device)
    if st.sample_cap:
        return ar * st.sample_cap
    d, h, w = st.spatial_shape
    return torch.searchsorted(st.keys, ar * (d * h * w))


def check_key_range(spatial_shape, batch_size):
    """Raise ValueError unless every key of a (B, D, H, W) grid lies below
    ``INVALID_KEY`` (static ints: no host read of the card)."""
    d, h, w = (int(x) for x in spatial_shape)
    if int(batch_size) * d * h * w >= INVALID_KEY:
        raise ValueError(
            f'sparse keys overflow: batch {batch_size} x grid {(d, h, w)} = '
            f'{int(batch_size) * d * h * w} cells, keys must stay below {INVALID_KEY}')


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


def from_coords(coords_bzyx, features, spatial_shape, batch_size,
                valid_mask=None):
    """Batch-flat SparseTensor from unsorted, padded, unique voxels:
    coords (N, 4) [b, z, y, x], features (N, C), valid (N,). The valid rows
    go to their rank in key order (a stable sort of the keys, invalid keys
    last), the invalid rows to the tail with zero features."""
    check_key_range(spatial_shape, batch_size)
    if valid_mask is None:
        valid_mask = torch.ones(coords_bzyx.shape[0], dtype=torch.bool,
                                device=coords_bzyx.device)
    keys = torch.where(valid_mask,
                       encode_keys(coords_bzyx.to(torch.int64), spatial_shape),
                       INVALID_KEY)
    keys, order = torch.sort(keys, stable=True)
    feats = features[order].masked_fill(~valid_mask[order][:, None], 0.0)
    return SparseTensor(features=feats, keys=keys,
                        spatial_shape=tuple(int(x) for x in spatial_shape),
                        batch_size=int(batch_size))


def from_candidate_keys(cand_keys, capacity, spatial_shape, batch_size, dtype):
    """Feature-less batch-flat SparseTensor of the distinct valid keys of
    ``cand_keys`` (any order, repeats allowed, invalid = INVALID_KEY), the
    smallest ``capacity`` of them in ascending order, and the number of
    distinct keys past the capacity (a 0-d device tensor): those rows are
    dropped, as JAX's ``from_occupancy_grid`` drops every rank past its
    capacity."""
    srt, _ = torch.sort(cand_keys)
    first = torch.ones_like(srt, dtype=torch.bool)
    first[1:] = srt[1:] != srt[:-1]
    first &= srt != INVALID_KEY
    rank = torch.cumsum(first, 0) - 1
    tgt = torch.where(first & (rank < capacity), rank, capacity)
    keys = srt.new_full((capacity + 1,), INVALID_KEY).scatter_(0, tgt, srt)
    dropped = torch.clamp(first.sum() - capacity, min=0)
    return SparseTensor(features=torch.zeros((capacity, 0), dtype=dtype,
                                             device=srt.device),
                        keys=keys[:capacity],
                        spatial_shape=tuple(int(x) for x in spatial_shape),
                        batch_size=int(batch_size)), dropped


def from_host_coords(coords_zyx, valid, features_flat, spatial_shape,
                     batch_size):
    """SparseTensor from host-sorted per-sample coords.

    coords_zyx: (B, cap, 3) int (z, y, x) in key order per sample;
    valid: (B, cap) bool; features_flat: (B*cap, C).
    """
    b, cap = coords_zyx.shape[:2]
    check_key_range(spatial_shape, b)
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
