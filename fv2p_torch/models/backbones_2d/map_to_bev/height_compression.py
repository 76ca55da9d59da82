"""Sparse -> dense BEV (counterpart of
``fv2p_tpu/models/backbones_2d/map_to_bev/height_compression.py``).

Produces channels-last ``spatial_features`` (B, H, W, C*D), channel index
c*D + z."""
from torch import nn

from ....ops.sparse.sparse_tensor import to_dense_zfolded


class HeightCompression(nn.Module):
    def forward(self, batch_dict):
        st = batch_dict['encoded_spconv_tensor']
        batch_dict['spatial_features'] = to_dense_zfolded(st)
        batch_dict['spatial_features_stride'] = \
            batch_dict['encoded_spconv_tensor_stride']
        return batch_dict
