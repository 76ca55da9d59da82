"""Dense BEV backbones (counterpart of
``fv2p_tpu/models/backbones_2d/base_bev_backbone.py``: ``BaseBEVBackbone``
and ``DCNBEVBackbone``).

Each level: a k3 conv (stride s, padding 1) + BN + ReLU, then LAYER_NUMS
more k3 convs; each level is upsampled by a transposed conv (kernel ==
stride) + BN + ReLU, or for an upsample stride s < 1 downsampled by a conv
with kernel == stride == round(1 / s) (flax's 'SAME' padding), and the ups
are concatenated into ``spatial_features_2d``. With ``USE_DCN`` each
upsampling is preceded by a modulated deformable conv block + BN + ReLU.
The batch dict keeps channels-last (B, H, W, C) maps; the convolutions run
on NCHW internally. Module names follow the flax auto-names (``Conv_0``,
``BatchNorm_0``, ...) so the weight loader maps them one to one.
"""
import torch
import torch.nn.functional as F
from torch import nn

# a module reference, not a name: ops.dcn imports models.layers, and so this
# module may be reached while ops.dcn is still initialising
from ...ops import dcn
from ..layers import BatchNorm, Conv2d, ConvTranspose2d


class _Block(nn.Module):
    def __init__(self, cin, num_filters, layer_num, stride, compute_dtype=None):
        super().__init__()
        self.n = layer_num + 1
        for j in range(self.n):
            setattr(self, f'Conv_{j}', Conv2d(
                cin if j == 0 else num_filters, num_filters, 3,
                stride=stride if j == 0 else 1, padding=1, bias=False,
                compute_dtype=compute_dtype))
            setattr(self, f'BatchNorm_{j}', BatchNorm(num_filters, axis=1))

    def forward(self, x):
        for j in range(self.n):
            x = getattr(self, f'Conv_{j}')(x)
            x = torch.relu(getattr(self, f'BatchNorm_{j}')(x))
        return x


def same_pad(x, kernel, stride):
    """Zero-pad an NCHW map as flax's 'SAME' padding does for a conv of this
    kernel and stride: ceil(n / s) outputs, the odd pixel at the end."""
    pads = []
    for n in (x.shape[3], x.shape[2]):
        total = max((-(-n // stride) - 1) * stride + kernel - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads) if any(pads) else x


class _Deblock(nn.Module):
    """[dcn -> BatchNorm_0 -> ReLU ->] ConvTranspose_0 -> BN -> ReLU; the
    flax auto-names shift by one BatchNorm when the DCN block is there. A
    stride s < 1 makes it Conv_0 (kernel == stride == round(1 / s), 'SAME')
    -> BatchNorm_0 -> ReLU."""

    def __init__(self, cin, num_upsample_filters, upsample_stride,
                 use_dcn=False, compute_dtype=None):
        super().__init__()
        self.use_dcn = use_dcn
        self.down = upsample_stride < 1
        if use_dcn:
            self.dcn = dcn.MdeformConvBlock(cin, cin, 3, deformable_groups=1,
                                        compute_dtype=compute_dtype)
            self.BatchNorm_0 = BatchNorm(cin, axis=1)
            self.BatchNorm_1 = BatchNorm(num_upsample_filters, axis=1)
        else:
            self.BatchNorm_0 = BatchNorm(num_upsample_filters, axis=1)
        if self.down:
            s = int(round(1 / upsample_stride))
            self.Conv_0 = Conv2d(cin, num_upsample_filters, s, stride=s, bias=False,
                                 compute_dtype=compute_dtype)
        else:
            self.ConvTranspose_0 = ConvTranspose2d(
                cin, num_upsample_filters, int(upsample_stride), bias=False,
                compute_dtype=compute_dtype)

    def _resample(self, x):
        if self.down:
            s = self.Conv_0.stride[0]
            return self.Conv_0(same_pad(x, s, s))
        return self.ConvTranspose_0(x)

    def forward(self, x):
        if not self.use_dcn:
            return torch.relu(self.BatchNorm_0(self._resample(x)))
        x = self.dcn(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        x = torch.relu(self.BatchNorm_0(x))
        return torch.relu(self.BatchNorm_1(self._resample(x)))


class BaseBEVBackbone(nn.Module):
    def __init__(self, model_cfg, input_channels, compute_dtype=None):
        super().__init__()
        use_dcn = bool(model_cfg.get('USE_DCN', False))
        layer_nums = model_cfg.get('LAYER_NUMS', [])
        layer_strides = model_cfg.get('LAYER_STRIDES', [])
        num_filters = model_cfg.get('NUM_FILTERS', [])
        upsample_strides = model_cfg.get('UPSAMPLE_STRIDES', [])
        num_up_filters = model_cfg.get('NUM_UPSAMPLE_FILTERS', [])
        if len(upsample_strides) != len(layer_nums):
            raise NotImplementedError(
                'one upsampling deblock per level: the extra trailing deblock is '
                'not in fv2p_torch yet (ROADMAP.md, queue A)')
        self.n_levels = len(layer_nums)
        cin = input_channels
        for i in range(self.n_levels):
            setattr(self, f'block{i}', _Block(cin, num_filters[i], layer_nums[i],
                                              layer_strides[i], compute_dtype))
            setattr(self, f'deblock{i}', _Deblock(
                num_filters[i], num_up_filters[i], upsample_strides[i],
                use_dcn, compute_dtype))
            cin = num_filters[i]

    def forward(self, batch_dict):
        x_in = batch_dict['spatial_features']               # (B, H, W, C)
        x = x_in.permute(0, 3, 1, 2)
        ups = []
        for i in range(self.n_levels):
            x = getattr(self, f'block{i}')(x)
            stride = x_in.shape[1] // x.shape[2]
            batch_dict[f'spatial_features_{stride}x'] = x.permute(0, 2, 3, 1)
            ups.append(getattr(self, f'deblock{i}')(x))
        x = torch.cat(ups, dim=1)
        batch_dict['spatial_features_2d'] = x.permute(0, 2, 3, 1)
        return batch_dict


class DCNBEVBackbone(BaseBEVBackbone):
    """BaseBEVBackbone with a DCN block before each deblock when the config
    sets USE_DCN (MGAF-3DSSD: 3 levels [5, 5, 5], ups [1, 2, 4] -> 768
    channels)."""
