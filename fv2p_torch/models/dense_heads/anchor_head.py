"""Anchor-based RPN head (counterpart of
``fv2p_tpu/models/dense_heads/anchor_head.py``): anchors, the
``AnchorHeadSingle`` forward and the box decode. Inference only."""
import math

import numpy as np
import torch
from torch import nn

from ...utils import box_coder_utils, common_utils
from ..layers import Dense


def generate_anchors(anchor_generator_cfg, grid_size, point_cloud_range):
    """Static numpy anchors: (ny, nx, A, 7) with A = num_cls * num_rot
    (align_center=False layout)."""
    pr = point_cloud_range
    per_class = []
    for cfg in anchor_generator_cfg:
        stride = int(cfg.get('feature_map_stride', 8))
        fm_nx, fm_ny = grid_size[0] // stride, grid_size[1] // stride
        x_stride = (pr[3] - pr[0]) / (fm_nx - 1)
        y_stride = (pr[4] - pr[1]) / (fm_ny - 1)
        xs = pr[0] + np.arange(fm_nx) * x_stride
        ys = pr[1] + np.arange(fm_ny) * y_stride
        sizes = np.array(cfg['anchor_sizes'], np.float32)       # (S, 3)
        rots = np.array(cfg['anchor_rotations'], np.float32)    # (R,)
        heights = np.array(cfg['anchor_bottom_heights'], np.float32)
        s, r, h = len(sizes), len(rots), len(heights)
        anchors = np.zeros((fm_ny, fm_nx, h, s, r, 7), np.float32)
        anchors[..., 0] = xs[None, :, None, None, None]
        anchors[..., 1] = ys[:, None, None, None, None]
        anchors[..., 2] = heights[None, None, :, None, None]
        anchors[..., 3:6] = sizes[None, None, None, :, None, :]
        anchors[..., 6] = rots[None, None, None, None, :]
        anchors[..., 2] += anchors[..., 5] / 2  # bottom -> center
        per_class.append(anchors.reshape(fm_ny, fm_nx, h * s * r, 7))
    return np.concatenate(per_class, axis=2)


class AnchorHeadSingle(nn.Module):
    """1x1 cls / box / direction convs over the BEV map, then the decode of
    every anchor's box (the RoI head consumes all of them)."""

    def __init__(self, model_cfg, input_channels, num_class, grid_size,
                 point_cloud_range):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_class = num_class
        anchors = generate_anchors(model_cfg.ANCHOR_GENERATOR_CONFIG,
                                   tuple(grid_size), tuple(point_cloud_range))
        self.anchor_shape = anchors.shape
        self.register_buffer('anchors_flat',
                             torch.from_numpy(anchors.reshape(-1, 7)),
                             persistent=False)
        a = anchors.shape[2]
        self.num_dir_bins = int(model_cfg.NUM_DIR_BINS)
        # 1x1 convolutions over a channels-last map are Dense layers
        self.conv_cls = Dense(input_channels, a * num_class)
        self.conv_box = Dense(input_channels, a * 7)
        self.conv_dir_cls = Dense(input_channels, a * self.num_dir_bins)
        self.box_coder = getattr(
            box_coder_utils, model_cfg.TARGET_ASSIGNER_CONFIG.BOX_CODER)()

    def forward(self, batch_dict):
        x = batch_dict['spatial_features_2d']               # (B, H, W, C)
        batch_dict['spatial_features_before_head'] = x
        b = x.shape[0]
        ny, nx, a, _ = self.anchor_shape
        n = ny * nx * a
        cls_preds = self.conv_cls(x).reshape(b, n, self.num_class).float()
        box_preds = self.conv_box(x).reshape(b, n, 7).float()
        dir_preds = self.conv_dir_cls(x).reshape(b, n, self.num_dir_bins).float()
        batch_dict['batch_cls_preds'] = cls_preds
        batch_dict['batch_box_preds'] = self._decode_preds(box_preds, dir_preds)
        batch_dict['cls_preds_normalized'] = False
        return batch_dict

    def _decode_preds(self, box_preds, dir_preds):
        cfg = self.model_cfg
        decoded = self.box_coder.decode(box_preds, self.anchors_flat[None])
        if cfg.get('USE_DIRECTION_CLASSIFIER', False):
            dir_offset = float(cfg.DIR_OFFSET)
            dir_limit_offset = float(cfg.DIR_LIMIT_OFFSET)
            period = 2 * math.pi / self.num_dir_bins
            dir_labels = torch.argmax(dir_preds, dim=-1)
            val = common_utils.limit_period(decoded[..., 6] - dir_offset,
                                            dir_limit_offset, period)
            rot = val + dir_offset + period * dir_labels.to(decoded.dtype)
            decoded = torch.cat([decoded[..., :6], rot[..., None],
                                 decoded[..., 7:]], dim=-1)
        return decoded
