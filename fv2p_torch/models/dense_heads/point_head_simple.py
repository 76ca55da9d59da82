"""Per-keypoint foreground head (counterpart of
``fv2p_tpu/models/dense_heads/point_head_simple.py``). Inference only."""
import torch
from torch import nn

from ..layers import BatchNorm, Dense


class PointHeadSimple(nn.Module):
    def __init__(self, model_cfg, input_channels, num_class,
                 compute_dtype=None):
        super().__init__()
        self.model_cfg = model_cfg
        self.n_fc = len(model_cfg.CLS_FC)
        ch = input_channels
        for i, out in enumerate(model_cfg.CLS_FC):
            setattr(self, f'cls_fc{i}', Dense(ch, out, False, compute_dtype))
            setattr(self, f'cls_bn{i}', BatchNorm(out))
            ch = out
        n_out = 1 if model_cfg.get('CLASS_AGNOSTIC', True) else num_class
        self.cls_out = Dense(ch, n_out)

    def forward(self, batch_dict):
        if self.model_cfg.get('USE_POINT_FEATURES_BEFORE_FUSION', False):
            feats = batch_dict['point_features_before_fusion']
        else:
            feats = batch_dict['point_features']            # (B, K, C)
        b, k, c = feats.shape
        x = feats.reshape(-1, c)
        for i in range(self.n_fc):
            x = torch.relu(getattr(self, f'cls_bn{i}')(
                getattr(self, f'cls_fc{i}')(x)))
        logits = self.cls_out(x).reshape(b, k, -1)
        scores = torch.sigmoid(logits)
        batch_dict['point_cls_scores'] = scores.amax(dim=-1)
        batch_dict['batch_pointseg_preds'] = torch.cat(
            [batch_dict['point_coords'], scores], dim=-1)
        return batch_dict
