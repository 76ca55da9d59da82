"""Center-based anchor-free head with mask-guided attention (counterpart of
``fv2p_tpu/models/dense_heads/center_af_head.py``: ``_FCHead`` and
``CenterAFHeadSingle``). Inference only.

The convolutions run on NCHW views of the channels-last BEV map; the
predictions and the decoded boxes are f32 and channels-last, as in JAX.
Module names follow the flax names, so the weight loader maps them one to
one."""
import torch
from torch import nn

# a module reference, not a name: ops.dcn imports models.layers, and so this
# module may be reached while ops.dcn is still initialising
from ...ops import dcn
from ...utils import box_utils, center_utils
from ..layers import BatchNorm, Conv2d


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


class _FCHead(nn.Module):
    """conv3x3 -> BN -> ReLU -> conv (final_kernel, with bias); f32 out."""

    def __init__(self, cin, head_conv, out_channel, final_kernel=1,
                 compute_dtype=None):
        super().__init__()
        self.Conv_0 = Conv2d(cin, head_conv, 3, padding=1, bias=False,
                             compute_dtype=compute_dtype)
        self.BatchNorm_0 = BatchNorm(head_conv, axis=1)
        self.Conv_1 = Conv2d(head_conv, out_channel, final_kernel,
                             padding=(final_kernel - 1) // 2,
                             compute_dtype=compute_dtype)

    def forward(self, x):
        x = torch.relu(self.BatchNorm_0(self.Conv_0(x)))
        return self.Conv_1(x).float()


class CenterAFHeadSingle(nn.Module):
    """Shared conv + BN (eps 1e-5) -> MDCN feature adaptation (4 deformable
    groups) -> segm head and the attention x + sigmoid(segm) * x -> one
    fused 3x3 conv for the other heads, sliced per head into its output
    conv -> max-pool NMS and top-K decode (K = NUM_INFERENCE_SAMPLES)."""

    def __init__(self, model_cfg, input_channels, num_class, voxel_size,
                 point_cloud_range, compute_dtype=None):
        super().__init__()
        cfg = model_cfg
        self.model_cfg = cfg
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        cd = compute_dtype
        cin = input_channels
        self.n_shared = len(cfg.SHARED_FC)
        for i, ch in enumerate(cfg.SHARED_FC):
            ks = int(cfg.SHARED_KS[i])
            setattr(self, f'shared_conv{i}', Conv2d(
                cin, ch, ks, padding=(ks - 1) // 2, bias=False, compute_dtype=cd))
            # torch-default eps here, unlike the heads' BatchNorms
            setattr(self, f'shared_bn{i}', BatchNorm(ch, axis=1, eps=1e-5))
            cin = ch
        self.use_dcn = cfg.get('USE_DCN', False) in ('DCN', 'MDCN')
        if self.use_dcn:
            self.feature_adapt = dcn.FeatureAdaption(cin, cin, 3,
                                                     deformable_groups=4,
                                                     compute_dtype=cd)
        heads = {h['name']: h for h in cfg.HEADS_CONFIG}
        segm = heads['segm']
        self.segm = _FCHead(cin, int(segm['head_conv']), int(segm['out_channel']),
                            int(segm['final_kernel']), cd)
        self.others = [(name, h) for name, h in heads.items() if name != 'segm']
        widths = [int(h['head_conv']) for _, h in self.others]
        self.heads_fused_conv = Conv2d(cin, sum(widths), 3, padding=1,
                                       bias=False, compute_dtype=cd)
        self.heads_fused_bn = BatchNorm(sum(widths), axis=1)
        for (name, h), width in zip(self.others, widths):
            out_ch = num_class if name == 'hm' else int(h['out_channel'])
            fk = int(h['final_kernel'])
            setattr(self, f'{name}_out', Conv2d(width, out_ch, fk,
                                                padding=(fk - 1) // 2,
                                                compute_dtype=cd))
        self.widths = widths

    def forward(self, batch_dict):
        x = _nchw(batch_dict['spatial_features_2d'])
        for i in range(self.n_shared):
            x = getattr(self, f'shared_conv{i}')(x)
            x = torch.relu(getattr(self, f'shared_bn{i}')(x))
        if self.use_dcn:
            x = _nchw(self.feature_adapt(_nhwc(x)))

        segm_pred = self.segm(x)
        att = x + torch.sigmoid(segm_pred) * x
        batch_dict['spatial_features_before_head'] = _nhwc(att)
        ret = {'segm_pred': _nhwc(segm_pred)}

        mid = torch.relu(self.heads_fused_bn(self.heads_fused_conv(att)))
        offset = 0
        for (name, _), width in zip(self.others, self.widths):
            sl = mid[:, offset:offset + width]
            ret[f'{name}_pred'] = _nhwc(getattr(self, f'{name}_out')(sl).float())
            offset += width

        stride = int(self.model_cfg.TARGET_ASSIGNER_CONFIG.FEATURE_MAP_STRIDE)
        batch_dict.update(self.decode_predhm_ssd(
            ret, int(self.model_cfg.NUM_INFERENCE_SAMPLES), stride))
        batch_dict['cls_preds_normalized'] = False
        batch_dict['head_ret'] = ret
        return batch_dict

    def _decode_common(self, ret, inds, xs, ys, stride):
        b, k = inds.shape
        offset = center_utils.gather_feat_nhwc(ret['offset_pred'], inds)
        xs = xs[..., None] + offset[:, :, 0:1]
        ys = ys[..., None] + offset[:, :, 1:2]
        height = center_utils.gather_feat_nhwc(ret['height_pred'], inds)
        dim = center_utils.gather_feat_nhwc(ret['dim_pred'], inds)
        rot_feat = center_utils.gather_feat_nhwc(ret['rot_pred'], inds)
        num_bins = rot_feat.shape[-1] // 2
        rot = box_utils.decode_rot_binres(
            rot_feat.reshape(b * k, -1), num_head_bin=num_bins).reshape(b, k, 1)
        vx, vy = self.voxel_size[0], self.voxel_size[1]
        x0, y0 = self.point_cloud_range[0], self.point_cloud_range[1]
        xs = xs * stride * vx + x0
        ys = ys * stride * vy + y0
        # the dims stay as the head predicts them (no exp): a box may come out
        # with a negative or zero extent
        return torch.cat([xs, ys, height, dim, rot], dim=2)

    def decode_predhm_ssd(self, ret, k, stride):
        """Max-pool NMS + top-k decode: batch_box_preds (B, K, 7),
        batch_cls_preds (B, K, C) raw suppressed heat logits,
        batch_iouscore_preds (B, K, 1)."""
        heat = center_utils.heatmap_maxpool_nms(ret['hm_pred'])
        _, inds, _, ys, xs = center_utils.topk_heatmap(heat, k)
        return {
            'batch_box_preds': self._decode_common(ret, inds, xs, ys, stride),
            'batch_cls_preds': center_utils.gather_feat_nhwc(heat, inds),
            'batch_iouscore_preds': center_utils.gather_feat_nhwc(
                ret['iouscore_pred'], inds),
        }
