"""PointRCNN's RoI head (counterpart of
``fv2p_tpu/models/roi_heads/pointrcnn_head.py``), also built for the name
``PointRCNNIoUHead``.

The proposals are the point head's per-point boxes after one rotated NMS a
scan (kernel B1); in training ROI_PER_IMAGE of them a scan are sampled
with their targets (``assign_targets``). Each RoI pools the first
NUM_SAMPLED_POINTS points inside it (``roipoint_pool3d``, wrapped around
when fewer) with their segmentation score, depth and features, and turns
them into its canonical frame. No gradient flows back into the points:
the RCNN loss trains this head alone. An xyz-up MLP and a merge MLP fuse
the pooled features; an SA encoder runs on the (B * R, NUM_SAMPLED_POINTS)
rows: per level FPS centers in each row (kernel B2; a row of an empty RoI
has no valid point and takes index 0 for every pick), a ball group and an
MLP with a max, and a group-all at the end. The class and box FC heads
follow. With TARGET_CONFIG.CLS_SCORE_TYPE ``rcnn_iou`` the classification
labels are the 3D IoU (kernel B1) of the decoded, detached refinement with
the class-matched gt, as soft labels between CLS_BG_THRESH and
CLS_FG_THRESH. Every layer computes in f32, as flax does with f32
parameters and no dtype. ``pointrcnn_head_loss`` is ``pvrcnn_head_loss``,
as in JAX."""
import torch
from torch import nn

from ...ops import pointops
from ...utils import box_coder_utils, common_utils, iou3d
from ..layers import BatchNorm, Dense, Dropout
from .iouguided_roi_head import (_MLP1x1, assign_targets, decode_in_roi_frame,
                                 draw_roi_sampling, proposal_layer)
from .pvrcnn_head import pvrcnn_head_loss

pointrcnn_head_loss = pvrcnn_head_loss
N_PREFIX = 5              # pooled xyz, segmentation score, depth: the xyz-up input


def rcnn_iou_labels(boxes, roi_labels, gt_boxes, fg_thresh, bg_thresh):
    """Soft classification labels (B, R) in [0, 1]: each box's largest 3D
    IoU with a gt of its class, mapped linearly from [bg, fg] onto [0, 1]."""
    ious = []
    for bx, lb, gt in zip(boxes, roi_labels, gt_boxes):
        gt_l = gt[:, 7].to(torch.int32)
        iou = iou3d.boxes_iou3d(bx.contiguous(), gt[:, :7].contiguous())
        same = (lb.to(torch.int32)[:, None] == gt_l[None, :]) & (gt_l > 0)[None, :]
        ious.append(torch.where(same, iou, 0.0).amax(dim=1))
    soft = (torch.stack(ious) - bg_thresh) / (fg_thresh - bg_thresh)
    return soft.clamp(0.0, 1.0)


class PointRCNNHead(nn.Module):
    def __init__(self, model_cfg, num_class, point_channels):
        super().__init__()
        self.model_cfg = model_cfg
        self.box_coder = getattr(box_coder_utils, model_cfg.TARGET_CONFIG.BOX_CODER)()
        use_bn = bool(model_cfg.USE_BN)
        up = tuple(int(c) for c in model_cfg.XYZ_UP_LAYER)
        self.xyz_up = _MLP1x1(N_PREFIX, up, use_bn)
        self.merge_down = _MLP1x1(up[-1] + int(point_channels), (up[-1],), use_bn)
        sa = model_cfg.SA_CONFIG
        self.sa_levels = [(int(n), float(r), int(s)) for n, r, s in
                          zip(sa.NPOINTS, sa.RADIUS, sa.NSAMPLE)]
        ch = up[-1]
        for k, mlp in enumerate(sa.MLPS):
            setattr(self, f'sa{k}', _MLP1x1(3 + ch, tuple(int(c) for c in mlp), use_bn))
            ch = int(mlp[-1])
        self.dropout = Dropout(float(model_cfg.DP_RATIO))
        outs = {'cls': num_class, 'reg': self.box_coder.code_size * num_class}
        self.n_fc = {}
        for name, fc_list in (('cls', model_cfg.CLS_FC), ('reg', model_cfg.REG_FC)):
            c = ch
            for k, out in enumerate(fc_list):
                setattr(self, f'{name}_fc{k}', Dense(c, int(out), False))
                setattr(self, f'{name}_bn{k}', BatchNorm(int(out)))
                c = int(out)
            setattr(self, f'{name}_out', Dense(c, outs[name]))
            self.n_fc[name] = len(fc_list)

    def _head(self, x, name, generator):
        for k in range(self.n_fc[name]):
            x = torch.relu(getattr(self, f'{name}_bn{k}')(getattr(self, f'{name}_fc{k}')(x)))
            if k == 0:
                x = self.dropout(x, generator)
        return getattr(self, f'{name}_out')(x)

    def pool(self, batch_dict, rois):
        """Canonical RoI point pooling: (B * R, S, 5 + C) pooled points
        (xyz in the RoI's frame, score, depth, features) and the empty
        flags (B * R,), both without gradient."""
        cfg = self.model_cfg.ROI_POINT_POOL
        b, r = rois.shape[:2]
        coords = batch_dict['point_coords'].detach()
        scores = batch_dict['point_cls_scores'].detach()
        depths = torch.linalg.norm(coords, dim=-1) / float(cfg.DEPTH_NORMALIZER) - 0.5
        feats = torch.cat([scores[..., None], depths[..., None],
                           batch_dict['point_features'].detach().float()], dim=-1)
        n_sampled = int(cfg.NUM_SAMPLED_POINTS)
        pooled, empty = pointops.roipoint_pool3d(coords, feats, rois[..., :7], n_sampled,
                                                 tuple(cfg.POOL_EXTRA_WIDTH))
        pooled = pooled.reshape(b * r, n_sampled, -1)
        empty = empty.reshape(b * r)
        rois_flat = rois.reshape(b * r, -1)
        xyz = common_utils.rotate_points_along_z(pooled[..., 0:3] - rois_flat[:, None, 0:3],
                                                 -rois_flat[:, 6])
        pooled = torch.cat([xyz, pooled[..., 3:]], dim=-1)
        return pooled.masked_fill(empty[:, None, None], 0.0).detach(), empty

    def encode(self, pooled, empty):
        """The xyz-up and merge MLPs, then the SA encoder: (B * R, C)."""
        merged = self.merge_down(torch.cat([self.xyz_up(pooled[..., :N_PREFIX]),
                                            pooled[..., N_PREFIX:]], dim=-1))
        cur_xyz = pooled[..., 0:3].contiguous()
        cur_valid = (~empty)[:, None].expand(cur_xyz.shape[:2]).contiguous()
        cur_feats = merged
        for k, (npoint, radius, nsample) in enumerate(self.sa_levels):
            mlp = getattr(self, f'sa{k}')
            if npoint > 0:
                idx = pointops.farthest_point_sample_batch(cur_xyz, cur_valid, npoint)
                new_xyz = torch.gather(cur_xyz, 1, idx[..., None].expand(-1, -1, 3))
                new_valid = torch.gather(cur_valid, 1, idx)
                d = new_xyz[:, :, None, :] - cur_xyz[:, None, :, :]
                d2 = (d[..., 0] ** 2 + d[..., 1] ** 2) + d[..., 2] ** 2
                gx, gf, _ = pointops.ball_query_group(new_xyz, cur_xyz, cur_valid, cur_feats,
                                                      radius, nsample, d2)
                cur_feats = mlp(torch.cat([gx, gf], dim=-1)).amax(dim=2)
                cur_xyz, cur_valid = new_xyz, new_valid
            else:
                g = mlp(torch.cat([cur_xyz, cur_feats], dim=-1))
                g = torch.where(cur_valid[..., None], g, -1e9)
                cur_feats = g.amax(dim=1, keepdim=True)
                cur_xyz = cur_xyz.new_zeros((cur_xyz.shape[0], 1, 3))
                cur_valid = torch.ones_like(cur_valid[:, :1])
        return cur_feats[:, 0].masked_fill(empty[:, None], 0.0)

    def forward(self, batch_dict):
        cfg = self.model_cfg
        rois, roi_scores, roi_labels, roi_valid = proposal_layer(
            batch_dict['batch_box_preds'], batch_dict['batch_cls_preds'],
            cfg.NMS_CONFIG['TRAIN' if self.training else 'TEST'])
        batch_dict.update(rois=rois, roi_scores=roi_scores, roi_labels=roi_labels,
                          roi_valid=roi_valid)
        gens = batch_dict.get('generators', {})
        ret = {}
        if self.training:
            tcfg = cfg.TARGET_CONFIG
            draws = draw_roi_sampling(rois.shape[0], rois.shape[1], int(tcfg.ROI_PER_IMAGE),
                                      gens.get('sampling'), rois.device)
            ret = assign_targets(batch_dict, tcfg, draws)
            batch_dict.update(rois=ret['rois'], roi_labels=ret['roi_labels'])

        batch_rois = batch_dict['rois']
        b, r = batch_rois.shape[:2]
        shared = self.encode(*self.pool(batch_dict, batch_rois))
        gen = gens.get('dropout')
        rcnn_cls = self._head(shared, 'cls', gen)
        rcnn_reg = self._head(shared, 'reg', gen)
        code_size = self.box_coder.code_size

        if self.training:
            ret.update(rcnn_cls=rcnn_cls, rcnn_reg=rcnn_reg, rois_sampled=batch_rois)
            tcfg = cfg.TARGET_CONFIG
            if tcfg.get('CLS_SCORE_TYPE', 'cls') == 'rcnn_iou':
                with torch.no_grad():
                    dec = decode_in_roi_frame(self.box_coder,
                                              rcnn_reg.reshape(b, r, code_size), batch_rois)
                    ret['rcnn_cls_labels'] = rcnn_iou_labels(
                        dec[..., :7], batch_dict['roi_labels'], batch_dict['gt_boxes'],
                        float(tcfg.CLS_FG_THRESH), float(tcfg.CLS_BG_THRESH))
            batch_dict['roi_head_ret'] = ret
            return batch_dict
        batch_dict['batch_cls_preds'] = rcnn_cls.reshape(b, r, -1)
        batch_dict['batch_box_preds'] = decode_in_roi_frame(
            self.box_coder, rcnn_reg.reshape(b, r, code_size), batch_rois)
        batch_dict['has_class_labels'] = True
        batch_dict['cls_preds_normalized'] = False
        return batch_dict
