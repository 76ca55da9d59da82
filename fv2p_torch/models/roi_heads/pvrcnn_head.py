"""PV-RCNN's RoI head (counterpart of
``fv2p_tpu/models/roi_heads/pvrcnn_head.py``), and the RoI-grid head it
shares with Voxel R-CNN's.

``RoIGridHead`` takes the proposals of the dense head's predictions (one
rotated NMS a scan, kernel B1), in training samples ROI_PER_IMAGE of them a
scan with their targets (``assign_targets``: B1 again in the 3D IoU), puts
GRID_SIZE^3 grid points in each RoI, pools features at them (``pool``, the
subclass's), and runs the shared FC layers and the class and box heads;
in eval mode it decodes the boxes in the RoI's frame. ``PVRCNNHead`` pools
the keypoint features weighted by their segmentation scores (no stop on the
gradient: the RCNN loss trains the point head too) by multi-scale grouping
at two radii. ``pvrcnn_head_loss`` is BCE classification, smooth-l1
regression and the corner loss."""
import torch
from torch import nn

from ...utils import box_coder_utils, common_utils
from ..backbones_3d.pfe.voxel_set_abstraction import add_msg_mlps, msg_pool
from ..layers import BatchNorm, Dense, Dropout
from .iouguided_roi_head import (_dense_grid_points, assign_targets, decode_in_roi_frame,
                                 draw_roi_sampling, proposal_layer, rcnn_box_loss_terms)


def pvrcnn_head_loss(model_cfg, ret):
    """RCNN classification, regression and corner losses. Returns (loss,
    terms)."""
    tb = rcnn_box_loss_terms(model_cfg, ret)
    rcnn_loss = tb['rcnn_loss_cls'] + tb['rcnn_loss_reg'] + tb['rcnn_loss_corner']
    tb['rcnn_loss'] = rcnn_loss
    return rcnn_loss, tb


class RoIGridHead(nn.Module):
    """Proposals, targets, grid points, shared FC and heads; a subclass
    gives ``pool(batch_dict, grid)``: grid (B, R * G, 3) -> (B, R * G,
    ``pooled_channels``). Every layer computes in f32, as flax does with
    f32 parameters and no dtype."""

    def __init__(self, model_cfg, num_class, pooled_channels):
        super().__init__()
        self.model_cfg = model_cfg
        self.box_coder = getattr(box_coder_utils, model_cfg.TARGET_CONFIG.BOX_CODER)()
        self.grid_size = int(model_cfg.ROI_GRID_POOL.GRID_SIZE)
        self.dropout = Dropout(float(model_cfg.DP_RATIO))
        ch = self.grid_size ** 3 * int(pooled_channels)
        self.n_shared = len(model_cfg.SHARED_FC)
        for k, out in enumerate(model_cfg.SHARED_FC):
            setattr(self, f'shared_fc{k}', Dense(ch, int(out), False))
            setattr(self, f'shared_bn{k}', BatchNorm(int(out)))
            ch = int(out)
        outs = {'cls': num_class, 'reg': self.box_coder.code_size * num_class}
        self.n_fc = {'cls': len(model_cfg.CLS_FC), 'reg': len(model_cfg.REG_FC)}
        for name, fc_list in (('cls', model_cfg.CLS_FC), ('reg', model_cfg.REG_FC)):
            c = ch
            for k, out in enumerate(fc_list):
                setattr(self, f'{name}_fc{k}', Dense(c, int(out), False))
                setattr(self, f'{name}_bn{k}', BatchNorm(int(out)))
                c = int(out)
            setattr(self, f'{name}_out', Dense(c, outs[name]))

    def _head(self, x, name, generator):
        for k in range(self.n_fc[name]):
            x = torch.relu(getattr(self, f'{name}_bn{k}')(getattr(self, f'{name}_fc{k}')(x)))
            if k == 0:
                x = self.dropout(x, generator)
        return getattr(self, f'{name}_out')(x)

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
        b, r = batch_rois.shape[0], batch_rois.shape[1]
        rois_flat = batch_rois.reshape(b * r, -1)
        local_grid = _dense_grid_points(rois_flat, self.grid_size)
        global_grid = common_utils.rotate_points_along_z(
            local_grid, rois_flat[:, 6]) + rois_flat[:, None, 0:3]
        pooled = self.pool(batch_dict, global_grid.reshape(b, r * local_grid.shape[1], 3))

        x = pooled.reshape(b * r, -1)
        gen = gens.get('dropout')
        for k in range(self.n_shared):
            x = torch.relu(getattr(self, f'shared_bn{k}')(getattr(self, f'shared_fc{k}')(x)))
            if k != self.n_shared - 1:
                x = self.dropout(x, gen)
        rcnn_cls = self._head(x, 'cls', gen)
        rcnn_reg = self._head(x, 'reg', gen)

        if self.training:
            ret.update(rcnn_cls=rcnn_cls, rcnn_reg=rcnn_reg, rois_sampled=batch_rois)
            batch_dict['roi_head_ret'] = ret
            return batch_dict
        batch_dict['batch_cls_preds'] = rcnn_cls.reshape(b, r, -1)
        batch_dict['batch_box_preds'] = decode_in_roi_frame(
            self.box_coder, rcnn_reg.reshape(b, r, self.box_coder.code_size), batch_rois)
        batch_dict['has_class_labels'] = True
        batch_dict['cls_preds_normalized'] = False
        return batch_dict


class PVRCNNHead(RoIGridHead):
    """Pools the keypoints' ``point_features`` (``point_channels`` wide),
    weighted by ``point_cls_scores``, by multi-scale grouping at the grid
    points (``pool_mlp{i}_{j}``)."""

    def __init__(self, model_cfg, num_class, point_channels):
        pool_cfg = model_cfg.ROI_GRID_POOL
        mlps = tuple(tuple(int(c) for c in m) for m in pool_cfg.MLPS)
        super().__init__(model_cfg, num_class, sum(m[-1] for m in mlps))
        self.mlps = mlps
        self.radii = tuple(float(x) for x in pool_cfg.POOL_RADIUS)
        self.nsamples = tuple(int(x) for x in pool_cfg.NSAMPLE)
        add_msg_mlps(self, 'pool_', point_channels, self.mlps)

    def pool(self, batch_dict, grid):
        kp_xyz = batch_dict['point_coords']                       # (B, K, 3)
        kp_feats = batch_dict['point_features'] * batch_dict['point_cls_scores'][..., None]
        b, k, _ = kp_xyz.shape
        valid = torch.ones(b * k, dtype=torch.bool, device=kp_xyz.device)
        return msg_pool(self, 'pool_', self.mlps, self.radii, self.nsamples, grid,
                        kp_xyz.reshape(b * k, 3), valid, kp_feats.reshape(b * k, -1),
                        [i * k for i in range(b + 1)])
