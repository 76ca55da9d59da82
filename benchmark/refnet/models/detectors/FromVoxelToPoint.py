"""FV2P (``MODEL.NAME: FromVoxelToPoint``), after
fv2p_torch/models/detectors/detector3d_template.py at commit c8e3fcd."""
from ..dense_heads.anchor_head import anchor_head_loss
from ..dense_heads.point_head_simple import point_head_loss
from ..roi_heads.iouguided_roi_head import roi_head_loss
from .detector3d_template import Detector3DTemplate


class Detector(Detector3DTemplate):
    """Two-stage IoU-guided detector: anchor RPN -> voxel-to-point decoder
    -> point segmentation head -> IoU-guided RoI head with two-pass
    alignment -> IoU-score-ranked NMS."""

    def training_loss(self, batch_dict):
        """The RPN, point-head and RCNN losses summed."""
        cfg = self.model_cfg
        rpn_loss, tb = anchor_head_loss(cfg.DENSE_HEAD, batch_dict['anchor_head_ret'],
                                        self.dense_head.anchors_flat, self.num_class)
        point_loss, tb_p = point_head_loss(cfg.POINT_HEAD, batch_dict['point_head_ret'])
        rcnn_loss, tb_r = roi_head_loss(cfg.ROI_HEAD, batch_dict['roi_head_ret'])
        tb.update(tb_p)
        tb.update(tb_r)
        loss = rpn_loss + point_loss + rcnn_loss
        tb['loss'] = loss
        return loss, tb
