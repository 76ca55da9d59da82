"""MGAF-3DSSD (``MODEL.NAME: MGAF3DSSD``), after
fv2p_torch/models/detectors/detector3d_template.py at commit c8e3fcd."""
from ..dense_heads.center_af_head import center_af_head_loss
from .detector3d_template import Detector3DTemplate


class Detector(Detector3DTemplate):
    """Single-stage anchor-free detector: sparse trunk -> DCN BEV backbone ->
    CenterAF head (max-pool NMS + top-K decode) -> IoU-score-ranked NMS."""

    def training_loss(self, batch_dict):
        """The CenterAF head's eight terms."""
        rpn_loss, tb = center_af_head_loss(self.model_cfg.DENSE_HEAD, batch_dict['head_ret'])
        tb['loss'] = rpn_loss
        return rpn_loss, tb
