# Frozen at commit c8e3fcd from fv2p_torch/models/detectors/detector3d_template.py; the slots and detectors are looked up by name from files of their own (slots/<NAME>.py, detectors/<NAME>.py).
"""Config-driven detector assembly: each slot of the module topology is
built iff its config key exists, by the file of the module its ``NAME``
names (``slots/<NAME>.py``), and the forward runs the built slots in that
order on one batch dict of tensors. In eval mode it then post-processes into
fixed-shape (B, post_max) outputs; in train mode it skips post-processing
and each head leaves its targets and predictions for the detector's
``training_loss``. A detector is the class ``Detector`` of
``detectors/<NAME>.py``."""
import importlib

import torch
from torch import nn

from ..model_utils import model_nms_utils

MODULE_TOPOLOGY = ['vfe', 'backbone_3d', 'map_to_bev_module', 'pfe',
                   'backbone_2d', 'dense_head', 'post_pfe', 'point_head',
                   'roi_head']

# each slot's config key
_SLOT_KEYS = {'vfe': 'VFE', 'backbone_3d': 'BACKBONE_3D',
              'map_to_bev_module': 'MAP_TO_BEV', 'pfe': 'PFE',
              'backbone_2d': 'BACKBONE_2D', 'dense_head': 'DENSE_HEAD',
              'post_pfe': 'POST_PFE', 'point_head': 'POINT_HEAD',
              'roi_head': 'ROI_HEAD'}


def _named(package, name):
    """The module ``refnet.models.<package>.<name>``: one file a module or
    detector name, so that a new one is a new file."""
    try:
        return importlib.import_module(f'refnet.models.{package}.{name}')
    except ModuleNotFoundError as e:
        if e.name != f'refnet.models.{package}.{name}':
            raise
        raise NotImplementedError(
            f'the reference has no {package[:-1]} {name!r}: add '
            f'benchmark/refnet/models/{package}/{name}.py') from None


def slot_module(name):
    """The file of the slot module a config's ``NAME`` names: its
    ``build(detector)`` makes the module, and a sparse backbone's may give
    ``table_spec`` for its host tables."""
    return _named('slots', name)


class Detector3DTemplate(nn.Module):
    """Builds the slots its config names; eval-mode forward through them,
    then IoU-score-ranked NMS (``post_processing_withfgscores``)."""

    def __init__(self, model_cfg, num_class, class_names, dataset_meta,
                 compute_dtype=None):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_class = num_class
        self.class_names = list(class_names)
        self.dataset_meta = dataset_meta
        self.compute_dtype = compute_dtype
        for slot in MODULE_TOPOLOGY:
            key = _SLOT_KEYS[slot]
            if key not in model_cfg:
                continue
            setattr(self, slot, slot_module(model_cfg[key].NAME).build(self))

    def module_list(self):
        return [getattr(self, slot) for slot in MODULE_TOPOLOGY
                if hasattr(self, slot)]

    def forward(self, batch_dict):
        if self.training:
            return self.train_forward(batch_dict)
        with torch.no_grad():
            for module in self.module_list():
                batch_dict = module(batch_dict)
            batch_dict.update(self.final_predictions(batch_dict))
        return batch_dict

    def final_predictions(self, batch_dict):
        return self.post_processing_withfgscores(batch_dict)

    def train_forward(self, batch_dict):
        """The slots in train mode, with autograd and without
        post-processing; ``batch_dict`` needs ``gt_boxes`` (B, M, 8) and may
        carry ``generators`` ({'sampling', 'dropout'}: torch.Generator)."""
        for module in self.module_list():
            batch_dict = module(batch_dict)
        return batch_dict

    def post_processing_withfgscores(self, batch_dict):
        """IoU-score-ranked NMS with foreground-score filtering; fixed-shape
        (B, post_max) boxes / scores / labels / valid."""
        pp = self.model_cfg.POST_PROCESSING
        box_preds = batch_dict['batch_box_preds']              # (B, K, 7)
        cls_preds = batch_dict['batch_cls_preds']              # (B, K, C)
        iouscore = batch_dict['batch_iouscore_preds'][..., 0]  # (B, K)
        cls_probs = cls_preds if batch_dict.get('cls_preds_normalized', False) \
            else torch.sigmoid(cls_preds)
        fg_scores = cls_probs.amax(dim=-1)
        if batch_dict.get('has_class_labels', False) and 'roi_labels' in batch_dict:
            labels = batch_dict['roi_labels']
        else:
            labels = torch.argmax(cls_probs, dim=-1) + 1

        keep = [model_nms_utils.class_agnostic_nms_withfgscore(
                    fg, loc, bx, pp.NMS_CONFIG, float(pp.SCORE_THRESH))
                for fg, loc, bx in zip(fg_scores, iouscore, box_preds)]
        keep_idx, final_scores, keep_valid = (torch.stack(x) for x in zip(*keep))
        return {
            'pred_boxes': torch.gather(
                box_preds, 1, keep_idx[..., None].expand(-1, -1, box_preds.shape[-1])),
            'pred_scores': final_scores,
            'pred_labels': torch.gather(labels, 1, keep_idx),
            'pred_valid': keep_valid,
        }

    def training_loss(self, batch_dict):
        """(loss, terms) of a train-mode forward's ``batch_dict``, every term
        a 0-d tensor, ``terms['loss']`` the total: each detector's file
        gives its own."""
        raise NotImplementedError(type(self).__name__)


def build_detector(model_cfg, num_class, class_names, dataset_meta,
                   compute_dtype=None):
    """The detector of ``refnet/models/detectors/<NAME>.py`` (its class
    ``Detector``)."""
    return _named('detectors', model_cfg.NAME).Detector(
        model_cfg, num_class, class_names, dataset_meta, compute_dtype)
