"""Model building (counterpart of ``fv2p_tpu/models/__init__.py``)."""
import torch

from .detectors.detector3d_template import build_detector


def build_network(model_cfg, num_class, class_names, dataset_meta,
                  compute_dtype=None, device=None):
    """Build the detector in eval mode on ``device``.

    ``device=None`` means the CUDA card; without one this raises rather than
    fall back to the CPU. Pass ``device='cpu'`` explicitly to run the plain
    PyTorch versions of the kernels there."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError('fv2p_torch.models.build_network: no CUDA '
                               "device; pass device='cpu' to run on the CPU")
        device = 'cuda'
    model = build_detector(model_cfg, num_class=num_class,
                           class_names=class_names, dataset_meta=dataset_meta,
                           compute_dtype=compute_dtype)
    return model.to(device).eval()
