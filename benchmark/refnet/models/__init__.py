# The reference's build_network, after fv2p_torch/models/__init__.py at commit c8e3fcd.
def build_network(model_cfg, num_class, class_names, dataset_meta,
                  compute_dtype=None, device='cpu'):
    """Build the detector in eval mode on ``device``."""
    from .detectors.detector3d_template import build_detector
    model = build_detector(model_cfg, num_class=num_class,
                           class_names=class_names, dataset_meta=dataset_meta,
                           compute_dtype=compute_dtype)
    return model.to(device).eval()
