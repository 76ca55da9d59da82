"""The system under test, ``fv2p_torch``: the only module of the benchmark
that imports it. From the program the benchmark takes the detector that
``build_network`` builds, its train step, its host rulebook builder (the
port's data path builds the tables on the host), its batch copy to the
card, and its kernels' entry points for the spans."""
import copy
import importlib

from fv2p_torch.config import EasyDict
from fv2p_torch.models import build_network
from fv2p_torch.models.detectors.detector3d_template import MODULE_TOPOLOGY
from fv2p_torch.ops import cuda as cuda_ops
from fv2p_torch.ops import dcn
from fv2p_torch.ops.sparse import host_rulebook
from fv2p_torch.train_utils.train_state import TrainStep
from fv2p_torch.utils.synthetic import batch_to_torch


def entry_points(kernels):
    """{kernel: (the program's module, its entry points' names)} of the hand
    kernels' files (``cell.load_kernels``)."""
    return {name: (importlib.import_module(k.PROGRAM), k.ENTRIES)
            for name, k in kernels.items()}


def with_tables(batch_np, cfg, grid_size, caps):
    """A copy of a drawn batch with the program's host tables for the sparse
    backbone ``cfg`` names."""
    b = copy.deepcopy(batch_np)
    return host_rulebook.prepare_batch_rulebooks(b, cfg.MODEL.BACKBONE_3D.NAME, grid_size,
                                                 caps_override=caps)


def to_device(batch_np, device):
    return batch_to_torch(batch_np, device)


def build_model(cfg, meta, compute_dtype, state, device):
    """The detector in eval mode on ``device``, loaded with ``state``."""
    port_cfg = EasyDict(cfg)
    model = build_network(port_cfg.MODEL, len(port_cfg.CLASS_NAMES), port_cfg.CLASS_NAMES,
                          meta, compute_dtype=compute_dtype, device=device)
    model.load_state_dict(state)
    return model


def train_step(model, cfg, total_steps):
    return TrainStep(model, EasyDict(cfg).OPTIMIZATION, total_steps)


def build_kernels():
    """Build (nvcc, at a checkout's first run) and load every hand kernel."""
    cuda_ops.build()
    for name in cuda_ops.KERNELS:
        cuda_ops.library(name)


def slots(model):
    """(name, module) of each slot the detector built, in forward order."""
    return [(s, getattr(model, s)) for s in MODULE_TOPOLOGY if hasattr(model, s)]


def dcn_entry():
    """(module, name) of the deformable conv's entry point."""
    return dcn, 'modulated_deform_conv'
