"""The plain reference: ``refnet``, a frozen copy of the port's FV2P and
MGAF-3DSSD model code with the kernels' plain PyTorch versions, computed in
the precision the configuration states (bf16 products and activations,
f32 parameters, statistics and sums) under PyTorch's default backend flags,
the program's: the model code's f32 convolutions (MGAF-3DSSD's DCN offset
convs) run in cuDNN's TF32 on both sides. It imports nothing of the program:
it builds its own voxel tables (the numpy builder), its own targets and RoI
draws, and is handed only the benchmark's inputs and weights.

``Fp8`` is the control: the reference with the operands of every matrix
product and convolution rounded to float8 e4m3 (a per-tensor scale from
the largest magnitude, as fp8 training scales them) and its sums kept in
f32, as an fp8 path feeds its products: the precision below the bf16 the
configuration states.

``F32Sums`` is a sound witness: the reference with the same products summed
in another order (a bf16 product widened to f32 is exact, so each product
and convolution with bf16 operands runs on them in f32 and rounds its
result to bf16 as before), the change that a hand kernel's other order of
summation makes; it reads what such a change of the program would."""
import copy

import numpy as np
import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from refnet.models import build_network
from refnet.ops.sparse import host_rulebook
from refnet.train_utils.optimization import one_cycle_mom
from refnet.train_utils.train_state import TrainStep

PRED_KEYS = ('pred_boxes', 'pred_scores', 'pred_labels', 'pred_valid')


def with_tables(batch_np, cfg, grid_size, caps):
    """A copy of a drawn batch with the reference's own voxel tables for the sparse
    backbone ``cfg`` names."""
    b = copy.deepcopy(batch_np)
    return host_rulebook.prepare_batch_rulebooks(b, cfg.MODEL.BACKBONE_3D.NAME, grid_size,
                                                 caps_override=caps)


def to_device(batch_np, device):
    out = {}
    for k, v in batch_np.items():
        if isinstance(v, dict):
            out[k] = {kk: torch.from_numpy(np.ascontiguousarray(vv)).to(device)
                      for kk, vv in v.items() if isinstance(vv, np.ndarray)}
        elif isinstance(v, np.ndarray):
            out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(device)
    return out


def build_model(cfg, meta, device, compute_dtype=None):
    """The reference detector in eval mode, computing in ``compute_dtype``
    (None: f32)."""
    return build_network(cfg.MODEL, len(cfg.CLASS_NAMES), cfg.CLASS_NAMES, meta,
                         compute_dtype=compute_dtype, device=device)


@torch.no_grad()
def detections(model, batch):
    """The reference's detections of one batch, as host numpy arrays."""
    out = model.eval()(dict(batch))
    return {k: out[k].cpu().numpy() for k in PRED_KEYS}


def first_gradient(optimizer):
    """The gradient the optimizer took at its first step, from its state:
    Adam's first moment after one step is (1 - b1) g."""
    b1 = float(torch.tensor(one_cycle_mom(0, optimizer.moms, optimizer.pct_start,
                                          optimizer.total_steps), dtype=torch.float32))
    scale = float(1.0 - torch.tensor(b1, dtype=torch.float32))
    return [m / scale for m in optimizer.mu]


def train_steps(model, optim_cfg, total_steps, batches):
    """Run the reference's train step over ``batches`` in turn from the
    model's state. Returns (loss terms a step as floats, the first step's
    gradient a leaf, the change a leaf after the last step), leaves in
    ``named_parameters`` order."""
    start = [p.detach().clone() for p in model.parameters()]
    step = TrainStep(model, optim_cfg, total_steps)
    losses, grads = [], None
    for i, batch in enumerate(batches):
        terms = step.step(batch)
        losses.append({k: float(v) for k, v in terms.items()})
        if i == 0:
            grads = [g.clone() for g in first_gradient(step.optimizer)]
    change = [p.detach() - s for p, s in zip(model.parameters(), start)]
    return losses, grads, change


def _round_fp8(t):
    if not (torch.is_tensor(t) and t.is_floating_point() and t.numel()):
        return t
    with torch.no_grad():
        amax = t.detach().abs().amax().float().clamp(min=1e-30)
        scale = 448.0 / amax
        q = (t.detach().float() * scale).to(torch.float8_e4m3fn).float() / scale
    return t + (q.to(t.dtype) - t).detach()


class Fp8(TorchFunctionMode):
    """Round both operands of each product and convolution to e4m3 (the
    straight-through rounding keeps the backward differentiable)."""
    PRODUCTS = {F.linear, F.conv2d, F.conv3d, F.conv_transpose2d, torch.matmul,
                torch.Tensor.matmul, torch.Tensor.__matmul__, torch.mm, torch.Tensor.mm,
                torch.bmm, torch.einsum}
    ADD_PRODUCT = {torch.addmm, torch.Tensor.addmm, torch.Tensor.addmm_, torch.baddbmm}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.einsum:
            args = (args[0],) + tuple(_round_fp8(a) for a in args[1:])
        elif func in self.ADD_PRODUCT:
            args = (args[0],) + tuple(_round_fp8(a) for a in args[1:3]) + args[3:]
        elif func in self.PRODUCTS:
            args = tuple(_round_fp8(a) for a in args[:2]) + args[2:]
        return func(*args, **kwargs)


def _widen(a):
    return a.float() if torch.is_tensor(a) and a.dtype == torch.bfloat16 else a


class F32Sums(TorchFunctionMode):
    """Each product and convolution with bf16 operands run on them widened
    to f32, its result rounded to the dtype it had."""
    WIDENED = (Fp8.PRODUCTS | Fp8.ADD_PRODUCT) - {torch.Tensor.addmm_}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self.WIDENED and any(
                torch.is_tensor(a) and a.dtype == torch.bfloat16
                for a in list(args) + list(kwargs.values())):
            out_dtype = kwargs.pop('out_dtype', torch.bfloat16)
            out = func(*map(_widen, args), **{k: _widen(v) for k, v in kwargs.items()})
            return out.to(out_dtype)
        return func(*args, **kwargs)
