"""Weights for the port: carried across from the JAX model, or seeded.

``load_flax_variables(model, variables_np)`` fills a torch model from the
JAX model's ``{'params', 'batch_stats'}`` tree (converted to numpy). The
torch modules carry the flax module names, so each flax module path maps to
one torch submodule (``a/b/c`` -> ``a.b.c``):

* ``Dense`` kernel (I, O) -> ``Linear`` weight (O, I); a 1x1 ``Conv``
  kernel (1, 1, I, O) also maps onto a ``Dense``;
* ``Conv`` kernel (kH, kW, I, O) -> (O, I, kH, kW);
* ``ConvTranspose`` kernel (kH, kW, I, O) -> spatially flipped, (I, O, kH, kW);
* sparse-conv kernels and the deformable conv's own kernel, both
  (K, Cin, Cout), stay as they are;
* BatchNorm ``scale``/``bias`` + ``batch_stats`` ``mean``/``var`` -> weight,
  bias, running_mean, running_var.

Any flax leaf without a torch home, or torch tensor left unfilled, raises.
``flax_variables(model)`` is the converse: the port's parameters and
running statistics, or with ``grads=True`` the parameters' gradients, as a
flax tree of numpy arrays (a 1x1 flax ``Conv`` mapped onto a ``Dense``
gets its (1, 1, I, O) kernel back).

``init_random_(model, seed)`` draws weights from a ``torch.Generator``: the
same initialisers as the flax modules (LeCun normal kernels, zero biases,
identity BatchNorm; the anchor heads' class convs, ``conv_cls`` and the
multihead's ``h{i}_cls_out``, start at bias -log 99; the box convs and the
RoI-grid heads' ``reg_out`` at std 0.001). The deformable
blocks' offset convs are drawn like every other conv, not zeroed as flax
does: zero offsets would make a DCN a plain conv. ``calibrate_batchnorm_(model, batch)`` then sets the BatchNorm
statistics from one forward, so that deep models keep unit-scale
activations.
"""
import math

import numpy as np
import torch

from .models.layers import BatchNorm, ConvTranspose2d, Dense
from .ops.dcn import MdeformConvBlock
from .ops.sparse.conv import MaskedBatchNorm, _SparseConvBase


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, 'items'):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _converted(module, leaf, arr):
    """The torch attribute name and tensor for one flax leaf of a module."""
    if isinstance(module, (BatchNorm, MaskedBatchNorm)):
        name = {'scale': 'weight', 'bias': 'bias', 'mean': 'running_mean',
                'var': 'running_var'}[leaf]
        return name, arr
    if leaf == 'bias':
        return 'bias', arr
    if leaf != 'kernel':
        raise KeyError(leaf)
    if isinstance(module, (_SparseConvBase, MdeformConvBlock)):
        return 'kernel', arr
    if isinstance(module, Dense):
        return 'weight', arr.reshape(arr.shape[-2], arr.shape[-1]).T
    if isinstance(module, ConvTranspose2d):
        return 'weight', arr[::-1, ::-1].transpose(2, 3, 0, 1)
    if isinstance(module, torch.nn.Conv2d):
        return 'weight', arr.transpose(3, 2, 0, 1)
    raise TypeError(f'no flax mapping for {type(module).__name__}')


def load_flax_variables(model, variables_np):
    """Copy a flax variable tree into ``model`` (in place); returns model."""
    state = model.state_dict()
    filled = set()
    unmatched = []
    for collection in ('params', 'batch_stats'):
        for path, arr in _flatten(variables_np.get(collection, {})):
            mod_path, leaf = '.'.join(path[:-1]), path[-1]
            try:
                module = model.get_submodule(mod_path)
                name, value = _converted(module, leaf, arr)
            except (AttributeError, KeyError, TypeError):
                unmatched.append('/'.join((collection,) + path))
                continue
            key = f'{mod_path}.{name}'
            if key not in state or tuple(state[key].shape) != value.shape:
                unmatched.append('/'.join((collection,) + path))
                continue
            state[key].copy_(torch.tensor(np.array(value)))
            filled.add(key)
    unfilled = sorted(set(state) - filled)
    if unmatched or unfilled:
        raise ValueError(f'flax -> torch weight map: unmatched flax leaves '
                         f'{unmatched}; unfilled torch tensors {unfilled}')
    return model


def _flax_leaves(module, tensors):
    """(collection, leaf, numpy array) of one module's tensors, named and
    laid out as flax keeps them; ``tensors(name)`` gives each tensor."""
    def arr(name):
        t = tensors(name)
        return t.detach().cpu().numpy().copy()

    if isinstance(module, (BatchNorm, MaskedBatchNorm)):
        return [('params', 'scale', arr('weight')), ('params', 'bias', arr('bias')),
                ('batch_stats', 'mean', arr('running_mean')),
                ('batch_stats', 'var', arr('running_var'))]
    if isinstance(module, (_SparseConvBase, MdeformConvBlock)):
        kernel = arr('kernel')
    elif isinstance(module, Dense):
        kernel = arr('weight').T
        kernel = kernel.reshape(module.flax_kernel_prefix + kernel.shape)
    elif isinstance(module, ConvTranspose2d):
        kernel = arr('weight').transpose(2, 3, 0, 1)[::-1, ::-1]
    elif isinstance(module, torch.nn.Conv2d):
        kernel = arr('weight').transpose(2, 3, 1, 0)
    else:
        return []
    out = [('params', 'kernel', np.ascontiguousarray(kernel))]
    if getattr(module, 'bias', None) is not None:
        out.append(('params', 'bias', arr('bias')))
    return out


def flax_variables(model, grads=False):
    """The model as a flax variable tree {'params', 'batch_stats'} of numpy
    arrays; with ``grads=True`` the tree {'params'} of the parameters'
    gradients (zeros where a parameter has none)."""
    out = {}
    for mod_path, module in model.named_modules():
        def tensor(name, module=module):
            t = getattr(module, name)
            if grads and isinstance(t, torch.nn.Parameter):
                return t.grad if t.grad is not None else torch.zeros_like(t)
            return t
        for collection, leaf, value in _flax_leaves(module, tensor):
            if grads and collection != 'params':
                continue
            node = out.setdefault(collection, {})
            for part in mod_path.split('.'):
                node = node.setdefault(part, {})
            node[leaf] = value
    return out


@torch.no_grad()
def init_random_(model, seed=0):
    """Seeded initialisation on the CPU, copied to the model's device, so a
    seed gives the same weights on every device."""
    gen = torch.Generator().manual_seed(seed)
    for name, module in model.named_modules():
        if isinstance(module, (BatchNorm, MaskedBatchNorm)):
            module.weight.fill_(1.0)
            module.bias.zero_()
            module.running_mean.zero_()
            module.running_var.fill_(1.0)
            continue
        if isinstance(module, (_SparseConvBase, MdeformConvBlock)):
            w = module.kernel                       # (K, Cin, Cout)
            fan_in = w.shape[0] * w.shape[1]
        elif isinstance(module, ConvTranspose2d):
            w = module.weight                       # (I, O, kH, kW)
            fan_in = w.shape[0] * w.shape[2] * w.shape[3]
        elif isinstance(module, (Dense, torch.nn.Conv2d)):
            w = module.weight                       # (O, I, ...)
            fan_in = math.prod(w.shape[1:])
        else:
            continue
        small = name.endswith('conv_box') or name == 'roi_head.reg_out'
        std = 0.001 if small else 1.0 / math.sqrt(fan_in)
        w.copy_(torch.randn(w.shape, generator=gen) * std)
        if getattr(module, 'bias', None) is not None:
            cls_out = name.endswith('conv_cls') or name.endswith('_cls_out')
            module.bias.fill_(-math.log(99.0) if cls_out else 0.0)
    return model


@torch.no_grad()
def calibrate_batchnorm_(model, batch_dict):
    """Set every BatchNorm's running statistics to those of its input in one
    forward over ``batch_dict`` (valid voxel rows only for the sparse ones),
    layer after layer, so each sees its calibrated predecessors; returns the
    model. Seeded weights with identity statistics shrink the activations
    at every conv + ReLU: through MGAF's 40 of them its heat-map logits fall
    to ~1e-5, under any score threshold. Calibrated, every BatchNorm puts
    out zero mean and unit variance, as trained statistics would."""
    def calibrate(module, args):
        x = args[0].float()
        if isinstance(module, MaskedBatchNorm):
            rows = x[args[1]]
        else:
            rows = x.movedim(module.axis, -1).reshape(-1, x.shape[module.axis])
        module.running_mean.copy_(rows.mean(0))
        module.running_var.copy_(rows.var(0, unbiased=False))

    handles = [m.register_forward_pre_hook(calibrate) for m in model.modules()
               if isinstance(m, (BatchNorm, MaskedBatchNorm))]
    try:
        model(dict(batch_dict))
    finally:
        for h in handles:
            h.remove()
    return model
