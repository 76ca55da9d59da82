"""Seeded weights, made on the card from ``--seed``, and the BatchNorm
calibration. Both sides of a cell are handed the same state dict.

The rule is that of ``fv2p_torch.weights.init_random_`` (frozen at commit
c8e3fcd): LeCun-normal kernels (std 1/sqrt(fan_in)), zero biases, identity
BatchNorm and LayerNorm; the anchor head's class conv starts at bias
-log 99, its box conv and the RoI head's ``reg_out`` at std 0.001. The
draws differ: one ``torch.Generator`` on the card fills every kernel from
one normal draw, in f32 (the type the parameters are served in), so set-up
makes the weights in a few large calls. The calibration is that of
``fv2p_torch.weights.calibrate_batchnorm_``, run on the reference."""
import math

import torch

from refnet.models.layers import (BatchNorm, Conv2d, Conv3d, ConvTranspose2d, Dense,
                                  DenseGeneral, LayerNorm)
from refnet.ops.dcn import MdeformConvBlock
from refnet.ops.sparse.conv import MaskedBatchNorm, _SparseConvBase


def _kernel_and_fan_in(module):
    if isinstance(module, (_SparseConvBase, MdeformConvBlock)):
        w = module.kernel                       # (K, Cin, Cout)
        return w, w.shape[0] * w.shape[1]
    if isinstance(module, ConvTranspose2d):
        w = module.weight                       # (I, O, kH, kW)
        return w, w.shape[0] * w.shape[2] * w.shape[3]
    if isinstance(module, DenseGeneral):
        w = module.kernel
        return w, math.prod(w.shape[:module.n_in])
    if isinstance(module, (Dense, Conv2d, torch.nn.Conv2d, Conv3d)):
        w = module.weight                       # (O, I, ...)
        return w, math.prod(w.shape[1:])
    return None, None


@torch.no_grad()
def init_seeded_(model, seed, dcn_offsets='drawn'):
    """Fill ``model`` (a reference model, on the card) from ``seed``. With
    ``dcn_offsets='zero'`` the deformable convs' offset and mask convs start
    at zero, as the JAX package's flax initialiser leaves them: every
    offset 0 and every mask 0.5 until training moves them."""
    device = next(model.parameters()).device
    kernels = []
    for name, module in model.named_modules():
        if dcn_offsets == 'zero' and name.endswith('conv_offset_mask'):
            module.weight.zero_()
            module.bias.zero_()
            continue
        if isinstance(module, (BatchNorm, MaskedBatchNorm)):
            module.running_mean.zero_()
            module.running_var.fill_(1.0)
        if isinstance(module, (BatchNorm, MaskedBatchNorm, LayerNorm)):
            module.weight.fill_(1.0)
            module.bias.zero_()
            continue
        w, fan_in = _kernel_and_fan_in(module)
        if w is None:
            continue
        small = name.endswith('conv_box') or name == 'roi_head.reg_out'
        kernels.append((w, 0.001 if small else 1.0 / math.sqrt(fan_in)))
        if getattr(module, 'bias', None) is not None:
            cls_out = name.endswith('conv_cls') or name.endswith('_cls_out')
            module.bias.fill_(-math.log(99.0) if cls_out else 0.0)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.randn(sum(w.numel() for w, _ in kernels), generator=gen,
                       device=device, dtype=torch.float32)
    offset = 0
    for w, std in kernels:
        n = w.numel()
        w.copy_(flat[offset:offset + n].view(w.shape) * std)
        offset += n
    return model


@torch.no_grad()
def calibrate_batchnorm_(model, batch_dict):
    """Set every BatchNorm's running statistics to those of its input in one
    forward over ``batch_dict`` (valid voxel rows only for the sparse ones),
    layer after layer. Seeded weights with identity statistics shrink the
    activations at every conv + ReLU: through MGAF-3DSSD's 40 of them its
    heat-map logits fall to ~1e-5, under any score threshold."""
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
