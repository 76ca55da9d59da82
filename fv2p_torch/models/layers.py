"""Layers with the numerics of the reference's flax layers.

``Dense``/``Conv2d``/``ConvTranspose2d`` keep f32 weights and compute in
``compute_dtype`` when one is set (input and weights cast to it, output in
it); without one they compute in f32, as flax infers from f32 parameters.
``BatchNorm`` is flax's BatchNorm (epsilon 1e-3 unless given, momentum
0.99): f32 statistics and output, ``(x - mean) * (scale * rsqrt(var + eps))
+ bias``, with the running statistics in eval mode and the batch's in
training. ``Dropout`` is flax's, drawn from an explicit ``torch.Generator``.
``weights.load_flax_variables`` maps these modules onto flax param trees by
their dotted names.
"""
import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3
BN_MOMENTUM = 0.99      # running = 0.99 * running + 0.01 * batch


def _dt(compute_dtype, x):
    return compute_dtype or torch.promote_types(x.dtype, torch.float32)


class Dense(nn.Linear):
    """flax ``nn.Dense`` over the last axis; ``conv1x1`` marks one that
    stands for a flax 1x1 ``nn.Conv`` (kernel (1, 1, I, O))."""

    def __init__(self, in_features, out_features, bias=True,
                 compute_dtype=None, conv1x1=False):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = compute_dtype
        self.flax_kernel_prefix = (1, 1) if conv1x1 else ()

    def forward(self, x):
        dt = _dt(self.compute_dtype, x)
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class Conv2d(nn.Conv2d):
    """flax ``nn.Conv`` on NCHW tensors, explicit padding."""

    def __init__(self, cin, cout, kernel_size, stride=1, padding=0, bias=True,
                 compute_dtype=None):
        super().__init__(cin, cout, kernel_size, stride=stride,
                         padding=padding, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = _dt(self.compute_dtype, x)
        b = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), b, self.stride,
                        self.padding)


class ConvTranspose2d(nn.ConvTranspose2d):
    """flax ``nn.ConvTranspose`` with kernel == stride on NCHW tensors (the
    weight loader flips the flax kernel spatially)."""

    def __init__(self, cin, cout, stride, bias=True, compute_dtype=None):
        super().__init__(cin, cout, stride, stride=stride, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = _dt(self.compute_dtype, x)
        b = None if self.bias is None else self.bias.to(dt)
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt), b,
                                  self.stride)


def batch_stats(x, axis):
    """flax's batch statistics over every axis but ``axis``, in f32: the
    mean and the biased variance ``max(0, mean(x^2) - mean(x)^2)`` (flax's
    default ``use_fast_variance``), which normalise and update alike."""
    xf = x.to(torch.float32)
    dims = [d for d in range(x.dim()) if d != axis % x.dim()]
    mean = xf.mean(dim=dims)
    var = torch.clamp((xf * xf).mean(dim=dims) - mean * mean, min=0.0)
    return mean, var


@torch.no_grad()
def update_running_(running_mean, running_var, mean, var):
    running_mean.mul_(BN_MOMENTUM).add_(mean.detach(), alpha=1.0 - BN_MOMENTUM)
    running_var.mul_(BN_MOMENTUM).add_(var.detach(), alpha=1.0 - BN_MOMENTUM)


class BatchNorm(nn.Module):
    """flax BatchNorm over ``axis`` (default: the last axis): running
    statistics in eval mode; in training the batch's (``batch_stats``),
    which also update the running ones. Not ``F.batch_norm``: its training
    mode takes another variance formula and keeps an unbiased running
    variance."""

    def __init__(self, num_features, axis=-1, eps=BN_EPS):
        super().__init__()
        self.axis = axis
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer('running_mean', torch.zeros(num_features))
        self.register_buffer('running_var', torch.ones(num_features))

    def _shape(self, x):
        shape = [1] * x.dim()
        shape[self.axis] = -1
        return shape

    def forward(self, x):
        s = self._shape(x)
        if self.training:
            mean, var = batch_stats(x, self.axis)
            update_running_(self.running_mean, self.running_var, mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = (torch.rsqrt(var + self.eps) * self.weight).reshape(s)
        y = (x.to(torch.float32) - mean.reshape(s)) * mul
        return y + self.bias.reshape(s)


class Dropout(nn.Module):
    """flax ``nn.Dropout``: in training each element is kept with
    probability 1 - rate, drawn from the generator given, and scaled by
    1 / (1 - rate); the identity in eval mode or at rate 0."""

    def __init__(self, rate):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x, generator):
        if not self.training or self.rate == 0.0:
            return x
        keep_prob = 1.0 - self.rate
        keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
        return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype,
                                                            device=x.device))
