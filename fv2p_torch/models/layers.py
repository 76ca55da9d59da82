"""Layers with the numerics of the reference's flax layers.

``Dense``/``Conv2d``/``ConvTranspose2d`` keep f32 weights and compute in
``compute_dtype`` when one is set (input and weights cast to it, output in
it); without one they compute in f32, as flax infers from f32 parameters.
``BatchNorm`` is the eval-mode flax BatchNorm (epsilon 1e-3 unless given):
f32 statistics and output, ``(x - mean) * (scale * rsqrt(var + eps)) + bias``.
``weights.load_flax_variables`` maps these modules onto flax param trees by
their dotted names.
"""
import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3


def _dt(compute_dtype, x):
    return compute_dtype or torch.promote_types(x.dtype, torch.float32)


class Dense(nn.Linear):
    """flax ``nn.Dense`` over the last axis."""

    def __init__(self, in_features, out_features, bias=True,
                 compute_dtype=None):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = compute_dtype

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


class BatchNorm(nn.Module):
    """Eval-mode flax BatchNorm over ``axis`` (default: the last axis)."""

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
        mul = (torch.rsqrt(self.running_var + self.eps) * self.weight).reshape(s)
        y = (x.to(torch.float32) - self.running_mean.reshape(s)) * mul
        return y + self.bias.reshape(s)
