# Frozen at commit c8e3fcd from fv2p_torch/models/layers.py, unchanged.
"""Layers with the numerics of the reference's flax layers.

``Dense``/``Conv2d``/``Conv3d``/``ConvTranspose2d`` keep f32 weights and compute in
``compute_dtype`` when one is set (input and weights cast to it, output in
it); without one they compute in f32, as flax infers from f32 parameters.
``BatchNorm`` is flax's BatchNorm (epsilon 1e-3 unless given, momentum
0.99): f32 statistics and output, ``(x - mean) * (scale * rsqrt(var + eps))
+ bias``, with the running statistics in eval mode and the batch's in
training. ``LayerNorm`` is flax's (epsilon 1e-6, the same statistics
formula as BatchNorm's), and ``DenseGeneral`` flax's product over several
input axes into several output axes, its kernel kept in flax's layout.
``Dropout`` is flax's, drawn from an explicit ``torch.Generator``.
``weights.load_flax_variables`` maps these modules onto flax param trees by
their dotted names.
"""
import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3
BN_MOMENTUM = 0.99      # running = 0.99 * running + 0.01 * batch
LN_EPS = 1e-6           # flax LayerNorm's epsilon


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


class Conv3d(nn.Conv3d):
    """flax ``nn.Conv`` with a 3-D kernel on NCDHW tensors, explicit padding
    (flax's grid is channels-last, (N, X, Y, Z, C); torch's is (N, C, X, Y,
    Z); the weight loader turns the (kX, kY, kZ, I, O) kernel into (O, I,
    kX, kY, kZ))."""

    def __init__(self, cin, cout, kernel_size, padding=0, bias=True,
                 compute_dtype=None):
        super().__init__(cin, cout, kernel_size, padding=padding, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = _dt(self.compute_dtype, x)
        b = None if self.bias is None else self.bias.to(dt)
        return F.conv3d(x.to(dt), self.weight.to(dt), b, self.stride, self.padding)


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


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last axis: f32 statistics (the mean and
    ``max(0, mean(x^2) - mean(x)^2)``), ``(x - mean) * (scale * rsqrt(var +
    LN_EPS)) + bias``."""

    def __init__(self, num_features):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x):
        xf = x.to(torch.float32)
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
        return (xf - mean) * (torch.rsqrt(var + LN_EPS) * self.weight) + self.bias


class DenseGeneral(nn.Module):
    """flax ``nn.DenseGeneral``: the last ``len(in_shape)`` axes of the input
    contracted with a kernel of shape ``in_shape + out_shape`` (flax's
    layout), plus a bias of ``out_shape``; multi-head attention's
    projections ((E,) -> (H, D) and (H, D) -> (E,))."""

    def __init__(self, in_shape, out_shape):
        super().__init__()
        self.n_in = len(in_shape)
        self.kernel = nn.Parameter(torch.empty(*in_shape, *out_shape))
        self.bias = nn.Parameter(torch.zeros(*out_shape))

    def forward(self, x):
        return torch.tensordot(x.to(self.kernel.dtype), self.kernel, dims=self.n_in) + self.bias


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
