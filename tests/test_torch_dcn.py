"""The port's modulated deformable convolution against the JAX one on the
CPU (``fv2p_tpu/ops/dcn.py``): the function, with offsets that reach past
every border of the map and a mask that is not uniform, and the two flax
modules through carried-across parameters, with the offset conv moved off
its zero initialisation so that the samples leave the grid.

Tolerances: f32 throughout, rtol 1e-4 with atol 1e-4 scaled to the output's
own magnitude where that is below 1 (``assert_close``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from fv2p_tpu.ops import dcn as jax_dcn
from tests.test_torch_model import assert_close, t

from fv2p_torch.ops import dcn
from fv2p_torch.weights import load_flax_variables

B, H, W = 2, 7, 9


def _dcn_inputs(seed, g, c=16, cout=12, reach=5.0):
    """x (B, H, W, C), offsets, mask and weights; offsets uniform in
    [-reach, reach] pixels, so whole samples fall outside the map, plus one
    tap of each sample row pinned to a floor of exactly -1 and one to h - 1
    or w - 1 (corners outside the map on one side)."""
    rng = np.random.RandomState(seed)
    k = 9
    x = rng.randn(B, H, W, c).astype(np.float32)
    dy = rng.uniform(-reach, reach, (B, H, W, g * k)).astype(np.float32)
    dx = rng.uniform(-reach, reach, (B, H, W, g * k)).astype(np.float32)
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing='ij')
    # tap 0 is (ky, kx) = (0, 0): its base is (y - 1, x - 1)
    dy[..., 0] = (-1.0 + 0.3) - (ys - 1.0)            # sample y = -0.7
    dx[..., 0] = (W - 1 + 0.6) - (xs - 1.0)            # sample x = w - 0.4
    mask = rng.uniform(0.0, 1.0, (B, H, W, g * k)).astype(np.float32)
    weights = (rng.randn(k, c, cout) / np.sqrt(k * c)).astype(np.float32)
    return x, dy, dx, mask, weights


def _sample_floors(dy, g):
    """floor(y) of every sample of the (B, H, W, G*K) offsets."""
    ky = np.repeat(np.arange(3), 3) - 1                 # tap order ky-major
    ys = np.arange(H)[None, :, None, None, None]
    sy = ys + ky + dy.reshape(B, H, W, g, 9)
    return np.floor(sy)


@pytest.mark.parametrize('g', [1, 4])
def test_modulated_deform_conv_matches_jax(g):
    x, dy, dx, mask, weights = _dcn_inputs(10 + g, g)
    floors = _sample_floors(dy, g)
    assert (floors < -1).any() and (floors > H - 1).any()     # whole samples out
    assert (floors == -1).any() and (floors == H - 1).any()   # one corner row out
    ref = jax_dcn.modulated_deform_conv(
        jnp.asarray(x), jnp.asarray(dy), jnp.asarray(dx), jnp.asarray(mask),
        jnp.asarray(weights), 3, g)
    got = dcn.modulated_deform_conv(t(x), t(dy), t(dx), t(mask), t(weights), 3, g)
    assert got.dtype == torch.float32
    assert_close(got, ref)
    assert float(np.abs(np.asarray(ref)).max()) > 0.1


@pytest.mark.parametrize('g', [1, 4])
def test_zero_offsets_and_unit_mask_give_a_plain_conv(g):
    x, dy, dx, _, weights = _dcn_inputs(20 + g, g)
    zeros = np.zeros_like(dy)
    got = dcn.modulated_deform_conv(t(x), t(zeros), t(zeros), t(np.ones_like(dy)),
                                    t(weights), 3, g)
    w = t(weights).reshape(3, 3, x.shape[-1], -1).permute(3, 2, 0, 1)
    ref = F.conv2d(t(x).permute(0, 3, 1, 2), w, padding=1).permute(0, 2, 3, 1)
    assert_close(got, ref.numpy())


def perturb_offset_conv(params, rng):
    """conv_offset_mask moved off its zero init: biases of a few pixels and a
    kernel that makes the offsets depend on the input."""
    out = {}
    for k, v in params.items():
        if hasattr(v, 'items'):
            out[k] = (perturb_offset_conv(v, rng) if k != 'conv_offset_mask'
                      else {'kernel': rng.randn(*v['kernel'].shape).astype(np.float32) * 0.3,
                            'bias': rng.uniform(-2.5, 2.5, v['bias'].shape).astype(np.float32)})
        else:
            out[k] = np.asarray(v)
    return out


@pytest.mark.parametrize('which', ['MdeformConvBlock', 'FeatureAdaption'])
def test_flax_modules_match_through_carried_params(which):
    rng = np.random.RandomState(30)
    c, cout = 16, 16
    x = rng.randn(B, H, W, c).astype(np.float32)
    if which == 'MdeformConvBlock':
        jmod = jax_dcn.MdeformConvBlock(cout, 3, deformable_groups=1)
        tmod = dcn.MdeformConvBlock(c, cout, 3, deformable_groups=1)
    else:
        jmod = jax_dcn.FeatureAdaption(cout, 3, deformable_groups=4)
        tmod = dcn.FeatureAdaption(c, cout, 3, deformable_groups=4)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))['params']
    params = perturb_offset_conv(jax.tree_util.tree_map(np.asarray, dict(params)), rng)
    ref = jmod.apply({'params': jax.tree_util.tree_map(jnp.asarray, params)},
                     jnp.asarray(x))
    holder = nn.Module()
    holder.m = tmod
    load_flax_variables(holder, {'params': {'m': params}})
    with torch.no_grad():
        got = tmod(t(x))
    assert_close(got, ref)
    assert float(np.abs(np.asarray(ref)).max()) > 0.1
