# Frozen at commit c8e3fcd from fv2p_torch/ops/cuda/sa_group.py; the CUDA launch left out: the dispatcher runs the plain version.
"""Fused two-radius set abstraction: ball query + 2-layer MLP + max over
slots (kernel B4).

CUDA kernel: ``ops/csrc/sa_group.cu``; it replaces the Pallas kernel
``fv2p_tpu/ops/pallas/sa_group.py:sa_group_pool_fused``. Layer 1 arrives
precomputed per point (``z = xyz @ W1x + feats @ W1f``, bf16) with the
center term ``cw = centers @ W1x - b1`` (f32); h1 is rounded to bf16 and
layer 2 accumulates in f32. The hidden width H is 64 for both layers, so
the output (R, G, 2H) is radius-0 channels | radius-1 channels, in bf16.
"""
import torch

from ..pointops import first_k_hits

HIDDEN = 64
MAX_NSAMPLE = 32


def sa_group_pool_plain(centers, xyz, valid, z, cw, w2, b1, b2, radii,
                        nsamples):
    """centers (R, G, 3) f32, xyz (R, P, 3) f32, valid (R, P) bool,
    z (2, R, P, H) bf16, cw (2, R, G, H) f32, w2 (2, H, H) bf16,
    b1/b2 (2, H) f32 -> (R, G, 2H) bf16."""
    c = centers.to(torch.float32)
    x = xyz.to(torch.float32)
    d2 = ((c[:, :, None, 0] - x[:, None, :, 0]) ** 2
          + (c[:, :, None, 1] - x[:, None, :, 1]) ** 2
          + (c[:, :, None, 2] - x[:, None, :, 2]) ** 2)          # (R, G, P)
    r, g, p = d2.shape
    outs = []
    for i, (rad, ns) in enumerate(zip(radii, nsamples)):
        idx = first_k_hits((d2 < rad * rad) & valid[:, None, :], ns)
        any_hit = idx[..., :1] >= 0                                # (R, G, 1)
        idx = torch.where(idx >= 0, idx, idx[..., :1].clamp(min=0))
        rows = torch.gather(
            z[i].float(), 1,
            idx.reshape(r, g * ns, 1).expand(r, g * ns, z.shape[-1]).long())
        t = torch.where(any_hit[..., None],
                        rows.reshape(r, g, ns, -1), 0.0)          # (R,G,S,H)
        cwi = torch.where(any_hit, cw[i].float(), -b1[i].float())
        h1 = torch.relu(t - cwi[:, :, None, :]).to(torch.bfloat16)
        h2 = torch.relu(h1.float() @ w2[i].float() + b2[i].float())
        outs.append(h2.amax(dim=2))
    return torch.cat(outs, dim=-1).to(torch.bfloat16)


def sa_group_pool_fused(centers, xyz, valid, z, cw, w2, b1, b2, radii,
                        nsamples):
    return sa_group_pool_plain(centers, xyz, valid, z, cw, w2, b1, b2, radii,
                               nsamples)
