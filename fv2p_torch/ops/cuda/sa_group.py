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

from ...utils import tracing
from ..pointops import first_k_hits
from . import (aligned, check_launch, check_tensor, library, require,
               stream_handle)

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


def sa_group_pool_cuda(centers, xyz, valid, z, cw, w2, b1, b2, radii,
                       nsamples):
    r, g, _ = centers.shape
    p = xyz.shape[1]
    h = HIDDEN
    check_tensor(centers, 'centers', torch.float32, (r, g, 3))
    check_tensor(xyz, 'xyz', torch.float32, (r, p, 3))
    check_tensor(valid, 'valid', torch.bool, (r, p))
    check_tensor(z, 'z', torch.bfloat16, (2, r, p, h))
    check_tensor(cw, 'cw', torch.float32, (2, r, g, h))
    check_tensor(w2, 'w2', torch.bfloat16, (2, h, h))
    check_tensor(b1, 'b1', torch.float32, (2, h))
    check_tensor(b2, 'b2', torch.float32, (2, h))
    require(len(radii) == len(nsamples) == 2, 'two radii')
    require(all(1 <= n <= MAX_NSAMPLE for n in nsamples),
            f'nsample must lie in [1, {MAX_NSAMPLE}]')
    require(p <= 8192, 'at most 8192 pooled points per RoI')
    out = torch.empty((r, g, 2 * h), dtype=torch.bfloat16,
                      device=centers.device)
    # the kernel copies rows of these three in 16-byte pieces
    z, cw, w2 = aligned(z), aligned(cw), aligned(w2)
    lib = library('sa_group')
    code = lib.fv2p_sa_group(
        centers.data_ptr(), xyz.data_ptr(), valid.data_ptr(), z.data_ptr(),
        cw.data_ptr(), w2.data_ptr(), b1.data_ptr(), b2.data_ptr(),
        out.data_ptr(), r, g, p, float(radii[0]) ** 2,
        float(radii[1]) ** 2, int(nsamples[0]), int(nsamples[1]),
        stream_handle(centers.device))
    check_launch('sa_group', lib, code)
    tracing.count('launches.sa_group')
    return out


def sa_group_pool_fused(centers, xyz, valid, z, cw, w2, b1, b2, radii,
                        nsamples):
    """Dispatch: plain version for CPU tensors, the CUDA kernel otherwise."""
    args = (centers, xyz, valid, z, cw, w2, b1, b2, radii, nsamples)
    if centers.device.type == 'cpu':
        return sa_group_pool_plain(*args)
    return sa_group_pool_cuda(
        centers.float().contiguous(), xyz.float().contiguous(),
        valid.contiguous(), z.to(torch.bfloat16).contiguous(),
        cw.float().contiguous(), w2.to(torch.bfloat16).contiguous(),
        b1.float().contiguous(), b2.float().contiguous(), radii, nsamples)
