"""Sparse convolution forward without autograd: one implicit GEMM over the
neighbour table, the gathered rows kept in shared memory.

CUDA kernel: ``ops/csrc/sparse_conv.cu``. It replaces no Pallas kernel:
JAX runs the conv as XLA's gather + dot (``fv2p_tpu/ops/sparse/conv.py``),
and ``ops/sparse/conv.py`` as PyTorch's gather and cuBLAS, which writes the
(N_out, K * Cin) gathered rows to device memory. ``ops/sparse/conv.py``
sends the no-grad bf16 forward on the card here; a call that autograd
records keeps ``_SparseConvFn``.

The function is that of ``_SparseConvFn``'s forward followed by the conv
module's bias and mask: bf16 products, f32 sums, the sum rounded to bf16
once and widened to f32, then + bias (f32) and 0.0 on rows that are not
valid. An index equal to N_in is the zero row.
"""
import torch

from ...utils import tracing
from . import aligned, check_launch, library, require, stream_handle

MAX_CIN = 128
COUTS = (16, 32, 64, 128)
MAX_TAPS = 32
INT32_MAX = 2 ** 31 - 1


def sparse_conv_fwd_plain(features, weight, nbr, bias=None, valid=None):
    """features (N_in, Cin), weight (K, Cin, Cout), nbr (N_out, K) int64 in
    [0, N_in], bias (Cout,) or None, valid (N_out,) bool or None ->
    (N_out, Cout) float32."""
    k, cin, cout = weight.shape
    padded = torch.cat([features, features.new_zeros((1, cin))], dim=0)
    gathered = padded[nbr].reshape(nbr.shape[0], k * cin)
    out = (gathered @ weight.reshape(k * cin, cout)).to(torch.float32)
    if bias is not None:
        out = out + bias
    if valid is not None:
        out = out.masked_fill(~valid[:, None], 0.0)
    return out


def check_operands(features, weight, nbr, bias=None, valid=None):
    """Raise ValueError on operands the kernel does not take, the device
    aside: dtypes, contiguity, shapes, the kernel's limits, one device."""
    require(features.dim() == 2 and weight.dim() == 3 and nbr.dim() == 2,
            'features (N_in, Cin), weight (K, Cin, Cout), nbr (N_out, K)')
    k, cin, cout = weight.shape
    n_in, n_out = features.shape[0], nbr.shape[0]
    named = [(features, 'features', torch.bfloat16, (n_in, cin)),
             (weight, 'weight', torch.bfloat16, (k, cin, cout)),
             (nbr, 'nbr', torch.int64, (n_out, k))]
    if bias is not None:
        named.append((bias, 'bias', torch.float32, (cout,)))
    if valid is not None:
        named.append((valid, 'valid', torch.bool, (n_out,)))
    for t, name, dtype, shape in named:
        require(t.dtype == dtype, f'{name} must be {dtype}, got {t.dtype}')
        require(t.is_contiguous(), f'{name} must be contiguous')
        require(tuple(t.shape) == shape,
                f'{name} must have shape {shape}, got {tuple(t.shape)}')
        require(t.device == features.device,
                f'{name} must lie on the features\' device')
    require(1 <= cin <= MAX_CIN, f'Cin must lie in [1, {MAX_CIN}], got {cin}')
    require(cout in COUTS, f'Cout must be one of {COUTS}, got {cout}')
    require(1 <= k <= MAX_TAPS, f'K must lie in [1, {MAX_TAPS}], got {k}')
    require(n_in < INT32_MAX and n_out * k <= INT32_MAX,
            "rows past the kernel's 32-bit indexing")


def sparse_conv_fwd_cuda(features, weight, nbr, bias=None, valid=None):
    require(features.is_cuda, 'features must be a CUDA tensor')
    check_operands(features, weight, nbr, bias, valid)
    (n_in, cin), (n_out, k), cout = features.shape, nbr.shape, weight.shape[2]
    out = torch.empty((n_out, cout), dtype=torch.float32, device=features.device)
    if n_out == 0:
        return out
    # the kernel copies rows of these two in 16-byte pieces
    features, weight = aligned(features), aligned(weight)
    lib = library('sparse_conv')
    code = lib.fv2p_sparse_conv_fwd(
        features.data_ptr(), weight.data_ptr(), nbr.data_ptr(),
        None if bias is None else bias.data_ptr(),
        None if valid is None else valid.data_ptr(), out.data_ptr(),
        n_in, n_out, cin, cout, k, stream_handle(features.device))
    check_launch('sparse_conv', lib, code)
    tracing.count('launches.sparse_conv')
    return out


def sparse_conv_fwd(features, weight, nbr, bias=None, valid=None):
    """Dispatch: plain version for CPU tensors, the CUDA kernel otherwise."""
    if features.device.type == 'cpu':
        return sparse_conv_fwd_plain(features, weight, nbr, bias, valid)
    return sparse_conv_fwd_cuda(
        features.contiguous(), weight.contiguous(), nbr.contiguous(),
        None if bias is None else bias.contiguous(),
        None if valid is None else valid.contiguous())
