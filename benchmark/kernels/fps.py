"""B2, farthest point sampling (``fv2p_torch/ops/csrc/fps.cu``): the
program's module of its entry point, the entry point, its device function
as a trace names it, and its bound."""
from fvbench.bounds import bound_fps as bound  # noqa: F401

PROGRAM = 'fv2p_torch.ops.cuda.fps'
ENTRIES = ('fps_cuda',)
DEVICE_NAMES = ('fps_kernel',)
