"""B3, the three nearest neighbours (``fv2p_torch/ops/csrc/three_nn.cu``):
the program's module of its entry point, the entry point, its device
functions as a trace names them, and its bound."""
from fvbench.bounds import bound_three_nn as bound  # noqa: F401

PROGRAM = 'fv2p_torch.ops.cuda.three_nn'
ENTRIES = ('three_nn_cuda',)
DEVICE_NAMES = ('three_nn_prep_kernel', 'three_nn_kernel')
