"""B4, the set-abstraction grouping and pooling
(``fv2p_torch/ops/csrc/sa_group.cu``): the program's module of its entry
point, the entry point, its device function as a trace names it, and its
bound."""
from fvbench.bounds import bound_sa_group as bound  # noqa: F401

PROGRAM = 'fv2p_torch.ops.cuda.sa_group'
ENTRIES = ('sa_group_pool_cuda',)
DEVICE_NAMES = ('sa_group_kernel',)
