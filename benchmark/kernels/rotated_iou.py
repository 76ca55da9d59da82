"""B1, the rotated BEV IoU (``fv2p_torch/ops/csrc/rotated_iou.cu``): the
program's module of its entry points, the entry points, its device
functions as a trace names them, and its bound."""
from fvbench.bounds import bound_rotated_iou as bound  # noqa: F401

PROGRAM = 'fv2p_torch.ops.cuda.rotated_iou'
ENTRIES = ('overlap_matrix_cuda', 'iou_bev_cuda', 'iou_bev_upper_cuda')
DEVICE_NAMES = ('overlap_kernel',)
