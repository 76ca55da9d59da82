"""The yardstick's arithmetic against hand counts on tiny shapes: the kernel
bounds and the model-operation counter."""
import pytest
import torch

from fvbench import bounds
from fvbench.measure import OpCounter
from refnet.models.layers import Conv2d, ConvTranspose2d, Dense
from refnet.ops.dcn import MdeformConvBlock
from refnet.ops.sparse.conv import SubMConv3d
from refnet.ops.sparse.sparse_tensor import INVALID_KEY, SparseTensor


def test_rotated_iou_bound_counts_every_pair():
    boxes_a, boxes_b = torch.zeros(3, 7), torch.zeros(5, 7)
    t_bytes, t_ops = bounds.bound_rotated_iou(('iou_bev_cuda', (boxes_a, boxes_b)))
    assert t_bytes == pytest.approx(((3 + 5) * 28 + 15 * 4) / bounds.HBM_BYTES_S)
    assert t_ops == pytest.approx(15 * bounds.CLIP_OPS_PER_PAIR / bounds.F32_OPS_S)
    _, t_upper = bounds.bound_rotated_iou(('iou_bev_upper_cuda', (boxes_a,)))
    assert t_upper == pytest.approx(3 * bounds.CLIP_OPS_PER_PAIR / bounds.F32_OPS_S)


def test_fps_and_three_nn_bounds_count_valid_points():
    pts = torch.zeros(2, 10, 3)
    valid = torch.zeros(2, 10, dtype=torch.bool)
    valid[0, :4] = True
    valid[1, :6] = True
    _, ops = bounds.bound_fps(('fps_cuda', (pts, valid, 5)))
    assert ops == pytest.approx(10 * 4 * 10 / bounds.F32_OPS_S)
    _, ops = bounds.bound_three_nn(('three_nn_cuda', (pts, valid, torch.zeros(2, 7, 3))))
    assert ops == pytest.approx(10 * 7 * 10 / bounds.F32_OPS_S)


def test_sa_slots_count_ball_hits_capped_by_nsample():
    centers = torch.zeros(1, 2, 3)
    xyz = torch.tensor([[[0.1, 0, 0], [0.2, 0, 0], [5.0, 0, 0]]])
    valid = torch.ones(1, 3, dtype=torch.bool)
    args = (centers, xyz, valid, None, None, None, None, None, (0.5, 10.0), (1, 4))
    assert bounds.sa_slots(args) == [2 * 1, 2 * 3]


def test_dcn_bounds():
    x = torch.zeros(1, 4, 5, 8, dtype=torch.bfloat16)
    off = torch.zeros(1, 4, 5, 9)
    w = torch.zeros(9, 8, 16, dtype=torch.bfloat16)
    args = (x, off, off, off, w, 3, 1)
    _, ops, macs = bounds.bound_dcn(args)
    assert macs == 4 * 5 * 9 * 8 * 16 and ops == pytest.approx(2 * macs / bounds.BF16_OPS_S)
    _, ops_b, macs_b = bounds.bound_dcn_backward(args)
    assert macs_b == 2 * macs and ops_b == pytest.approx(2 * ops)


def test_kernel_names_map_trace_ops_to_kernels():
    from conftest import BENCH
    from fvbench.cell import kernel_of, load_kernels
    kernels = load_kernels(BENCH)
    assert set(kernels) == {'rotated_iou', 'fps', 'three_nn', 'sa_group'}
    assert kernel_of(kernels, 'void fps_kernel<Shape<8>>(float*)') == 'fps'
    assert kernel_of(kernels, 'three_nn_prep_kernel') == 'three_nn'
    assert kernel_of(kernels, 'ampere_sgemm_128x64') is None
    assert kernels['fps'].bound is bounds.bound_fps


def test_op_counter_counts_what_the_inputs_need():
    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.fc = Dense(6, 4)
            self.conv = Conv2d(3, 5, 3, padding=1)
            self.up = ConvTranspose2d(5, 2, 2)
            self.dcn = MdeformConvBlock(5, 7, 3, 1)
            self.sub = SubMConv3d(2, 3, 3)

        def forward(self, x, img, st, nbr):
            self.fc(x)
            y = self.conv(img)
            self.up(y)
            self.dcn(y.permute(0, 2, 3, 1))
            self.sub(st, nbr)

    net = Net()
    x = torch.randn(10, 6)
    img = torch.randn(1, 3, 4, 4)
    st = SparseTensor(features=torch.randn(5, 2),
                      keys=torch.tensor([0, 1, 2, INVALID_KEY, INVALID_KEY]),
                      spatial_shape=(2, 2, 2))
    nbr = torch.full((5, 27), 5, dtype=torch.int64)      # row 5: the zero pad row
    nbr[0, :3] = torch.tensor([0, 1, 2])
    nbr[1, 13] = 1
    nbr[2, 4] = 0
    with OpCounter(net) as counter:
        net(x, img, st, nbr)
    expected = (2 * 10 * 6 * 4                       # Dense
                + 2 * (5 * 4 * 4) * 3 * 9            # conv
                + 2 * (5 * 4 * 4) * 2 * 4            # transposed conv, kernel 2x2
                + 2 * (27 * 4 * 4) * 5 * 9           # the DCN's offset conv
                + 2 * 4 * 4 * 9 * 5 * 7              # the deformable product
                + 2 * 5 * 2 * 3)                     # 5 active pairs x Cin x Cout
    assert counter.ops == expected
