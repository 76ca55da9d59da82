"""The control of ``correct`` (the reference one precision below the
configuration's, in the program's place) fails a cell's limits: on the CPU
at the tiny cells' size, and, on a machine with the card, at each real
cell's own size on three seeds; there a sound witness (the reference
summing its products in another order, in the program's place) passes
them (``python -m pytest -m cuda -n 0 benchmark/tests/test_bench_control.py``)."""
import json

import pytest

from conftest import REPO
from fvbench import control
from fvbench.cell import Cell

CELLS = [w['name'] for w in json.loads((REPO / 'BENCHMARK.json').read_text())['workloads']]
# the cells whose limits let a change of summation order pass (a limits file
# says ``reorder_passes: false`` where the control needs a number on which
# such a change reads as far off)
REORDER_CELLS = [w for w in CELLS if Cell(w).limits.get('reorder_passes', True)]
CONTROL_SEEDS = (2 ** 31 + 101, 2 ** 31 + 103, 2 ** 31 + 107)
WITNESS_SEEDS = (2 ** 31 + 211, 2 ** 31 + 223, 2 ** 31 + 227)


def _fails(cell, readings):
    return [k for k, limit in cell.limits['limits'].items() if not readings[k] <= limit]


@pytest.mark.parametrize('workload', ['tiny_fv2p_infer', 'tiny_mgaf_infer',
                                      'tiny_fv2p_train', 'tiny_mgaf_train'])
def test_the_control_fails_the_tiny_cells(tiny_repo, workload):
    cell = Cell(workload, tiny_repo)
    assert _fails(cell, control.readings(cell, 2 ** 31 + 5, device='cpu'))


def test_the_witness_sums_the_same_bf16_products_in_f32():
    import torch
    from fvbench.reference import F32Sums
    g = torch.Generator().manual_seed(3)
    a, b = (torch.randn(64, 256, generator=g).bfloat16() for _ in range(2))
    with F32Sums():
        got = a @ b.t()
        same = a.float() @ b.float().t()
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, (a.float() @ b.float().t()).bfloat16())
    assert same.dtype == torch.float32


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the cells run at their published widths there')


@pytest.mark.cuda
@pytest.mark.parametrize('workload', CELLS)
def test_the_control_fails_each_cell_on_the_card(card, workload):
    cell = Cell(workload)
    for seed in CONTROL_SEEDS:
        assert _fails(cell, control.readings(cell, seed)), seed


@pytest.mark.cuda
@pytest.mark.parametrize('workload', REORDER_CELLS)
def test_a_change_of_summation_order_passes_each_cell_on_the_card(card, workload):
    cell = Cell(workload)
    for seed in WITNESS_SEEDS:
        assert not _fails(cell, control.readings(cell, seed, side='reorder')), seed
