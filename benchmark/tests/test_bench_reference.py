"""The frozen reference against the port at a tiny size on the CPU (f32 on
both sides, the port's kernels in their plain versions): the same
detections and the same first train step from the same inputs and state.
The reference builds its own voxel tables with the numpy builder."""
import numpy as np
import pytest
import torch

from fvbench import harness, program, reference
from fvbench.cell import Cell, dataset_meta


def _inputs(cell, seed):
    meta = dataset_meta(cell.cfg, cell.traffic['voxel_cap'])
    pool = harness.draw_pool(cell, seed, meta)
    state, _ = harness.make_state(cell, seed, meta, pool, 'cpu')
    return meta, pool, state


@pytest.mark.parametrize('workload', ['tiny_fv2p_infer', 'tiny_mgaf_infer'])
def test_reference_detections_equal_the_ports(tiny_repo, workload):
    cell = Cell(workload, tiny_repo)
    meta, pool, state = _inputs(cell, 7)
    ref = reference.build_model(cell.cfg, meta, 'cpu')
    ref.load_state_dict(state)
    got = reference.detections(ref, harness.prepared(reference, cell, pool[0], meta, 'cpu'))
    port = program.build_model(cell.config['cfg'], meta, torch.float32, state, 'cpu')
    out = port(dict(harness.prepared(program, cell, pool[0], meta, 'cpu')))
    assert got['pred_valid'].sum() > 0
    for k in reference.PRED_KEYS:
        np.testing.assert_allclose(got[k], out[k].numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('workload', ['tiny_fv2p_train', 'tiny_mgaf_train'])
def test_reference_train_step_equals_the_ports(tiny_repo, workload):
    cell = Cell(workload, tiny_repo)
    meta, pool, state = _inputs(cell, 7)
    ref = reference.build_model(cell.cfg, meta, 'cpu')
    ref.load_state_dict(state)
    losses, grads, _ = reference.train_steps(
        ref, cell.cfg.OPTIMIZATION, cell.traffic['total_steps'],
        [harness.prepared(reference, cell, pool[0], meta, 'cpu')])
    port = program.build_model(cell.config['cfg'], meta, torch.float32, state, 'cpu')
    step = program.train_step(port, cell.config['cfg'], cell.traffic['total_steps'])
    p_losses, p_grads, _ = harness.checked_steps(
        step, [harness.prepared(program, cell, pool[0], meta, 'cpu')], 1)
    for k, v in losses[0].items():
        assert p_losses[0][k] == pytest.approx(v, rel=1e-5, abs=1e-6), k
    for g, pg in zip(grads, p_grads):
        torch.testing.assert_close(pg, g, rtol=1e-4, atol=1e-4 * float(g.abs().max()) + 1e-7)
