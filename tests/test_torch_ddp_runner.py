"""Multi-GPU data parallelism of the port: the runs around the step
(``tests/test_torch_ddp.py`` holds the step to JAX's), on the CPU over gloo
ranks in spawned processes (``tests/ddp_worker.py``).

* At world size 1, two steps over the DDP wrapper equal two plain steps.
* The training sampler gives every rank one permutation.
* A two-rank run of each runner on the KITTI fixture: the eval's merged
  detections, recall and AP equal a one-rank eval's; the train runner's
  ranks take the single-rank step count and only rank 0 writes.
* The dry run on the CPU prints its two OK lines, each after two steps.
"""
import pickle
from pathlib import Path

import numpy as np

from tests import ddp_worker
from tests.test_torch_ddp import WORLD, fv2p_setup, write_spec
from tests.test_torch_runner import N_SCANS, _eval_keys, _runner_cfg_file, tiny_cfg_dict

import pytest

from fv2p_torch import parallel
from fv2p_torch.parallel import dryrun
from fv2p_torch.tools import test as test_runner, train as train_runner

REPO = Path(__file__).resolve().parent.parent
KITTI = REPO / 'data' / 'kitti'


def test_world_size_one_ddp_step_equals_train_step(tmp_path):
    """Two steps of the tiny FV2P through the DDP wrapper at one rank and
    through the bare model, in one process on one thread: every loss term,
    parameter and running statistic identical."""
    s = fv2p_setup()
    s['draws'] = None                   # the port's own generators on both sides
    spec = write_spec(s, tmp_path / 'spec.pkl', 2)
    got = parallel.launch(ddp_worker.ddp_equals_plain, 1, (str(spec),), 'cpu',
                          result_path=tmp_path / 'result.pkl')
    assert got['loss_diff'] == 0.0 and got['state_diff'] == 0.0
    assert got['terms'] > 5


def test_sampler_gives_every_rank_one_permutation(tmp_path):
    """Two ranks whose global generators differ: each epoch, the ranks'
    slices of each global batch of 4 come from one permutation (rank 0's
    draw, as a one-rank sampler makes it), disjoint; an epoch has the
    single-rank step count."""
    import torch
    from fv2p_torch.datasets import GlobalBatchSampler
    n, b, epochs, seed = 11, 4, 2, 5
    ranks = parallel.launch(ddp_worker.sampler_orders, WORLD, (n, b, epochs, seed), 'cpu',
                            result_path=tmp_path / 'orders.pkl')
    torch.manual_seed(seed)
    single = GlobalBatchSampler(n, b)
    for epoch in range(epochs):
        ref = list(single)
        assert sorted(ref) == sorted(set(ref)) and len(ref) == n // b * b
        for k in range(n // b):
            got = ranks[0]['orders'][epoch][2 * k:2 * k + 2] + \
                ranks[1]['orders'][epoch][2 * k:2 * k + 2]
            assert got == ref[k * b:(k + 1) * b]
    assert ranks[0]['len'] // (b // WORLD) == n // b == len(single) // b


# ------------------------------------------------------------ runners

@pytest.fixture(scope='module')
def runner_cfg(tmp_path_factory):
    """The tiny FV2P of ``tests/test_torch_runner.py`` over the first
    N_SCANS train and val scans of data/kitti."""
    d = tmp_path_factory.mktemp('ddp_runner')
    infos = {}
    for split in ('train', 'val'):
        with open(KITTI / f'kitti_infos_{split}.pkl', 'rb') as f:
            cut = pickle.load(f)[:N_SCANS]
        infos[split] = d / f'kitti_infos_{split}_first{N_SCANS}.pkl'
        infos[split].write_bytes(pickle.dumps(cut))
    return _runner_cfg_file(tiny_cfg_dict(), infos, d / 'tiny_fv2p.yaml')


def test_two_rank_eval_merges_to_the_one_rank_result(runner_cfg, tmp_path):
    """``--num_devices 2`` on the CPU: rank 0 gathers the ranks' detections
    (scans 0, 2 and 1, 3) back into dataset order; the KITTI-format files
    (class and count of every line, every number within one unit of its
    4th decimal), the recall and the AP (within 1e-4) equal a one-rank
    eval's. Each rank runs on half the host's threads, another summation
    order: the numbers agree to rounding, not bit for bit."""
    common = ['--cfg_file', str(runner_cfg), '--device', 'cpu', '--dtype', 'float32',
              '--workers', '0', '--batch_size', '1', '--save_to_file']
    one = test_runner.main(common + ['--output_dir', str(tmp_path / 'one')])
    two = test_runner.main(common + ['--output_dir', str(tmp_path / 'two'),
                                    '--num_devices', str(WORLD)])
    assert _eval_keys(two) == _eval_keys(one)
    for k in _eval_keys(one):
        assert abs(two[k] - one[k]) <= 1e-4, k
    assert any(k.startswith('Car_3d/') for k in one)
    files = {run: sorted((tmp_path / run / 'eval').glob('[0-9]*.txt')) for run in ('one', 'two')}
    assert len(files['one']) == N_SCANS
    assert [f.name for f in files['two']] == [f.name for f in files['one']]
    lines = 0
    for a, b in zip(files['two'], files['one']):
        rows_a, rows_b = (f.read_text().splitlines() for f in (a, b))
        assert len(rows_a) == len(rows_b), a.name
        for ra, rb in zip(rows_a, rows_b):
            assert ra.split()[0] == rb.split()[0]
            np.testing.assert_allclose(np.array(ra.split()[1:], float),
                                       np.array(rb.split()[1:], float), rtol=0, atol=1.5e-4)
        lines += len(rows_b)
    assert lines > 0


def test_two_rank_train_runner_writes_on_rank_zero(runner_cfg, tmp_path):
    """``--num_devices 2`` at a global batch of 2 over 4 scans: 2 steps an
    epoch, as on one rank, finite losses; one log file, one metrics file of
    2 lines, the checkpoints of rank 0."""
    out = tmp_path / 'run'
    rec = train_runner.main(['--cfg_file', str(runner_cfg), '--device', 'cpu', '--dtype',
                             'float32', '--workers', '0', '--batch_size', '2', '--epochs', '1',
                             '--output_dir', str(out), '--fix_random_seed',
                             '--num_devices', str(WORLD)])
    assert 'trainer' not in rec and len(rec['steps']) == N_SCANS // 2
    assert all(np.isfinite(v) for st in rec['steps'] for v in st.values())
    assert len(list(out.glob('log_train_*.txt'))) == 1
    assert len((out / 'metrics.jsonl').read_text().splitlines()) == N_SCANS // 2
    assert [p.name for _, p in test_runner.checkpoint_list(out / 'ckpt')] == \
        ['checkpoint_epoch_1.pth']


# ------------------------------------------------------------ dry run

def test_dryrun_prints_its_two_ok_lines(capfd):
    dryrun.dryrun_multichip(WORLD, 'cpu')
    lines = [ln for ln in capfd.readouterr().out.splitlines() if ln.startswith('dryrun')]
    assert [ln.split(':')[0] for ln in lines] == [
        f'dryrun_multichip({WORLD}) [mgaf]', f'dryrun_multichip({WORLD}) [fv2p]',
        f'dryrun_multichip({WORLD})']
    assert lines[-1].endswith('ALL OK [mgaf, fv2p]')
    assert all(f'OK, {dryrun.STEPS} steps,' in ln for ln in lines[:2]) and dryrun.STEPS == 2
    assert all(np.isfinite(float(ln.split('loss=')[1])) for ln in lines[:2])
