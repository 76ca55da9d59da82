"""The port's nuScenes data path and native evaluator against the JAX
package on the CPU, and the train runner's device-mode overflow check.

* ``NuScenesDataset`` on the committed fixture (``data/nuscenes``) with
  ``cbgs_second_multihead.yaml``'s DATA_CONFIG: the CBGS resampling and
  the samples array for array, for training (gt sampling of 10 classes,
  flip, rotation, scaling) and for test. JAX draws from numpy's global
  generator after ``np.random.seed(s)``, the port from the dataset's
  ``RandomState(s)``, given to its constructor since the resampling draws
  there.
* ``get_sweep`` and ``get_lidar_with_sweeps`` on a sweep file the test
  writes (the fixture's infos have no sweeps).
* The native evaluator's result dict key for key: on JAX's own cases
  (``tests/test_nuscenes_eval_native.py``, each run with both evaluators)
  and on the fixture's val split with perturbed ground truth as detections.
* The train runner with ``--rulebooks device``: a level capacity that drops
  rows raises within LOG_INTERVAL steps of the first such step and before
  any checkpoint; a run that drops nothing reads the same losses and
  writes the same checkpoint whatever the interval of the check.

Tolerances: samples, result dicts and losses exact (the same numpy code and
the same draws; the two runs of the last check are the same computation).
"""
import copy
from pathlib import Path

import numpy as np
import pytest
import torch

from fv2p_tpu.config import EasyDict as JaxEasyDict
from fv2p_tpu.config import cfg_from_yaml_file as jax_cfg_from_yaml_file
from fv2p_tpu.datasets.nuscenes import nuscenes_eval_native as jax_native
from fv2p_tpu.datasets.nuscenes.nuscenes_dataset import NuScenesDataset as JaxNuScenes
from tests import test_nuscenes_eval_native as jax_native_cases
from tests.test_torch_data import _assert_samples_equal
from tests.test_torch_runner import (_runner_cfg_file, _train, cut_infos,  # noqa: F401
                                     tiny_cfg_dict)

from fv2p_torch.config import EasyDict, cfg_from_yaml_file
from fv2p_torch.datasets import build_dataset
from fv2p_torch.datasets.nuscenes import nuscenes_eval_native
from fv2p_torch.datasets.nuscenes.nuscenes_dataset import NuScenesDataset
from fv2p_torch.tools import train

REPO = Path(__file__).resolve().parent.parent
NUSC = REPO / 'data' / 'nuscenes'
CBGS_YAML = str(REPO / 'tools/cfgs/nuscenes_models/cbgs_second_multihead.yaml')


def _cfgs():
    jcfg, tcfg = JaxEasyDict(), EasyDict()
    jax_cfg_from_yaml_file(CBGS_YAML, jcfg)
    cfg_from_yaml_file(CBGS_YAML, tcfg)
    return jcfg, tcfg


def _datasets(training, seed):
    jcfg, tcfg = _cfgs()
    np.random.seed(seed)
    jds = JaxNuScenes(jcfg.DATA_CONFIG, jcfg.CLASS_NAMES, training=training, root_path=NUSC)
    tds = build_dataset(tcfg.DATA_CONFIG, tcfg.CLASS_NAMES, training=training,
                        rng=np.random.RandomState(seed))
    return jds, tds


@pytest.mark.parametrize('training', [True, False], ids=['train', 'test'])
def test_nuscenes_samples_match_jax(training):
    """The resampled infos in order, then three samples in a row: 5-feature
    voxels at the 60000 cap, gt rows [x y z dx dy dz heading vx vy cls]
    padded to MAX_GT_BOXES, the metadata token."""
    jds, tds = _datasets(training, seed=7)
    assert isinstance(tds, NuScenesDataset)
    assert [i['token'] for i in tds.infos] == [i['token'] for i in jds.infos]
    assert len(tds) == (40 if training else 2)
    for index in range(3 if training else 2):
        ref, got = jds[index], tds[index]
        _assert_samples_equal(got, ref)
        assert got['voxels'].shape == (60000, 10, 5)
        assert got['gt_boxes'].shape == (50, 10)
        assert int(got['voxel_valid'].sum()) > 20000
        assert (got['gt_boxes'][:, -1] > 0).sum() >= 1
    batch = tds.collate_batch([tds[0], tds[1]])
    ref = jds.collate_batch([jds[0], jds[1]])
    assert [m['token'] for m in batch['metadata']] == [m['token'] for m in ref['metadata']]
    assert batch['voxels'].shape == (2, 60000, 10, 5)


def test_gt_sampling_rows_past_max_gt_boxes_are_counted():
    """A train sample's gt rows past MAX_GT_BOXES are dropped, as JAX drops
    them (``ROADMAP.md`` C), and counted on the dataset."""
    _, tds = _datasets(True, seed=3)
    tds.max_gt_boxes = 4
    sample = tds[0]
    assert (sample['gt_boxes'][:, -1] > 0).sum() == 4
    assert tds.gt_rows_dropped > 0


def _write_sweep(root, rng):
    pts = rng.uniform(-20, 20, (300, 5)).astype(np.float32)
    pts[:40, :2] = rng.uniform(-0.9, 0.9, (40, 2))          # ego points, removed
    (root / 'sweeps').mkdir(parents=True, exist_ok=True)
    pts.tofile(str(root / 'sweeps' / 's0.bin'))
    tm = np.eye(4)
    c, s = np.cos(0.3), np.sin(0.3)
    tm[:2, :2] = [[c, -s], [s, c]]
    tm[:3, 3] = [1.5, -2.0, 0.1]
    return {'lidar_path': 'sweeps/s0.bin', 'transform_matrix': tm, 'time_lag': 0.05}


def test_get_sweep_matches_jax(tmp_path):
    """A written sweep through both packages: ego points within 1 m gone,
    the transform applied, the time lag as a column; then a frame with
    three such sweeps, MAX_SWEEPS 3, the choice of sweeps seeded."""
    jcfg, tcfg = _cfgs()
    rng = np.random.RandomState(0)
    version = tmp_path / tcfg.DATA_CONFIG.VERSION
    sweeps = [_write_sweep(version, rng)]
    sweeps += [dict(sweeps[0], time_lag=0.1 * (k + 2)) for k in range(2)]
    jds = JaxNuScenes(jcfg.DATA_CONFIG, jcfg.CLASS_NAMES, training=False, root_path=tmp_path)
    tds = NuScenesDataset(tcfg.DATA_CONFIG, tcfg.CLASS_NAMES, training=False,
                          root_path=tmp_path, rng=np.random.RandomState(5))
    ref, got = jds.get_sweep(sweeps[0]), tds.get_sweep(sweeps[0])
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    assert got[0].shape == (260, 4) and np.all(got[1] == 0.05)
    info = {'lidar_path': 'sweeps/s0.bin', 'sweeps': sweeps}
    jds.infos, tds.infos = [info], [info]
    np.random.seed(5)
    ref = jds.get_lidar_with_sweeps(0, max_sweeps=3)
    got = tds.get_lidar_with_sweeps(0, max_sweeps=3)
    np.testing.assert_array_equal(got, ref)
    assert got.shape == (300 + 2 * 260, 5)
    assert got.dtype == ref.dtype == np.float32


# ------------------------------------------------------- the evaluator

def _both_evaluators(*args, **kwargs):
    """JAX's evaluator and the port's on the same input: the text and the
    dict must be equal key for key; returns JAX's."""
    ref = jax_native.nuscenes_detection_eval(*args, **kwargs)
    got = nuscenes_eval_native.nuscenes_detection_eval(*args, **kwargs)
    assert got[0] == ref[0]
    assert sorted(got[1]) == sorted(ref[1])
    for k, v in ref[1].items():
        assert got[1][k] == v, k
    return ref


@pytest.mark.parametrize('case', sorted(
    n for n in dir(jax_native_cases) if n.startswith('test_')))
def test_native_eval_matches_jax_on_its_cases(case, monkeypatch):
    monkeypatch.setattr(jax_native_cases, 'nuscenes_detection_eval', _both_evaluators)
    getattr(jax_native_cases, case)()


@pytest.mark.parametrize('noise', [0.0, 0.4, 3.0])
def test_native_eval_matches_jax_on_the_fixture(noise):
    """The val split's ground truth as detections, moved by `noise` m (and
    turned and rescaled), through both datasets' ``evaluation``."""
    jds, tds = _datasets(False, seed=0)
    rng = np.random.RandomState(11)
    annos = []
    for info in tds.infos:
        boxes = np.asarray(info['gt_boxes'], np.float64).copy()
        boxes[:, :2] += rng.normal(0, noise, (len(boxes), 2))
        boxes[:, 3:6] *= 1 + rng.uniform(-0.2, 0.2, (len(boxes), 3)) * min(noise, 1.0)
        boxes[:, 6] += rng.normal(0, noise, len(boxes))
        boxes[:, 7:9] += rng.normal(0, noise, (len(boxes), 2))
        annos.append({'name': np.asarray(info['gt_names']), 'boxes_lidar': boxes,
                      'score': rng.uniform(0.2, 1.0, len(boxes)),
                      'metadata': {'token': info['token']}})
    ref = jds.evaluation(copy.deepcopy(annos), jds.class_names,
                         output_path=str(REPO / 'output' / 'nusc_eval'))
    got = tds.evaluation(copy.deepcopy(annos), tds.class_names, device='cpu')
    assert got[0] == ref[0]
    assert got[1] == ref[1]
    assert {'mAP', 'NDS', 'mATE', 'mASE', 'mAOE', 'mAVE'} <= set(got[1])
    if noise == 0.0:
        assert got[1]['mAP'] == pytest.approx(1.0) and got[1]['NDS'] == pytest.approx(1.0)


def test_generate_prediction_dicts_matches_jax():
    """Batched fixed-shape predictions with 9-dim boxes -> per-scan dicts."""
    rng = np.random.RandomState(2)
    b, n = 2, 30
    pred = {'pred_boxes': rng.randn(b, n, 9).astype(np.float32),
            'pred_scores': rng.rand(b, n).astype(np.float32),
            'pred_labels': rng.randint(1, 11, (b, n)),
            'pred_valid': rng.rand(b, n) > 0.3}
    pred['pred_valid'][1] = False
    batch = {'frame_id': ['a', 'b'],
             'metadata': np.array([{'token': 'ta'}, {'token': 'tb'}], dtype=object)}
    _, tcfg = _cfgs()
    ref = JaxNuScenes.generate_prediction_dicts(batch, pred, tcfg.CLASS_NAMES)
    got = NuScenesDataset.generate_prediction_dicts(batch, pred, tcfg.CLASS_NAMES)
    for g, r in zip(got, ref):
        assert sorted(g) == sorted(r)
        for k in r:
            if isinstance(r[k], np.ndarray):
                np.testing.assert_array_equal(g[k], r[k], err_msg=k)
            else:
                assert g[k] == r[k], k
    assert got[0]['boxes_lidar'].shape[1] == 9 and len(got[1]['name']) == 0


# ------------------------------------- the train runner's overflow check

def _overflow_cfg_file(cut_infos, path, x_conv2):
    """The runner tests' tiny FV2P (device rulebooks, two steps an epoch)
    with the train capacity of x_conv2 set to `x_conv2` rows a scan."""
    cfg_d = tiny_cfg_dict()
    cfg_d['MODEL']['BACKBONE_3D']['LEVEL_CAPACITIES']['train']['x_conv2'] = x_conv2
    return _runner_cfg_file(cfg_d, cut_infos, path)


@pytest.mark.parametrize('interval', [1, 50])
def test_device_overflow_raises_before_any_checkpoint(cut_infos, tmp_path,  # noqa: F811
                                                      monkeypatch, interval):
    """x_conv2 at 256 rows a scan drops rows in the first step: with a check
    every step the run stops after that step, with the default interval at
    the epoch's end; the message names the level and the yaml key, and no
    checkpoint is written."""
    monkeypatch.setattr(train, 'LOG_INTERVAL', interval)
    steps = []
    orig = train.TrainStep.step

    def counted(self, batch):
        steps.append(1)
        return orig(self, batch)
    monkeypatch.setattr(train.TrainStep, 'step', counted)
    cfg_file = _overflow_cfg_file(cut_infos, tmp_path / 'small.yaml', 256)
    with pytest.raises(RuntimeError, match=r"x_conv2.*LEVEL_CAPACITIES\.x_conv2"):
        _train(cfg_file, tmp_path / 'run', 1, '--rulebooks', 'device')
    assert len(steps) == min(interval, 2)
    assert not list((tmp_path / 'run' / 'ckpt').glob('*.pth'))


def test_overflow_checks_change_no_result(cut_infos, tmp_path, monkeypatch):  # noqa: F811
    """A device-mode run that drops nothing: the same loss terms and the same
    checkpoint with a check every step as with the default interval."""
    cfg_file = _overflow_cfg_file(cut_infos, tmp_path / 'roomy.yaml', 16384)
    runs = {}
    for interval in (50, 1):
        monkeypatch.setattr(train, 'LOG_INTERVAL', interval)
        runs[interval] = _train(cfg_file, tmp_path / f'run{interval}', 1, '--rulebooks',
                                'device')
    assert runs[1]['steps'] == runs[50]['steps']
    assert all(s['rulebook_dropped'] == 0 for s in runs[1]['steps'])
    states = [torch.load(tmp_path / f'run{i}' / 'ckpt' / 'checkpoint_epoch_1.pth',
                         weights_only=True)['model_state'] for i in (1, 50)]
    assert all(torch.equal(states[0][k], states[1][k]) for k in states[0])
