"""The port's runners on the committed KITTI fixture (CPU).

* ``eval_one_epoch`` end to end against JAX's ``tools/eval_utils``: the
  tiny FV2P (``TINY_FV2P_CFG``) with fv2p.yaml's DATA_CONFIG, JAX's weights
  carried across by ``load_flax_variables``, the first 4 val scans fed to
  both as the same list of batches; det_annos and the result dict (recall
  and AP) within 1e-4. JAX's 3-NN runs through its Pallas kernel in
  interpret mode, the function the port's kernel implements (as in
  ``tests/test_torch_model.py``).
* ``fv2p_torch.tools.train.main``: checkpoints, rotation, auto-resume with
  identical parameters, optimizer state and learning rate, and a half
  written temporary file that is never picked up; the ``sgd`` and ``adam``
  optimizers and the ``--profile_steps`` trace.
* Device rulebooks and SECOND through the runners:
  ``tests/test_torch_runner_device.py``.

Cuts for CPU time, all through the config and none in the fixture: the
voxel caps (test 4000 of 40000, train 4000 of 16000, with the train shuffle
off so that the first 4000 voxels are one region of the scan, and train
level capacities of their own), MAX_POINTS_PER_SCAN 4096 of 24000, the train split
cut to its first 4 scans through an info file of its own, and
SCORE_THRESH 0.0 so that the seeded weights give detections.
"""
import copy
import json
import logging
import pickle
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from fv2p_tpu.config import EasyDict as JaxEasyDict
from fv2p_tpu.datasets.kitti.kitti_dataset import KittiDataset as JaxKittiDataset
from fv2p_tpu.models import build_network as jax_build_network
from fv2p_tpu.ops import pointops as jax_pointops
from tests.jitu import jinit
from tests.test_fv2p_model import TINY_FV2P_CFG
from tests.test_torch_model import _three_nn_interpolate_pallas

import fv2p_torch.models as torch_models
from fv2p_torch.config import EasyDict, cfg_from_yaml_file
from fv2p_torch.datasets import dataset_meta_from_cfg
from fv2p_torch.datasets.kitti.kitti_dataset import KittiDataset
from fv2p_torch.tools import eval_utils, test as test_runner, train
from fv2p_torch.weights import load_flax_variables
from tests.test_torch_model import one_torch_thread  # noqa: F401 (an autouse fixture)

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / 'tools'))
from eval_utils import eval_utils as jax_eval_utils  # noqa: E402

KITTI = REPO / 'data' / 'kitti'
N_SCANS = 4
TOL = 1e-4
# ids of timing entries, which the two runs cannot share
TIMING_KEYS = ('sec_per_example', 'sec_per_example_first_batch',
               'loader_wait_s_per_batch', 'forward_ms_median')


def _plain(d):
    if isinstance(d, dict):
        return {k: _plain(v) for k, v in d.items()}
    if isinstance(d, (list, tuple)):
        return [_plain(x) for x in d]
    return d


def tiny_cfg_dict(train_info=None):
    """The tiny FV2P over fv2p.yaml's DATA_CONFIG, with the cuts listed in
    the module docstring."""
    full = EasyDict()
    cfg_from_yaml_file(str(REPO / 'tools/cfgs/kitti_models/FV2P/fv2p.yaml'), full)
    dc = _plain(full.DATA_CONFIG)
    dc['DATA_PATH'] = str(KITTI)
    dc['MAX_POINTS_PER_SCAN'] = 4096
    for proc in dc['DATA_PROCESSOR']:
        if proc['NAME'] == 'transform_points_to_voxels':
            proc['MAX_NUMBER_OF_VOXELS'] = {'train': 4000, 'test': 4000}
        if proc['NAME'] == 'shuffle_points':
            proc['SHUFFLE_ENABLED'] = {'train': False, 'test': False}
    if train_info is not None:
        dc['INFO_PATH']['train'] = [str(train_info)]
    model = _plain(TINY_FV2P_CFG)
    model['POST_PROCESSING']['SCORE_THRESH'] = 0.0
    # gt sampling scatters object points over the scene: room for their
    # dilation at the sparse levels (test mode keeps the derived caps)
    model['BACKBONE_3D']['LEVEL_CAPACITIES'] = {'train': {
        'x_conv2': 16384, 'x_conv3': 12288, 'x_conv4': 8192, 'out': 8192}}
    return {'CLASS_NAMES': ['Car'], 'DATA_CONFIG': dc, 'MODEL': model,
            'OPTIMIZATION': _plain(full.OPTIMIZATION)}


# ---------------------------------------------------------------- eval

@pytest.fixture(scope='module')
def eval_run(tmp_path_factory):
    out = tmp_path_factory.mktemp('eval')
    cfg_d = tiny_cfg_dict()
    tcfg, jcfg = EasyDict(copy.deepcopy(cfg_d)), JaxEasyDict(copy.deepcopy(cfg_d))
    tds = KittiDataset(tcfg.DATA_CONFIG, ['Car'], training=False, root_path=KITTI)
    jds = JaxKittiDataset(jcfg.DATA_CONFIG, ['Car'], training=False, root_path=KITTI)
    for ds in (tds, jds):
        ds.kitti_infos = ds.kitti_infos[:N_SCANS]
    tds.set_rulebook_spec('VoxelResBackBone8x')
    batches = [tds.collate_batch([tds[i], tds[i + 1]]) for i in range(0, N_SCANS, 2)]
    meta = dataset_meta_from_cfg(tcfg.DATA_CONFIG, 'test')

    jmodel = jax_build_network(jcfg.MODEL, num_class=1, class_names=['Car'],
                               dataset_meta=meta)
    example = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else
               {kk: jnp.asarray(vv) for kk, vv in v.items()}
               for k, v in batches[0].items()
               if isinstance(v, dict) or (isinstance(v, np.ndarray) and v.dtype.kind in 'biuf')}
    variables = jinit(jmodel, {'params': jax.random.PRNGKey(0),
                               'sampling': jax.random.PRNGKey(1),
                               'dropout': jax.random.PRNGKey(2)}, example)
    vnp = jax.tree_util.tree_map(np.asarray, dict(variables))
    logger = logging.getLogger('test_torch_runner')

    captured = {}
    jax_eval = jds.evaluation

    def capture(det_annos, class_names, **kw):
        captured['det_annos'] = copy.deepcopy(det_annos)
        return jax_eval(det_annos, class_names, **kw)
    jds.evaluation = capture
    (out / 'jax').mkdir()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_pointops, 'three_nn_interpolate', _three_nn_interpolate_pallas)
        jret = jax_eval_utils.eval_one_epoch(
            jcfg, jmodel, jax.tree_util.tree_map(jnp.asarray, vnp), batches, jds,
            out / 'jax', logger, batch_size=2)

    tmodel = torch_models.build_network(tcfg.MODEL, 1, ['Car'], meta, device='cpu')
    load_flax_variables(tmodel, vnp)
    (out / 'torch').mkdir()
    tret, tannos = eval_utils.eval_one_epoch(tcfg, tmodel, batches, tds, out / 'torch',
                                             logger, batch_size=2)
    return {'jret': jret, 'jannos': captured['det_annos'], 'tret': tret, 'tannos': tannos}


def test_eval_one_epoch_det_annos_match_jax(eval_run):
    got, ref = eval_run['tannos'], eval_run['jannos']
    assert len(got) == len(ref) == N_SCANS
    assert sum(len(a['name']) for a in got) > 0, 'no detection to compare'
    for g, r in zip(got, ref):
        assert g['frame_id'] == r['frame_id']
        np.testing.assert_array_equal(g['name'], r['name'])
        for k in ('bbox', 'dimensions', 'location', 'rotation_y', 'score', 'alpha',
                  'boxes_lidar'):
            np.testing.assert_allclose(g[k], r[k], rtol=TOL, atol=TOL, err_msg=k)


def test_eval_one_epoch_results_match_jax(eval_run):
    got, ref = eval_run['tret'], eval_run['jret']
    keys = sorted(k for k in ref if k not in TIMING_KEYS)
    assert keys == sorted(k for k in got if k not in TIMING_KEYS)
    assert any(k.startswith('recall/') for k in keys)
    for k in keys:
        assert abs(got[k] - ref[k]) <= TOL, (k, got[k], ref[k])
    assert got['recall/roi_0.3'] > 0
    for k in TIMING_KEYS:
        assert got[k] >= 0


def test_pad_batch_to_size_repeats_last_and_zeroes_gt():
    batch = {'voxels': np.arange(6).reshape(3, 2), 'gt_boxes': np.ones((3, 2, 8)),
             'frame_id': ['a', 'b', 'c'], 'rulebooks': {'x': np.arange(3)}}
    out, n_real = eval_utils.pad_batch_to_size(batch, 4)
    assert n_real == 3
    np.testing.assert_array_equal(out['voxels'][3], batch['voxels'][2])
    assert out['gt_boxes'][3].sum() == 0 and out['frame_id'][3] == 'c'
    np.testing.assert_array_equal(out['rulebooks']['x'], [0, 1, 2, 2])


# ---------------------------------------------------------------- train

@pytest.fixture(scope='module')
def train_cfg_file(tmp_path_factory):
    d = tmp_path_factory.mktemp('train_cfg')
    with open(KITTI / 'kitti_infos_train.pkl', 'rb') as f:
        infos = pickle.load(f)[:N_SCANS]
    with open(d / 'kitti_infos_train_first4.pkl', 'wb') as f:
        pickle.dump(infos, f)
    cfg_file = d / 'tiny_fv2p.yaml'
    cfg_file.write_text(yaml.safe_dump(tiny_cfg_dict(d / 'kitti_infos_train_first4.pkl')))
    return cfg_file


def _train(cfg_file, out, epochs, *extra, on_resume=None):
    return train.main(['--cfg_file', str(cfg_file), '--device', 'cpu', '--dtype', 'float32',
                       '--workers', '0', '--batch_size', '2', '--epochs', str(epochs),
                       '--output_dir', str(out), '--fix_random_seed', *extra],
                      on_resume=on_resume)


def _state(trainer):
    opt = trainer.optimizer.state_dict()
    return ({k: v.clone() for k, v in trainer.model.state_dict().items()},
            opt['count'], [m.clone() for m in opt['mu']], [n.clone() for n in opt['nu']])


def _assert_state_equal(a, b):
    assert sorted(a[0]) == sorted(b[0])
    for k in a[0]:
        assert torch.equal(a[0][k], b[0][k]), k
    assert a[1] == b[1]
    for x, y in zip(a[2] + a[3], b[2] + b[3]):
        assert torch.equal(x, y)


def test_train_checkpoint_rotation_and_resume(train_cfg_file, tmp_path):
    out = tmp_path / 'run'
    first = _train(train_cfg_file, out, 1)
    ckpt_dir = out / 'ckpt'
    assert [p.name for _, p in test_runner.checkpoint_list(ckpt_dir)] == \
        ['checkpoint_epoch_1.pth']
    assert len(first['steps']) == N_SCANS // 2 and first['resumed_from'] is None
    assert all(np.isfinite(v) for s in first['steps'] for v in s.values())
    saved = torch.load(ckpt_dir / 'checkpoint_epoch_1.pth', weights_only=True)
    assert saved['epoch'] == 1 and saved['optimizer_state']['count'] == N_SCANS // 2
    live = _state(first['trainer'])
    from_file = ({k: v for k, v in saved['model_state'].items()},
                 saved['optimizer_state']['count'], list(saved['optimizer_state']['mu']),
                 list(saved['optimizer_state']['nu']))
    _assert_state_equal(live, from_file)

    # a half-written checkpoint of a later epoch: never a resume candidate
    (ckpt_dir / 'checkpoint_epoch_9.pth.4242.tmp').write_bytes(b'\x80half')
    resumed = {}

    def on_resume(trainer, path):
        resumed['path'] = path
        resumed['state'] = _state(trainer)
        resumed['lr'] = trainer.optimizer.hyperparams()

    same = _train(train_cfg_file, out, 1, on_resume=on_resume)
    assert resumed['path'].name == 'checkpoint_epoch_1.pth'
    _assert_state_equal(resumed['state'], live)
    assert resumed['lr'] == first['trainer'].optimizer.hyperparams()
    assert same['steps'] == [] and same['start_epoch'] == 1

    more = _train(train_cfg_file, out, 2, '--max_ckpt_save_num', '1', on_resume=on_resume)
    assert more['start_epoch'] == 1 and len(more['steps']) == N_SCANS // 2
    assert more['trainer'].step_count == N_SCANS
    assert all(np.isfinite(v) for s in more['steps'] for v in s.values())
    assert [p.name for _, p in test_runner.checkpoint_list(ckpt_dir)] == \
        ['checkpoint_epoch_2.pth']
    assert (ckpt_dir / 'checkpoint_epoch_9.pth.4242.tmp').exists()
    lines = (out / 'metrics.jsonl').read_text().splitlines()
    assert len(lines) == N_SCANS


@pytest.mark.parametrize('optimizer', ['sgd', 'adam'])
def test_profile_steps_trace_with_each_optimizer(train_cfg_file, tmp_path, optimizer):
    """One epoch of two steps with ``--profile_steps 1,2`` and the yaml's
    OPTIMIZER set to ``sgd`` or ``adam``: finite losses, the optimizer's
    own state in the checkpoint, and a Chrome trace of the second step
    (host operator events; on the CPU no CUDA ones)."""
    out = tmp_path / 'run'
    rec = _train(train_cfg_file, out, 1, '--profile_steps', '1,2',
                 '--set', 'OPTIMIZATION.OPTIMIZER', optimizer)
    assert len(rec['steps']) == N_SCANS // 2
    assert all(np.isfinite(v) for s in rec['steps'] for v in s.values())
    opt = torch.load(out / 'ckpt' / 'checkpoint_epoch_1.pth',
                     weights_only=True)['optimizer_state']
    assert opt['count'] == N_SCANS // 2
    assert sorted(k for k in opt if k != 'count') == (['trace'] if optimizer == 'sgd'
                                                      else ['mu', 'nu'])
    assert rec['profile'] == out / 'profile' / 'rank0_steps_1_2.json'
    events = json.loads(rec['profile'].read_text())['traceEvents']
    names = {e.get('name', '') for e in events}
    assert any(n.startswith('aten::') for n in names)
    assert not any(e.get('cat') == 'kernel' for e in events)


@pytest.mark.parametrize('text', ['2,1', '3', 'a,b', '-1,2'])
def test_profile_steps_refuses_a_bad_range(text):
    with pytest.raises(ValueError, match='--profile_steps'):
        train.parse_profile_steps(text)


@pytest.mark.parametrize('flag', [['--dist'], ['--num_devices', '2']])
def test_runners_refuse_what_is_not_ported(train_cfg_file, tmp_path, flag, monkeypatch):
    """The data-parallel flags are ported (``tests/test_torch_ddp.py``); a
    launch the machine cannot honour raises, never falls back to one
    process: --dist without torchrun's environment, --num_devices on more
    cards than the machine has."""
    for key in ('RANK', 'WORLD_SIZE', 'MASTER_ADDR', 'MASTER_PORT'):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 0)
    for runner in (train, test_runner):
        with pytest.raises(RuntimeError, match='torchrun|CUDA card'):
            runner.main(['--cfg_file', str(train_cfg_file), '--device', 'cuda',
                         '--output_dir', str(tmp_path), *flag])


def _runner_cfg_file(cfg_d, infos, path):
    cfg_d['DATA_CONFIG']['INFO_PATH'] = {'train': [str(infos['train'])],
                                         'test': [str(infos['val'])]}
    path.write_text(yaml.safe_dump(cfg_d))
    return path


def _eval_keys(ret):
    return sorted(k for k in ret if k not in TIMING_KEYS + ('device_rulebook_dropped',))


def test_eval_all_takes_each_complete_checkpoint_once(tmp_path):
    ckpt_dir, record = tmp_path / 'ckpt', tmp_path / 'eval_list_val.txt'
    ckpt_dir.mkdir()
    for name in ('checkpoint_epoch_2.pth', 'checkpoint_epoch_10.pth',
                 'checkpoint_epoch_3.pth.77.tmp', 'checkpoint_epoch_x.pth'):
        (ckpt_dir / name).write_bytes(b'')
    assert test_runner.get_no_evaluated_ckpt(ckpt_dir, record, 0)[0] == 2
    record.write_text('2\n')
    assert test_runner.get_no_evaluated_ckpt(ckpt_dir, record, 0)[0] == 10
    assert test_runner.get_no_evaluated_ckpt(ckpt_dir, record, 11) == (-1, None)


def test_build_dataloader_spawns_seeded_workers():
    """Two spawned workers draw different augmentations: each seeds its
    dataset copy's generator from its own torch seed."""
    from fv2p_torch.datasets import build_dataloader, build_dataset
    cfg = EasyDict(tiny_cfg_dict())
    ds = build_dataset(cfg.DATA_CONFIG, ['Car'], training=True, root_path=KITTI)
    ds.kitti_infos = [ds.kitti_infos[0]] * 4
    loader = build_dataloader(ds, batch_size=1, workers=2, training=True)
    torch.manual_seed(0)
    boxes = [b['gt_boxes'][0] for b in loader]
    assert len(boxes) == 4
    assert not np.array_equal(boxes[0], boxes[1])
