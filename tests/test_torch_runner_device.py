"""The port's runners with device rulebooks, and SECOND, on the committed
KITTI fixture (CPU; split from ``tests/test_torch_runner.py``, whose tiny
FV2P configuration and cuts these tests share): both runners with
``--rulebooks device`` against host mode, and ``second.yaml``'s model
through both runners."""
import logging
import pickle
from pathlib import Path

import numpy as np
import pytest

from fv2p_torch.config import EasyDict, cfg_from_yaml_file
from fv2p_torch.tools import test as test_runner

from tests.test_torch_runner import (KITTI, N_SCANS, TOL, _eval_keys, _plain, _runner_cfg_file,
                                     _train, tiny_cfg_dict)
from tests.test_torch_model import one_torch_thread  # noqa: F401 (an autouse fixture)

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope='module')
def cut_infos(tmp_path_factory):
    """Info files of the first N_SCANS train and val scans."""
    d = tmp_path_factory.mktemp('cut_infos')
    out = {}
    for split in ('train', 'val'):
        with open(KITTI / f'kitti_infos_{split}.pkl', 'rb') as f:
            infos = pickle.load(f)[:N_SCANS]
        out[split] = d / f'kitti_infos_{split}_first{N_SCANS}.pkl'
        with open(out[split], 'wb') as f:
            pickle.dump(infos, f)
    return out


def test_runners_with_device_rulebooks_match_host_mode(cut_infos, tmp_path):
    """``--rulebooks device``: the train runner (gt sampling and all
    augmentation, seeded) sees the same samples as with host rulebooks (the
    first step's loss terms within 1e-4 relative: the same weights; the
    gradient norm and later steps are not compared, as two summation orders
    of the same gradient part at the ReLUs' knife edges,
    ``tests/test_torch_device_mode.py``), the loader ships no tables, and
    the test runner gets host mode's recall and AP from the same
    checkpoint, with nothing dropped at the level capacities."""
    cfg_file = _runner_cfg_file(tiny_cfg_dict(), cut_infos, tmp_path / 'tiny_fv2p.yaml')
    runs = {mode: _train(cfg_file, tmp_path / mode, 1, '--rulebooks', mode)
            for mode in ('host', 'device')}
    host, dev = runs['host']['steps'], runs['device']['steps']
    assert len(host) == len(dev) == N_SCANS // 2
    for h, d in zip(host, dev):
        assert sorted(d) == sorted(list(h) + ['rulebook_dropped'])
        assert d['rulebook_dropped'] == 0
        assert all(np.isfinite(v) for v in d.values())
    for k in host[0]:
        if k not in ('grad_norm', 'epoch', 'it'):
            np.testing.assert_allclose(dev[0][k], host[0][k], rtol=1e-4, err_msg=k)
    _, cfg = test_runner.parse_config(['--cfg_file', str(cfg_file)])
    ds = test_runner.make_dataset(cfg, training=False, logger=logging.getLogger('t'),
                                  rulebooks='device')
    assert ds.rulebook_spec is None and 'rulebooks' not in ds.collate_batch([ds[0]])
    ckpt = tmp_path / 'device' / 'ckpt' / 'checkpoint_epoch_1.pth'
    rets = {mode: test_runner.main(['--cfg_file', str(cfg_file), '--device', 'cpu',
                                    '--dtype', 'float32', '--workers', '0',
                                    '--batch_size', '2', '--ckpt', str(ckpt),
                                    '--output_dir', str(tmp_path / f'eval_{mode}'),
                                    '--rulebooks', mode, '--save_to_file'])
            for mode in ('host', 'device')}
    # the detections as written in KITTI's text format (4 decimals)
    files = {mode: sorted((tmp_path / f'eval_{mode}' / 'eval').glob('[0-9]*.txt'))
             for mode in rets}
    assert len(files['host']) == N_SCANS
    assert [f.name for f in files['device']] == [f.name for f in files['host']]
    lines = 0
    for fd, fh in zip(files['device'], files['host']):
        assert fd.read_text() == fh.read_text(), fd.name
        lines += len(fh.read_text().splitlines())
    assert lines > 0
    assert rets['device']['device_rulebook_dropped'] == 0
    assert 'device_rulebook_dropped' not in rets['host']
    assert _eval_keys(rets['device']) == _eval_keys(rets['host'])
    for k in _eval_keys(rets['host']):
        assert abs(rets['device'][k] - rets['host'][k]) <= TOL, k


def test_second_yaml_through_both_runners(cut_infos, tmp_path):
    """kitti_models/second.yaml (its model as published, the classes the
    fixture holds: Car and Pedestrian) trains one epoch on the cut train
    split and is scored from its checkpoint; its sparse backbone builds its
    rulebooks in the forward in either mode, so the loader ships none."""
    full = EasyDict()
    cfg_from_yaml_file(str(REPO / 'tools/cfgs/kitti_models/second.yaml'), full)
    cfg_d = tiny_cfg_dict()
    cfg_d['CLASS_NAMES'] = ['Car', 'Pedestrian']
    cfg_d['MODEL'] = _plain(full.MODEL)
    cfg_d['MODEL']['DENSE_HEAD']['ANCHOR_GENERATOR_CONFIG'] = \
        cfg_d['MODEL']['DENSE_HEAD']['ANCHOR_GENERATOR_CONFIG'][:2]
    cfg_d['OPTIMIZATION'] = _plain(full.OPTIMIZATION)
    cfg_d['DATA_CONFIG'].pop('KEEP_RAW_POINTS', None)
    cfg_file = _runner_cfg_file(cfg_d, cut_infos, tmp_path / 'second.yaml')
    run = _train(cfg_file, tmp_path / 'run', 1)
    assert len(run['steps']) == N_SCANS // 2
    assert all(np.isfinite(v) for s in run['steps'] for v in s.values())
    assert {'rpn_loss_cls', 'rpn_loss_loc', 'rpn_loss_dir', 'rulebook_dropped'} <= \
        set(run['steps'][0])
    assert all(s['rulebook_dropped'] == 0 for s in run['steps'])
    ret = test_runner.main(['--cfg_file', str(cfg_file), '--device', 'cpu',
                            '--dtype', 'float32', '--workers', '0', '--batch_size', '2',
                            '--ckpt', str(tmp_path / 'run' / 'ckpt' / 'checkpoint_epoch_1.pth'),
                            '--output_dir', str(tmp_path / 'eval')])
    assert ret['device_rulebook_dropped'] == 0
    assert all(np.isfinite(v) for v in ret.values())
    assert any(k.startswith('Car_3d/') for k in ret)
