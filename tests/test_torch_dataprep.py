"""The port's data preparation against the JAX package's, on the CPU:
``create_kitti_infos`` (the info pickles and the gt database) on two copies
of the committed KITTI fixture's scans, the nuScenes
``create_groundtruth_database`` on two copies of the committed nuScenes
frames (with and without sweeps), the two fixture generators against
``tools/make_synthetic_kitti.py`` and ``tools/make_synthetic_nuscenes.py``
at a small size, ``KittiDataset.get_infos``'s order under its thread pool,
and ``box_utils.enlarge_box3d``.

Tolerance: none. Every pickle equals JAX's by content (the same keys and
types, every array of the same dtype and shape with the same values), and
every ``.bin`` and text file is byte-identical."""
import importlib.util
import pickle
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from fv2p_tpu.config import EasyDict as JaxEasyDict
from fv2p_tpu.config import cfg_from_yaml_file as jax_cfg_from_yaml_file
from fv2p_tpu.datasets.kitti import kitti_dataset as jax_kitti
from fv2p_tpu.datasets.nuscenes.nuscenes_dataset import NuScenesDataset as JaxNuScenes
from fv2p_tpu.utils import box_utils as jax_box_utils

from fv2p_torch.config import EasyDict, cfg_from_yaml_file
from fv2p_torch.datasets.kitti import kitti_dataset
from fv2p_torch.datasets.nuscenes.nuscenes_dataset import NuScenesDataset
from fv2p_torch.tools import make_synthetic_kitti, make_synthetic_nuscenes
from fv2p_torch.utils import box_utils
from tests.test_torch_model import one_torch_thread  # noqa: F401 (an autouse fixture)

REPO = Path(__file__).resolve().parent.parent
KITTI = REPO / 'data' / 'kitti'
NUSC = REPO / 'data' / 'nuscenes' / 'v1.0-trainval'
KITTI_CLASSES = ['Car', 'Pedestrian', 'Cyclist']


def assert_same(got, ref, where='root'):
    """Equal by content: the same types, dict keys (in order) and list
    lengths, and arrays of the same dtype and shape with equal values (NaN
    equal to NaN)."""
    assert type(got) is type(ref), (where, type(got), type(ref))
    if isinstance(ref, dict):
        assert list(got) == list(ref), (where, list(got), list(ref))
        for k in ref:
            assert_same(got[k], ref[k], f'{where}/{k}')
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref), (where, len(got), len(ref))
        for i, (g, r) in enumerate(zip(got, ref)):
            assert_same(g, r, f'{where}[{i}]')
    elif isinstance(ref, np.ndarray):
        assert got.dtype == ref.dtype and got.shape == ref.shape, \
            (where, got.dtype, ref.dtype, got.shape, ref.shape)
        assert np.array_equal(got, ref, equal_nan=got.dtype.kind == 'f'), where
    else:
        assert got == ref, (where, got, ref)


def assert_trees_same(got_root, ref_root):
    """Every file of two trees: pickles by content, the rest byte for byte."""
    got = sorted(str(p.relative_to(got_root)) for p in got_root.rglob('*') if p.is_file())
    ref = sorted(str(p.relative_to(ref_root)) for p in ref_root.rglob('*') if p.is_file())
    assert got == ref
    for rel in ref:
        if rel.endswith('.pkl'):
            assert_same(pickle.loads((got_root / rel).read_bytes()),
                        pickle.loads((ref_root / rel).read_bytes()), rel)
        else:
            assert (got_root / rel).read_bytes() == (ref_root / rel).read_bytes(), rel
    return ref


def _cfgs(rel):
    jcfg, tcfg = JaxEasyDict(), EasyDict()
    jax_cfg_from_yaml_file(str(REPO / 'tools/cfgs/dataset_configs' / rel), jcfg)
    cfg_from_yaml_file(str(REPO / 'tools/cfgs/dataset_configs' / rel), tcfg)
    return jcfg, tcfg


def _copy_kitti_scans(root):
    """The fixture's scans and split lists, without its infos or database."""
    shutil.copytree(KITTI / 'ImageSets', root / 'ImageSets')
    shutil.copytree(KITTI / 'training', root / 'training')


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(f'jax_{name}', REPO / 'tools' / f'{name}.py')
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def test_create_kitti_infos_matches_jax(tmp_path):
    """``create_kitti_infos`` on a copy of data/kitti's 56 scans by each
    package: the four pickles equal by content, and the gt database's .bin
    files byte-identical."""
    jcfg, tcfg = _cfgs('kitti_dataset.yaml')
    for name, fn, cfg in (('jax', jax_kitti.create_kitti_infos, jcfg),
                          ('torch', kitti_dataset.create_kitti_infos, tcfg)):
        _copy_kitti_scans(tmp_path / name)
        fn(cfg, KITTI_CLASSES, tmp_path / name, tmp_path / name, workers=2)
    files = assert_trees_same(tmp_path / 'torch', tmp_path / 'jax')
    written = [f for f in files if not f.startswith(('ImageSets', 'training'))]
    assert {'kitti_infos_train.pkl', 'kitti_infos_val.pkl', 'kitti_infos_trainval.pkl',
            'kitti_dbinfos_train.pkl'} <= set(written)
    assert sum(f.startswith('gt_database/') for f in written) > 50


def test_get_infos_keeps_the_split_order(tmp_path):
    """Under a pool of 4 threads the infos come back in the split's order,
    each equal to JAX's for the same sample, with and without labels and
    point counts."""
    jcfg, tcfg = _cfgs('kitti_dataset.yaml')
    ids = ['000040', '000003', '000017', '000051', '000008']
    jds = jax_kitti.KittiDataset(jcfg, KITTI_CLASSES, training=False, root_path=KITTI)
    tds = kitti_dataset.KittiDataset(tcfg, KITTI_CLASSES, training=False, root_path=KITTI)
    for kwargs in ({}, {'has_label': False}, {'count_inside_pts': False}):
        got = tds.get_infos(num_workers=4, sample_id_list=ids, **kwargs)
        assert [i['point_cloud']['lidar_idx'] for i in got] == ids
        assert_same(got, jds.get_infos(num_workers=4, sample_id_list=ids, **kwargs))
    tds.set_split('val')
    assert tds.sample_id_list == [x.strip() for x in
                                  (KITTI / 'ImageSets' / 'val.txt').read_text().splitlines()]
    assert tuple(tds.get_image_shape('000032')) == (384, 1280)


def _nuscenes_frames(root, sweeps):
    """A copy of data/nuscenes' key frames and train infos; with ``sweeps``
    each info lists three sweeps (other frames' files, moved and with a time
    lag), so that the database's points depend on the draws."""
    shutil.copytree(NUSC / 'samples', root / 'samples')
    with open(NUSC / 'nuscenes_infos_10sweeps_train.pkl', 'rb') as f:
        infos = pickle.load(f)
    if sweeps:
        for i, info in enumerate(infos):
            others = [x['lidar_path'] for x in infos if x is not info]
            info['sweeps'] = [{'lidar_path': path,
                               'transform_matrix': np.array(
                                   [[1, 0, 0, 0.5 * k], [0, 1, 0, -0.25 * i],
                                    [0, 0, 1, 0], [0, 0, 0, 1]], np.float64),
                               'time_lag': 0.05 * (k + 1)} for k, path in enumerate(others)]
    return infos


@pytest.mark.parametrize('sweeps', [False, True], ids=['key_frames', 'three_sweeps'])
def test_nuscenes_groundtruth_database_matches_jax(tmp_path, sweeps):
    """``create_groundtruth_database(max_sweeps=10)`` over data/nuscenes'
    train infos by each package (JAX after ``np.random.seed(0)``, the port
    with ``RandomState(0)``): the database pickle equal by content, the .bin
    files byte-identical."""
    jcfg, tcfg = _cfgs('nuscenes_dataset.yaml')
    classes = make_synthetic_nuscenes.CLASSES
    for name, cls, cfg in (('jax', JaxNuScenes, jcfg), ('torch', NuScenesDataset, tcfg)):
        root = tmp_path / name / 'v1.0-trainval'
        infos = _nuscenes_frames(root, sweeps)
        if name == 'jax':
            ds = cls(cfg, classes, training=False, root_path=root.parent)
            np.random.seed(0)
        else:
            ds = cls(cfg, classes, training=False, root_path=root.parent,
                     rng=np.random.RandomState(0))
        ds.infos = infos
        ds.create_groundtruth_database(used_classes=classes[:5], max_sweeps=10)
    files = assert_trees_same(tmp_path / 'torch', tmp_path / 'jax')
    db = [f for f in files if 'gt_database_10sweeps_withvelo/' in f]
    assert len(db) == 4 * 11 and db[0].startswith('v1.0-trainval/gt_database')


def test_kitti_generator_matches_jax_tool(tmp_path):
    """``python -m fv2p_torch.tools.make_synthetic_kitti DIR`` and
    ``tools/make_synthetic_kitti.py`` at 2 train and 2 val scans: the same
    tree (scans, labels, calibration, images, planes, infos, database)."""
    _load_tool('make_synthetic_kitti').main(tmp_path / 'jax', n_train=2, n_val=2, seed=3)
    make_synthetic_kitti.main(tmp_path / 'torch', n_train=2, n_val=2, seed=3)
    files = assert_trees_same(tmp_path / 'torch', tmp_path / 'jax')
    assert 'kitti_dbinfos_train.pkl' in files
    assert len([f for f in files if f.startswith('training/velodyne/')]) == 4


def test_nuscenes_generator_matches_jax_tool(tmp_path):
    """``python -m fv2p_torch.tools.make_synthetic_nuscenes DIR`` and
    ``tools/make_synthetic_nuscenes.py`` at 2 train and 2 val frames: the
    same tree."""
    _load_tool('make_synthetic_nuscenes').main(tmp_path / 'jax' / 'v1.0-trainval',
                                               n_train=2, n_val=2, seed=1)
    make_synthetic_nuscenes.main(tmp_path / 'torch' / 'v1.0-trainval',
                                 n_train=2, n_val=2, seed=1)
    files = assert_trees_same(tmp_path / 'torch', tmp_path / 'jax')
    assert 'v1.0-trainval/nuscenes_dbinfos_10sweeps_withvelo.pkl' in files


def test_enlarge_box3d_matches_jax():
    """``enlarge_box3d`` grows the extents by ``extra_width`` and leaves the
    centre and heading as they are (exactly JAX's values)."""
    boxes = np.random.RandomState(0).randn(6, 7).astype(np.float32)
    for extra in ((0, 0, 0), (0.2, 0.3, 0.5)):
        ref = np.asarray(jax_box_utils.enlarge_box3d(boxes, extra))
        got = box_utils.enlarge_box3d(torch.from_numpy(boxes), extra)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy()[:, [0, 1, 2, 6]], boxes[:, [0, 1, 2, 6]])

