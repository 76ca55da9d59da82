"""The port's KITTI data layer and evaluator against the JAX package's, on
the committed fixture ``data/kitti`` (CPU).

* ``KittiDataset.__getitem__`` in eval mode and, with augmentation and gt
  sampling, in train mode: every array equal to JAX's exactly. JAX draws
  from numpy's global generator after ``np.random.seed(s)``, the port from
  its dataset's ``RandomState(s)``; the calls come in the same order, so
  the draws are the same.
* ``collate_batch``: equal.
* The C++ rulebook builder against the port's numpy one, table for table.
* ``get_official_eval_result`` against JAX's on perturbed detections built
  from the val ground truth: every value within 1e-4, the same keys and the
  same result lines; and the cases of ``tests/test_kitti_eval.py``.
* ``generate_prediction_dicts`` (floats within 1e-6) and the recall
  counter (counts exact) against JAX's.

No fixture file changes; the scans are the first ones of each split.
"""
import copy
import pickle
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fv2p_tpu.config import EasyDict as JaxEasyDict
from fv2p_tpu.config import cfg_from_yaml_file as jax_cfg_from_yaml_file
from fv2p_tpu.datasets.kitti.kitti_dataset import KittiDataset as JaxKittiDataset
from fv2p_tpu.datasets.kitti.kitti_object_eval import eval as jax_kitti_eval

from fv2p_torch.config import EasyDict, cfg_from_yaml_file
from fv2p_torch.datasets import build_dataset, dataset_meta_from_cfg
from fv2p_torch.datasets.kitti.kitti_dataset import KittiDataset
from fv2p_torch.datasets.kitti.kitti_object_eval import eval as kitti_eval
from fv2p_torch.ops.sparse import host_rulebook
from fv2p_torch.tools.eval_utils import make_recall_fn
from fv2p_torch.utils import native
from fv2p_torch.utils.synthetic import scan_coords
from tests.test_torch_model import one_torch_thread  # noqa: F401 (an autouse fixture)

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / 'tools'))
from eval_utils.eval_utils import make_recall_fn as jax_make_recall_fn  # noqa: E402

FV2P_YAML = REPO / 'tools/cfgs/kitti_models/FV2P/fv2p.yaml'
KITTI = REPO / 'data' / 'kitti'
BACKBONE = 'VoxelResBackBone8x'


def _cfgs():
    jcfg, tcfg = JaxEasyDict(), EasyDict()
    jax_cfg_from_yaml_file(str(FV2P_YAML), jcfg)
    cfg_from_yaml_file(str(FV2P_YAML), tcfg)
    return jcfg, tcfg


def _datasets(training):
    jcfg, tcfg = _cfgs()
    jds = JaxKittiDataset(jcfg.DATA_CONFIG, jcfg.CLASS_NAMES, training=training,
                          root_path=KITTI)
    tds = KittiDataset(tcfg.DATA_CONFIG, tcfg.CLASS_NAMES, training=training,
                       root_path=KITTI)
    caps = tcfg.MODEL.BACKBONE_3D.LEVEL_CAPACITIES
    jds.set_rulebook_spec(BACKBONE, caps_override=caps)
    tds.set_rulebook_spec(BACKBONE, caps_override=caps)
    return jds, tds


def _assert_samples_equal(got, ref):
    assert sorted(got) == sorted(ref)
    for key, r in ref.items():
        g = got[key]
        if key == 'calib':
            for attr in ('P2', 'R0', 'V2C'):
                np.testing.assert_array_equal(getattr(g, attr), getattr(r, attr))
        elif key == '_rb_sample':
            assert sorted(g) == sorted(r)
            for k in r:
                if isinstance(r[k], np.ndarray):
                    np.testing.assert_array_equal(g[k], r[k], err_msg=k)
                    assert g[k].dtype == r[k].dtype, k
                else:
                    assert g[k] == r[k], k
        elif key == '_rb_spec':
            assert g['caps'] == r['caps'] and g['shapes'] == r['shapes']
        elif isinstance(r, np.ndarray):
            np.testing.assert_array_equal(g, r, err_msg=key)
            assert g.dtype == r.dtype, key
        else:
            assert g == r, key


def _assert_batches_equal(got, ref):
    assert sorted(got) == sorted(ref)
    for key, r in ref.items():
        if key == 'rulebooks':
            assert sorted(got[key]) == sorted(r)
            for k in r:
                np.testing.assert_array_equal(got[key][k], r[k], err_msg=k)
        elif key == 'calib':
            assert len(got[key]) == len(r)
        elif isinstance(r, np.ndarray):
            np.testing.assert_array_equal(got[key], r, err_msg=key)
            assert got[key].dtype == r.dtype, key
        else:
            assert got[key] == r, key


@pytest.fixture(scope='module')
def eval_sets():
    return _datasets(training=False)


@pytest.mark.parametrize('index', [0, 7, 23])
def test_dataset_eval_sample_matches_jax(eval_sets, index):
    jds, tds = eval_sets
    _assert_samples_equal(tds[index], jds[index])


def test_collate_eval_batch_matches_jax(eval_sets):
    jds, tds = eval_sets
    got = tds.collate_batch([tds[i] for i in (1, 2, 3)])
    ref = jds.collate_batch([jds[i] for i in (1, 2, 3)])
    _assert_batches_equal(got, ref)
    assert got['voxels'].shape == (3, 40000, 5, 4)     # the test cap
    assert got['points'].shape == (3, 24000, 4)


def _n_class_boxes(info, names=('Car',)):
    return int(np.isin(info['annos']['name'], names).sum())


@pytest.mark.parametrize('seed', [3, 11])
def test_dataset_train_sample_matches_jax(seed):
    """Augmentation with gt sampling, flip, rotation and scaling: the port's
    RandomState(seed) against np.random.seed(seed), two samples in a row
    (the gt sampler's epoch shuffle and pointer carry over), each with
    sampled boxes added to the scene."""
    jds, tds = _datasets(training=True)
    tds.rng = np.random.RandomState(seed)
    np.random.seed(seed)
    for index in (0, 5):
        ref = jds[index]
        got = tds[index]
        _assert_samples_equal(got, ref)
        n_gt = int((got['gt_boxes'][:, 7] > 0).sum())
        assert n_gt > _n_class_boxes(tds.kitti_infos[index]), 'no box was sampled'
    batch_ref = jds.collate_batch([jds[i] for i in (8, 9)])
    batch_got = tds.collate_batch([tds[i] for i in (8, 9)])
    _assert_batches_equal(batch_got, batch_ref)


def _assert_rulebooks_equal(got, ref):
    assert sorted(got) == sorted(ref)
    for k in ref:
        if isinstance(ref[k], np.ndarray):
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
            assert got[k].dtype == ref[k].dtype, k
        else:
            assert got[k] == ref[k], k


@pytest.mark.parametrize('training', [True, False], ids=['train_caps', 'test_caps'])
def test_native_rulebooks_match_numpy_on_fixture(training):
    _, tcfg = _cfgs()
    tds = build_dataset(tcfg.DATA_CONFIG, tcfg.CLASS_NAMES, training=training,
                        root_path=KITTI)
    tds.set_rulebook_spec(BACKBONE, tcfg.MODEL.BACKBONE_3D.LEVEL_CAPACITIES)
    tds.rng = np.random.RandomState(0)
    for index in (0, 1):
        sample = tds[index]
        n = int(sample['voxel_valid'].sum())
        ref = host_rulebook.build_sample_rulebooks_plain(
            sample['voxel_coords'], n, tds.rulebook_spec)
        _assert_rulebooks_equal(sample['_rb_sample'], ref)


def test_native_rulebooks_match_numpy_over_cap_and_empty():
    """A scan whose levels overflow their caps (strict off: both builders
    truncate alike and count the same active rows), and the empty scan."""
    meta = {'grid_size': (1408, 1600, 40), 'point_cloud_range': (0, -40, -3, 70.4, 40, 1)}
    zyx, _, _ = scan_coords(np.random.RandomState(4), meta, 3000)
    spec = host_rulebook.backbone_spec(BACKBONE, meta['grid_size'], 3000, strict=False,
                                       caps_override={'x_conv2': 1000, 'x_conv3': 500,
                                                      'x_conv4': 200, 'out': 100})
    order = host_rulebook.sort_voxels_by_key(zyx, spec['shapes']['x_conv1'])
    coords = np.ascontiguousarray(zyx[order].astype(np.int32))
    got = host_rulebook.build_sample_rulebooks(coords, len(coords), spec)
    ref = host_rulebook.build_sample_rulebooks_plain(coords, len(coords), spec)
    _assert_rulebooks_equal(got, ref)
    assert all(got[f'ntotal_{lvl}'] > spec['caps'][lvl]
               for lvl in ('x_conv2', 'x_conv3', 'x_conv4', 'out'))
    empty = np.zeros((3000, 3), np.int32)
    _assert_rulebooks_equal(host_rulebook.build_sample_rulebooks(empty, 0, spec),
                            host_rulebook.build_sample_rulebooks_plain(empty, 0, spec))
    host_rulebook.reset_overflow_stats()
    host_rulebook._record_overflow(got, spec)
    stats = host_rulebook.get_overflow_stats()
    assert stats['samples_over'] == {'x_conv2': 1, 'x_conv3': 1, 'x_conv4': 1, 'out': 1}
    assert stats['dropped']['out'] == got['ntotal_out'] - 100


def test_native_build_failure_raises(tmp_path, monkeypatch):
    bad = tmp_path / 'broken.cpp'
    bad.write_text('this is not C++\n')
    monkeypatch.setattr(native, 'BUILD_DIR', tmp_path / 'build')
    with pytest.raises(RuntimeError, match='g\\+\\+ failed'):
        native.build(bad)


# ------------------------------------------------------------- evaluator

def _val_gt():
    with open(KITTI / 'kitti_infos_val.pkl', 'rb') as f:
        return [copy.deepcopy(info['annos']) for info in pickle.load(f)]


DET_KEYS = ('name', 'truncated', 'occluded', 'alpha', 'bbox', 'dimensions',
            'location', 'rotation_y')


def _perturbed_dets(gt_annos, seed):
    """Detections from the val gt: jittered boxes, dropped boxes, false
    positives, a Van row and a DontCare row, seeded scores."""
    rng = np.random.RandomState(seed)
    dets = []
    for g in gt_annos:
        keep = (g['name'] != 'DontCare') & (rng.rand(len(g['name'])) > 0.2)
        d = {k: np.array(g[k][keep], dtype=g[k].dtype) for k in DET_KEYS}
        n = int(keep.sum())
        d['location'] = d['location'] + rng.normal(0, 0.15, (n, 3))
        d['dimensions'] = d['dimensions'] * rng.uniform(0.9, 1.1, (n, 3))
        d['rotation_y'] = d['rotation_y'] + rng.normal(0, 0.1, n)
        d['bbox'] = d['bbox'] + rng.normal(0, 3.0, (n, 4))
        d['score'] = rng.uniform(0.1, 1.0, n)
        if n:                                # a false positive beside a box
            fp = {k: d[k][:1].copy() for k in d}
            fp['location'][:, 0] += 6.0
            fp['score'] = np.array([0.95])
            van = {k: d[k][:1].copy() for k in d}
            van['name'] = np.array(['Van'])
            dc = {k: d[k][:1].copy() for k in d}
            dc['name'] = np.array(['DontCare'])
            d = {k: np.concatenate([d[k], fp[k], van[k], dc[k]]) for k in d}
        dets.append(d)
    return dets


def _bucketed(overlap_area):
    """JAX's overlap function with its inputs padded to 32 rows (far-away
    unit boxes) and the result cut back: the pairs are independent, so the
    real entries are unchanged, and JAX compiles one shape in place of one
    per image."""
    far = np.array([[1e4, 1e4, 1.0, 1.0, 0.0]])

    def pad(b):
        return np.concatenate([b, np.repeat(far, (-len(b)) % 32, 0)]).astype(b.dtype)

    def fn(boxes, qboxes):
        if len(boxes) == 0 or len(qboxes) == 0:
            return overlap_area(boxes, qboxes)
        return overlap_area(pad(boxes), pad(qboxes))[:len(boxes), :len(qboxes)]
    return fn


@pytest.mark.parametrize('seed', [0, 1])
def test_official_eval_matches_jax(seed, monkeypatch):
    gt = _val_gt()
    dt = _perturbed_dets(gt, seed)
    monkeypatch.setattr(jax_kitti_eval, '_rotated_overlap_area',
                        _bucketed(jax_kitti_eval._rotated_overlap_area))
    ref_str, ref = jax_kitti_eval.get_official_eval_result(
        copy.deepcopy(gt), copy.deepcopy(dt), ['Car'])
    got_str, got = kitti_eval.get_official_eval_result(
        copy.deepcopy(gt), copy.deepcopy(dt), ['Car'], device='cpu')
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-4, (k, got[k], ref[k])
    assert got_str.splitlines() == ref_str.splitlines()
    assert 0 < got['Car_3d/moderate_R40'] < 100


def test_official_eval_needs_a_device_choice(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    gt = _val_gt()[:1]
    with pytest.raises(RuntimeError, match='no CUDA device'):
        kitti_eval.get_official_eval_result(gt, _perturbed_dets(gt, 0), ['Car'])


def _make_anno(boxes_cam, names, scores=None, bbox_h=50.0):
    """boxes_cam: (N, 7) [x, y, z, l, h, w, ry] camera frame."""
    n = len(names)
    boxes_cam = np.asarray(boxes_cam, np.float64).reshape(n, 7)
    return {'name': np.array(names), 'truncated': np.zeros(n), 'occluded': np.zeros(n),
            'alpha': np.full(n, -10.0) if scores is None else np.zeros(n),
            'bbox': np.tile(np.array([100.0, 100.0, 200.0, 100.0 + bbox_h]), (n, 1)),
            'dimensions': boxes_cam[:, 3:6], 'location': boxes_cam[:, 0:3],
            'rotation_y': boxes_cam[:, 6], 'difficulty': np.zeros(n, np.int32),
            'score': np.zeros(n) if scores is None else np.asarray(scores, np.float64)}


def _grid_cars(n):
    return [[(i % 10) * 12.0 - 60.0, 1.6, (i // 10) * 15.0 + 10.0, 3.9, 1.5, 1.6,
             0.1 * (i % 7)] for i in range(n)]


def test_kitti_eval_perfect_none_half():
    """The cases of tests/test_kitti_eval.py: 50 perfect detections score
    100, none score 0, half of 100 cars about 50."""
    boxes = _grid_cars(50)
    _, ret = kitti_eval.get_official_eval_result(
        [_make_anno(boxes, ['Car'] * 50)],
        [_make_anno(boxes, ['Car'] * 50, scores=np.linspace(0.99, 0.5, 50))],
        ['Car'], device='cpu')
    for diff in ('easy', 'moderate', 'hard'):
        for metric in ('3d', 'bev', 'image'):
            assert ret[f'Car_{metric}/{diff}_R40'] == pytest.approx(100.0, abs=1e-6)
    _, ret = kitti_eval.get_official_eval_result(
        [_make_anno(boxes[:1], ['Car'])], [_make_anno(np.zeros((0, 7)), [], scores=[])],
        ['Car'], device='cpu')
    assert ret['Car_3d/easy_R40'] == 0.0
    boxes = _grid_cars(100)
    _, ret = kitti_eval.get_official_eval_result(
        [_make_anno(boxes, ['Car'] * 100)],
        [_make_anno(boxes[:50], ['Car'] * 50, scores=np.linspace(0.99, 0.5, 50))],
        ['Car'], device='cpu')
    assert 45.0 < ret['Car_3d/easy_R40'] <= 52.5


# ------------------------------------------- prediction dicts and recall

def _pred_dicts(batch, seed, n_slots=12):
    """Fixed-shape predictions around each scan's gt (some slots invalid)."""
    rng = np.random.RandomState(seed)
    b = batch['gt_boxes'].shape[0]
    boxes = np.zeros((b, n_slots, 7), np.float32)
    for i in range(b):
        gt = batch['gt_boxes'][i][batch['gt_boxes'][i][:, 7] > 0][:, :7]
        src = gt[rng.randint(0, len(gt), n_slots)]
        boxes[i] = src + rng.normal(0, 0.3, src.shape).astype(np.float32)
    return {'pred_boxes': boxes,
            'pred_scores': rng.uniform(0, 1, (b, n_slots)).astype(np.float32),
            'pred_labels': np.ones((b, n_slots), np.int64),
            'pred_valid': rng.rand(b, n_slots) > 0.3}


def test_generate_prediction_dicts_matches_jax(eval_sets):
    jds, tds = eval_sets
    batch = tds.collate_batch([tds[i] for i in (4, 5, 6)])
    preds = _pred_dicts(batch, 0)
    ref = JaxKittiDataset.generate_prediction_dicts(batch, preds, ['Car'])
    got = KittiDataset.generate_prediction_dicts(batch, preds, ['Car'])
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert sorted(g) == sorted(r)
        assert g['frame_id'] == r['frame_id']
        np.testing.assert_array_equal(g['name'], r['name'])
        for k in r:
            if k not in ('name', 'frame_id'):
                np.testing.assert_allclose(g[k], r[k], rtol=0, atol=1e-6, err_msg=k)
    assert sum(len(a['name']) for a in got) > 0


def test_recall_counter_matches_jax(eval_sets):
    _, tds = eval_sets
    batch = tds.collate_batch([tds[i] for i in (10, 11)])
    preds = _pred_dicts(batch, 1)
    rois = _pred_dicts(batch, 2, n_slots=20)['pred_boxes']
    ref = jax_make_recall_fn((0.3, 0.5, 0.7))(
        jnp.asarray(preds['pred_boxes']), jnp.asarray(preds['pred_valid']),
        jnp.asarray(batch['gt_boxes']), jnp.asarray(rois))
    got = make_recall_fn((0.3, 0.5, 0.7))(
        torch.from_numpy(preds['pred_boxes']), torch.from_numpy(preds['pred_valid']),
        torch.from_numpy(batch['gt_boxes']), torch.from_numpy(rois))
    np.testing.assert_array_equal(got[0], np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1], np.asarray(ref[1]))
    assert got[2] == int(ref[2]) > 0
    assert got[0][0] > 0 and got[1][0] > 0


def test_build_dataset_refuses_unported_datasets():
    """A dataset the port has no class for is refused by name (KITTI,
    nuScenes and Waymo are ported: tests/test_torch_nuscenes.py and
    tests/test_torch_waymo.py)."""
    _, tcfg = _cfgs()
    cfg = EasyDict(dict(tcfg.DATA_CONFIG, DATASET='LyftDataset'))
    with pytest.raises(KeyError, match='LyftDataset'):
        build_dataset(cfg, ['Car'], training=False)


def test_dataset_meta_of_fixture_eval_shape():
    _, tcfg = _cfgs()
    meta = dataset_meta_from_cfg(tcfg.DATA_CONFIG, 'test')
    assert meta['voxel_capacity'] == 40000 and meta['grid_size'] == (1408, 1600, 40)
