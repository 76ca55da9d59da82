"""The port's Waymo path against the JAX package on the CPU.

* B2 at Waymo's scan size: the kernel's plain version (``fps_plain``)
  against JAX's Pallas kernel in interpret mode, and the port's
  ``farthest_point_sample_batch`` (wraparound padding) against JAX's
  through XLA, at N = 180000 (a random mask, a row with no valid point, a
  30000-point prefix with holes; K = 32) and at N = 2048 (K = 512).
* ``np_box_ops.boxes_iou3d_np`` against JAX's, and the native evaluator on
  the cases of ``tests/test_waymo_eval_native.py`` (each run through both
  estimators).
* ``WaymoDataset`` on the committed fixture (``data/waymo``) with
  ``waymo_fv2p_e30.yaml``'s DATA_CONFIG at SAMPLED_INTERVAL 1 (every frame
  of the fixture): every test and train sample (gt sampling with
  LIMIT_WHOLE_SCENE, flips along x and y, rotation, scaling, the shuffle),
  the prediction dicts and both evaluations of the val split.
  ``create_groundtruth_database`` and the fixture generator
  (``fv2p_torch.tools.make_synthetic_waymo`` against
  ``tools/make_synthetic_waymo.py``) write the same bytes.
* A tiny Waymo FV2P (``TINY_FV2P_CFG`` with Waymo's Vehicle anchors) on a
  Waymo batch cut to a 51.2 m square at 0.4 m voxels (5 point features, 40
  height slices as Waymo's grid), JAX's weights carried across by
  ``load_flax_variables``: the eval forward end to end; and the same model
  through ``fv2p_torch.tools.test`` with Waymo's native metric.

Tolerances: samples, database bytes, ap dicts and indices exact (the same
numpy code and the same draws); ``boxes_iou3d_np`` within 1e-6 (both are
float64 numpy); the forward as ``tests/test_torch_model.py`` holds it:
integers exact, floats rtol 1e-4 with atol 1e-4 scaled to the output's
magnitude below 1.
"""
import copy
import importlib.util
import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from fv2p_tpu.config import EasyDict as JaxEasyDict
from fv2p_tpu.config import cfg_from_yaml_file as jax_cfg_from_yaml_file
from fv2p_tpu.datasets.waymo import waymo_eval_native as jax_native
from fv2p_tpu.datasets.waymo.waymo_dataset import WaymoDataset as JaxWaymo
from fv2p_tpu.models import build_network as jax_build_network
from fv2p_tpu.ops import pointops as jax_pointops
from fv2p_tpu.ops.pallas.fps import fps_pallas
from fv2p_tpu.utils import np_box_ops as jax_np_box_ops
from tests import test_waymo_eval_native as jax_native_cases
from tests.jitu import japply, jinit
from tests.test_fv2p_model import TINY_FV2P_CFG
from tests.test_torch_data import _assert_samples_equal
from tests.test_torch_model import (_three_nn_interpolate_pallas, assert_close,
                                    assert_equal, perturb_bn, to_jax)

import fv2p_torch.models as torch_models
from fv2p_torch.config import EasyDict, cfg_from_yaml_file
from fv2p_torch.datasets import build_dataset, dataset_meta_from_cfg
from fv2p_torch.datasets.waymo import waymo_eval_native
from fv2p_torch.datasets.waymo.waymo_dataset import WaymoDataset
from fv2p_torch.ops import pointops
from fv2p_torch.ops.cuda.fps import fps_plain
from fv2p_torch.tools import make_synthetic_waymo, test as test_runner
from fv2p_torch.utils import np_box_ops
from fv2p_torch.utils.synthetic import batch_to_torch
from fv2p_torch.weights import load_flax_variables
from tests.test_torch_model import one_torch_thread  # noqa: F401 (an autouse fixture)

REPO = Path(__file__).resolve().parent.parent
WAYMO = REPO / 'data' / 'waymo'
FV2P_YAML = str(REPO / 'tools/cfgs/waymo_models/FV2P/waymo_fv2p_e30.yaml')


# ------------------------------------------------------------------ B2

def _fps_case(n, k):
    rng = np.random.RandomState(n)
    pts = (rng.randn(3, n, 3) * 20).astype(np.float32)
    valid = rng.rand(3, n) < 0.17                 # not a prefix
    valid[1] = False                              # no valid point
    valid[2] = False
    valid[2, :min(30000, n // 2)] = True          # a padded scan with holes
    valid[2, 7::11] = False
    return pts, valid, k


@pytest.mark.parametrize('n,k', [(180000, 32), (2048, 512)])
def test_b2_plain_matches_jax_at_waymo_scan_size(n, k):
    pts, valid, k = _fps_case(n, k)
    ref = np.asarray(fps_pallas(jnp.asarray(pts), jnp.asarray(valid), k, interpret=True))
    got = fps_plain(torch.from_numpy(pts), torch.from_numpy(valid), k).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (got[1] == 0).all()
    assert valid[[0, 2]][np.arange(2)[:, None], got[[0, 2]]].all()
    ref = np.asarray(jax_pointops.farthest_point_sample_batch(
        jnp.asarray(pts), jnp.asarray(valid), k))
    got = pointops.farthest_point_sample_batch(
        torch.from_numpy(pts), torch.from_numpy(valid), k).numpy()
    np.testing.assert_array_equal(got, ref)


# ------------------------------------------------- boxes and the metrics

def test_boxes_iou3d_np_matches_jax():
    rng = np.random.RandomState(7)
    a = jax_native_cases._random_boxes(rng, 24)
    b = np.concatenate([a[:8] + rng.normal(0, 0.3, (8, 7)),
                        jax_native_cases._random_boxes(rng, 16), a[8:10]])
    ref = jax_np_box_ops.boxes_iou3d_np(a, b)
    got = np_box_ops.boxes_iou3d_np(a, b)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert (got > 0.1).sum() >= 10
    np.testing.assert_allclose(np_box_ops.boxes_iou_bev_np(a, b),
                               jax_np_box_ops.boxes_iou_bev_np(a, b), rtol=0, atol=1e-6)


class _BothEstimators:
    """JAX's estimator and the port's on the same input: the ap dicts must
    be equal key for key; returns JAX's."""

    def waymo_evaluation(self, *args, **kwargs):
        ref = jax_native.NativeWaymoDetectionMetricsEstimator().waymo_evaluation(
            *copy.deepcopy(args), **kwargs)
        got = waymo_eval_native.NativeWaymoDetectionMetricsEstimator().waymo_evaluation(
            *copy.deepcopy(args), **kwargs)
        assert got == ref
        return ref


@pytest.mark.parametrize('case', sorted(
    n for n in dir(jax_native_cases.TestNativeWaymoMetrics)
    if n.startswith('test_') and n != 'test_dataset_dispatch_uses_native'))
def test_native_eval_matches_jax_on_its_cases(case, monkeypatch):
    monkeypatch.setattr(jax_native_cases, 'NativeWaymoDetectionMetricsEstimator',
                        _BothEstimators)
    getattr(jax_native_cases.TestNativeWaymoMetrics(), case)()


# ------------------------------------------------------------ the dataset

def _cfgs(interval=1):
    jcfg, tcfg = JaxEasyDict(), EasyDict()
    jax_cfg_from_yaml_file(FV2P_YAML, jcfg)
    cfg_from_yaml_file(FV2P_YAML, tcfg)
    for cfg in (jcfg, tcfg):
        cfg.DATA_CONFIG.SAMPLED_INTERVAL = {'train': interval, 'test': interval}
    return jcfg, tcfg


def _datasets(training, seed):
    jcfg, tcfg = _cfgs()
    np.random.seed(seed)
    jds = JaxWaymo(jcfg.DATA_CONFIG, jcfg.CLASS_NAMES, training=training, root_path=WAYMO)
    tds = build_dataset(tcfg.DATA_CONFIG, tcfg.CLASS_NAMES, training=training,
                        root_path=WAYMO, rng=np.random.RandomState(seed))
    return jds, tds


@pytest.mark.parametrize('training', [True, False], ids=['train', 'test'])
def test_waymo_samples_match_jax(training):
    """Every frame of the split in order: 5-feature voxels at the mode's cap
    (80000 train, 90000 test), 180000-point scans with their valid prefix,
    gt rows padded to MAX_GT_BOXES, the metadata."""
    jds, tds = _datasets(training, seed=3)
    assert isinstance(tds, WaymoDataset)
    assert [i['frame_id'] for i in tds.infos] == [i['frame_id'] for i in jds.infos]
    assert len(tds) == (4 if training else 2)
    for index in range(len(tds)):
        ref, got = jds[index], tds[index]
        _assert_samples_equal(got, ref)
        assert got['voxels'].shape == ((80000 if training else 90000), 5, 5)
        assert got['points'].shape == (180000, 5)
        assert 20000 < got['points_valid'].sum() <= 30000
        assert (got["gt_boxes"][:, -1] > 0).sum() >= 2     # the two vehicles, and sampled ones
    assert tds.collate_batch([tds[0], tds[1]])['voxels'].shape[0] == 2


def test_sampled_interval_and_sequence_names(tmp_path):
    """The yaml's SAMPLED_INTERVAL 5 keeps the first frame of the fixture's
    4 train and 2 val frames; both tfrecord naming schemes resolve."""
    jcfg, tcfg = _cfgs(interval=5)
    for training in (True, False):
        jds = JaxWaymo(jcfg.DATA_CONFIG, jcfg.CLASS_NAMES, training=training,
                       root_path=WAYMO)
        tds = WaymoDataset(tcfg.DATA_CONFIG, tcfg.CLASS_NAMES, training=training,
                           root_path=WAYMO)
        assert [i['frame_id'] for i in tds.infos] == [i['frame_id'] for i in jds.infos]
        assert len(tds) == 1
    (tmp_path / 'a_with_camera_labels.tfrecord').write_text('')
    (tmp_path / 'b.tfrecord').write_text('')
    for name in ('a.tfrecord', 'b_with_camera_labels.tfrecord', 'c.tfrecord'):
        assert WaymoDataset.check_sequence_name_with_all_version(tmp_path / name) == \
            JaxWaymo.check_sequence_name_with_all_version(tmp_path / name)
    tds.set_split('train')
    assert tds.sample_sequence_list == ['segment-0000000_synth.tfrecord',
                                        'segment-0000001_synth.tfrecord']
    assert tds.infos == []


def test_generate_prediction_dicts_matches_jax():
    rng = np.random.RandomState(2)
    b, n = 2, 30
    pred = {'pred_boxes': rng.randn(b, n, 7).astype(np.float32),
            'pred_scores': rng.rand(b, n).astype(np.float32),
            'pred_labels': rng.randint(1, 4, (b, n)),
            'pred_valid': rng.rand(b, n) > 0.3}
    pred['pred_valid'][1] = False
    batch = {'frame_id': ['a', 'b'],
             'metadata': np.array([{'context_name': 'a'}, {'context_name': 'b'}],
                                  dtype=object)}
    classes = ['Vehicle', 'Pedestrian', 'Cyclist']
    ref = JaxWaymo.generate_prediction_dicts(batch, pred, classes)
    got = WaymoDataset.generate_prediction_dicts(batch, pred, classes)
    assert len(got) == len(ref) == 2 and len(got[1]['score']) == 0
    for g, r in zip(got, ref):
        assert sorted(g) == sorted(r)
        for k in r:
            if isinstance(r[k], np.ndarray):
                np.testing.assert_array_equal(g[k], r[k])
            else:
                assert g[k] == r[k]


@pytest.mark.parametrize('metric', ['waymo', 'kitti'])
def test_evaluation_matches_jax_on_the_fixture(metric):
    """The val split's ground truth as detections, moved by 0.3 m and
    turned, scored by both datasets' ``evaluation`` (the KITTI-format one
    with its overlaps on the CPU; the Waymo one native, on the host)."""
    jds, tds = _datasets(False, seed=0)
    rng = np.random.RandomState(11)
    annos = []
    for info in tds.infos:
        boxes = np.asarray(info['annos']['gt_boxes_lidar'], np.float64).copy()
        boxes[:, :2] += rng.normal(0, 0.3, (len(boxes), 2))
        boxes[:, 6] += rng.normal(0, 0.3, len(boxes))
        annos.append({'name': info['annos']['name'].copy(), 'boxes_lidar': boxes,
                      'score': rng.uniform(0.2, 1.0, len(boxes)),
                      'frame_id': info['frame_id']})
    ref = jds.evaluation(copy.deepcopy(annos), ['Vehicle', 'Pedestrian'],
                         eval_metric=metric)
    got = tds.evaluation(copy.deepcopy(annos), ['Vehicle', 'Pedestrian'], device='cpu',
                         eval_metric=metric)
    assert got[0] == ref[0]
    assert got[1] == ref[1]
    if metric == 'waymo':
        assert 0 < got[1]['OBJECT_TYPE_TYPE_VEHICLE_LEVEL_1/AP'] <= 1
        assert 0 < got[1]['OBJECT_TYPE_TYPE_VEHICLE_LEVEL_2/APH'] <= 1
    else:
        assert max(v for k, v in got[1].items() if k.startswith('Car_3d')) > 0


def _copy_frames(dst):
    for sub in ('ImageSets', 'waymo_processed_data'):
        shutil.copytree(WAYMO / sub, dst / sub)


def _tree(root):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob('*')) if p.is_file()}


def test_create_groundtruth_database_matches_jax(tmp_path):
    """The fixture's train infos cropped into a gt database by each package
    from a copy of its frames: the same .bin files and the same pickled
    database infos, byte for byte."""
    jcfg, tcfg = _cfgs()
    trees = {}
    for name, cls, cfg in (('jax', JaxWaymo, jcfg), ('torch', WaymoDataset, tcfg)):
        root = tmp_path / name
        _copy_frames(root)
        ds = cls(cfg.DATA_CONFIG, ['Vehicle', 'Pedestrian', 'Cyclist'], training=False,
                 root_path=root)
        ds.create_groundtruth_database(WAYMO / 'waymo_infos_train.pkl', root, split='train',
                                       sampled_interval=1,
                                       used_classes=['Vehicle', 'Pedestrian'])
        trees[name] = {k: v for k, v in _tree(root).items()
                       if k.startswith('pcdet_')}
    assert trees['torch'] == trees['jax']
    assert len(trees['torch']) == 1 + 4 * 3


def test_generator_matches_jax_tool(tmp_path):
    """``python -m fv2p_torch.tools.make_synthetic_waymo DIR`` and
    ``python tools/make_synthetic_waymo.py DIR`` write the same tree."""
    spec = importlib.util.spec_from_file_location(
        'jax_make_synthetic_waymo', REPO / 'tools' / 'make_synthetic_waymo.py')
    jax_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_tool)
    jax_tool.main(tmp_path / 'jax')
    make_synthetic_waymo.main(tmp_path / 'torch')
    ref, got = _tree(tmp_path / 'jax'), _tree(tmp_path / 'torch')
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k] == ref[k], k
    assert 'pcdet_waymo_dbinfos_train_sampled_10.pkl' in got


def test_x_conv1_capacity_is_the_voxel_cap():
    """waymo_fv2p_e30.yaml's flat LEVEL_CAPACITIES give x_conv1 90000 rows
    in both modes, but training voxelises at most 80000: the port's host
    tables take x_conv1's rows from the voxel cap (the level holds the
    voxels), JAX's from the yaml, whose backbone then fails on tables wider
    than its input (``ROADMAP.md`` C10). Every other level keeps the yaml's
    capacity in both packages."""
    from fv2p_tpu.ops.sparse import host_rulebook as jax_host_rulebook
    from fv2p_torch.ops.sparse import host_rulebook
    _, tcfg = _cfgs()
    caps = host_rulebook.select_mode_caps(tcfg.MODEL.BACKBONE_3D.LEVEL_CAPACITIES, True)
    grid = (1504, 1504, 40)
    got = host_rulebook.backbone_spec('VoxelResBackBone8x', grid, 80000, caps)['caps']
    ref = jax_host_rulebook.backbone_spec('VoxelResBackBone8x', grid, 80000, caps)['caps']
    assert got['x_conv1'] == 80000 and ref['x_conv1'] == 90000
    assert {k: v for k, v in got.items() if k != 'x_conv1'} == \
        {k: v for k, v in ref.items() if k != 'x_conv1'}
    test = host_rulebook.backbone_spec('VoxelResBackBone8x', grid, 90000, caps)['caps']
    assert test == jax_host_rulebook.backbone_spec('VoxelResBackBone8x', grid, 90000,
                                                   caps)['caps']


def test_jax_fails_on_x_conv1_wider_than_the_voxel_cap():
    """JAX's side of C10 on the tiny FV2P: host tables whose x_conv1 is 64
    rows wider than the voxel cap fail JAX's backbone with a shape error;
    the port's tables and forward take the same override."""
    from fv2p_tpu.ops.sparse import host_rulebook as jax_host_rulebook
    from fv2p_torch.ops.sparse import host_rulebook
    from tests.test_fv2p_model import make_fv2p_batch
    batch, meta = make_fv2p_batch()
    base = {k: np.array(v) for k, v in batch.items() if k != 'gt_boxes'}
    cap = base['voxels'].shape[1]
    caps = dict(jax_host_rulebook.level_capacities(cap), x_conv1=cap + 64)
    jax_np, torch_np = copy.deepcopy(base), copy.deepcopy(base)
    jax_host_rulebook.prepare_batch_rulebooks(jax_np, 'VoxelResBackBone8x', meta['grid_size'],
                                              caps_override=caps)
    host_rulebook.prepare_batch_rulebooks(torch_np, 'VoxelResBackBone8x', meta['grid_size'],
                                          caps_override=caps)
    assert jax_np['rulebooks']['subm_x_conv1'].shape[-1] == cap + 64
    assert torch_np['rulebooks']['subm_x_conv1'].shape[-1] == cap
    jmodel = jax_build_network(TINY_FV2P_CFG, num_class=1, class_names=['Car'],
                               dataset_meta=meta)
    with pytest.raises(ValueError, match='shapes'):
        jinit(jmodel, {'params': jax.random.PRNGKey(0), 'sampling': jax.random.PRNGKey(1),
                       'dropout': jax.random.PRNGKey(2)}, to_jax(jax_np))
    tmodel = torch_models.build_network(TINY_FV2P_CFG, 1, ['Car'], meta, device='cpu')
    with torch.no_grad():
        out = tmodel(batch_to_torch(torch_np, 'cpu'))
    assert torch.isfinite(out['pred_boxes']).all()


# ---------------------------------------------------- a tiny Waymo FV2P

TINY_GRID = {'range': [-25.6, -25.6, -2, 25.6, 25.6, 4], 'voxel': [0.4, 0.4, 0.15],
             'voxels': 6000, 'points': 6000}


def tiny_waymo_cfg_dict():
    """The tiny FV2P with waymo_fv2p_e30.yaml's Vehicle anchors over its
    DATA_CONFIG cut to TINY_GRID (128 x 128 x 40 voxels, 6000 voxels and
    6000 raw points a scan), every frame (SAMPLED_INTERVAL 1), and
    SCORE_THRESH 0 so that seeded weights give detections, and level
    capacities of its own."""
    full = EasyDict()
    cfg_from_yaml_file(FV2P_YAML, full)
    dc = json.loads(json.dumps(full.DATA_CONFIG))
    dc.update(DATA_PATH=str(WAYMO), POINT_CLOUD_RANGE=TINY_GRID['range'],
              MAX_POINTS_PER_SCAN=TINY_GRID['points'],
              SAMPLED_INTERVAL={'train': 1, 'test': 1})
    for proc in dc['DATA_PROCESSOR']:
        if proc['NAME'] == 'transform_points_to_voxels':
            proc['VOXEL_SIZE'] = TINY_GRID['voxel']
            proc['MAX_NUMBER_OF_VOXELS'] = {'train': TINY_GRID['voxels'],
                                            'test': TINY_GRID['voxels']}
    model = json.loads(json.dumps(TINY_FV2P_CFG))
    model['DENSE_HEAD']['ANCHOR_GENERATOR_CONFIG'] = json.loads(json.dumps(
        full.MODEL.DENSE_HEAD.ANCHOR_GENERATOR_CONFIG))
    model['POST_PROCESSING']['SCORE_THRESH'] = 0.0
    # Waymo's sparse occupancy dilates at the strided levels, as the yaml's
    # own LEVEL_CAPACITIES say: room for it at the tiny grid
    model['BACKBONE_3D']['LEVEL_CAPACITIES'] = {
        'x_conv2': 16384, 'x_conv3': 12288, 'x_conv4': 8192, 'out': 4096}
    return {'CLASS_NAMES': ['Vehicle'], 'DATA_CONFIG': dc, 'MODEL': model,
            'OPTIMIZATION': json.loads(json.dumps(full.OPTIMIZATION))}


@pytest.fixture(scope='module')
def tiny_run():
    cfg_d = tiny_waymo_cfg_dict()
    jcfg, tcfg = JaxEasyDict(cfg_d), EasyDict(cfg_d)
    bb, caps = tcfg.MODEL.BACKBONE_3D.NAME, cfg_d['MODEL']['BACKBONE_3D']['LEVEL_CAPACITIES']
    np.random.seed(0)
    jds = JaxWaymo(jcfg.DATA_CONFIG, jcfg.CLASS_NAMES, training=False)
    tds = WaymoDataset(tcfg.DATA_CONFIG, tcfg.CLASS_NAMES, training=False,
                       rng=np.random.RandomState(0))
    jds.set_rulebook_spec(bb, caps_override=caps)
    tds.set_rulebook_spec(bb, caps_override=caps)
    jax_np = jds.collate_batch([jds[0], jds[1]])
    torch_np = tds.collate_batch([tds[0], tds[1]])
    meta = dataset_meta_from_cfg(tcfg.DATA_CONFIG, 'test')
    assert meta['grid_size'] == (128, 128, 40) and meta['num_point_features'] == 5
    jmodel = jax_build_network(jcfg.MODEL, num_class=1, class_names=['Vehicle'],
                               dataset_meta=meta)
    jb = to_jax({k: v for k, v in jax_np.items()
                 if k == 'rulebooks' or (isinstance(v, np.ndarray) and v.dtype != object)})
    variables = jinit(jmodel, {'params': jax.random.PRNGKey(3),
                               'sampling': jax.random.PRNGKey(1),
                               'dropout': jax.random.PRNGKey(2)}, dict(jb))
    vnp = perturb_bn(jax.tree_util.tree_map(np.asarray, dict(variables)),
                     np.random.RandomState(3))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_pointops, 'three_nn_interpolate', _three_nn_interpolate_pallas)
        out = japply(jmodel, jax.tree_util.tree_map(jnp.asarray, vnp), dict(jb))
    tmodel = torch_models.build_network(tcfg.MODEL, 1, ['Vehicle'], meta, device='cpu')
    load_flax_variables(tmodel, vnp)
    with torch.no_grad():
        tout = tmodel(batch_to_torch(torch_np, 'cpu'))
    return {'cfg_d': cfg_d, 'vars': vnp, 'out': out, 'tout': tout,
            'jax_np': jax_np, 'torch_np': torch_np}


def test_tiny_waymo_fv2p_forward_matches_jax(tiny_run):
    """Each package's dataset and host rulebooks, then the eval forward end
    to end: RoIs, the RCNN's outputs and the final detections."""
    jr, tr = tiny_run['jax_np']['rulebooks'], tiny_run['torch_np']['rulebooks']
    assert sorted(jr) == sorted(tr)
    for k in jr:
        assert_equal(tr[k], jr[k])
    out, tout = tiny_run['out'], tiny_run['tout']
    assert_equal(tout['point_coords'], out['point_coords'])
    assert_equal(tout['roi_valid'], out['roi_valid'])
    assert_close(tout['rois'], out['rois'])
    for key in ('batch_cls_preds', 'batch_box_preds', 'batch_iouscore_preds'):
        assert_close(tout[key], out[key])
    assert_equal(tout['pred_valid'], out['pred_valid'])
    assert_equal(tout['pred_labels'], out['pred_labels'])
    assert_close(tout['pred_boxes'], out['pred_boxes'])
    assert_close(tout['pred_scores'], out['pred_scores'])
    assert np.asarray(out['pred_valid']).sum() > 0


def test_test_runner_scores_waymo_natively(tiny_run, tmp_path):
    """``fv2p_torch.tools.test`` on the tiny model's checkpoint (JAX's
    weights) over the fixture's val split with EVAL_METRIC waymo:
    result.json carries Vehicle L1/L2 AP and APH, and the recall counts."""
    cfg_d = copy.deepcopy(tiny_run['cfg_d'])
    cfg_d['MODEL']['POST_PROCESSING']['EVAL_METRIC'] = 'waymo'
    cfg_file = tmp_path / 'tiny_waymo_fv2p.yaml'
    cfg_file.write_text(yaml.safe_dump(cfg_d))
    meta = dataset_meta_from_cfg(EasyDict(cfg_d).DATA_CONFIG, 'test')
    model = torch_models.build_network(EasyDict(cfg_d).MODEL, 1, ['Vehicle'], meta,
                                       device='cpu')
    load_flax_variables(model, tiny_run['vars'])
    torch.save({'model_state': model.state_dict()}, tmp_path / 'ckpt.pth')
    ret = test_runner.main(['--cfg_file', str(cfg_file), '--device', 'cpu', '--dtype',
                            'float32', '--workers', '0', '--batch_size', '2',
                            '--output_dir', str(tmp_path / 'out'),
                            '--ckpt', str(tmp_path / 'ckpt.pth')])
    saved = json.loads((tmp_path / 'out' / 'eval' / 'result.json').read_text())
    keys = {f'OBJECT_TYPE_TYPE_VEHICLE_LEVEL_{lv}/{m}' for lv in (1, 2) for m in ('AP', 'APH')}
    assert keys == {k for k in saved if k.startswith('OBJECT_TYPE')}
    for k in keys:
        assert saved[k] == ret[k] and 0.0 <= saved[k] <= 1.0
    assert 'recall/rcnn_0.3' in saved and not any(k.startswith('Car_') for k in saved)
