"""The port's spans and counters (``fv2p_torch/utils/tracing.py``) on the CPU.

The tiny FV2P (``TINY_FV2P_CFG``) and the tiny MGAF-3DSSD
(``TINY_MODEL_CFG``) of the port's tests, with seeded weights: one FV2P
forward and one MGAF-3DSSD train step under ``torch.profiler`` leave every
span of the program with its parent and its count a step, each range of
the profiler's trace inside its parent's; with the gate shut nothing is
recorded; detections, loss terms and gradients are bitwise the same with
the gate open or shut; ``host_reads.*`` counts an NMS's fixed-point rounds
and RoI-aware pooling's read of its inside pairs;
``launch_counts`` reads the registry's ``launches.*`` counters; and the
registry does not grow with the steps it traces.
"""
import copy
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import fv2p_torch.models as torch_models
from fv2p_torch.config import EasyDict, cfg_from_yaml_file
from fv2p_torch.ops import cuda as kcuda
from fv2p_torch.ops import roiaware_pool
from fv2p_torch.ops.cuda import fps as fps_mod
from fv2p_torch.ops.dcn import MdeformConvBlock
from fv2p_torch.ops.sparse import host_rulebook
from fv2p_torch.ops.sparse.conv import _SparseConvBase
from fv2p_torch.train_utils.train_state import TrainStep
from fv2p_torch.utils import iou3d, tracing
from fv2p_torch.utils.synthetic import batch_to_torch
from fv2p_torch.weights import init_random_
from tests.test_fv2p_model import TINY_FV2P_CFG, make_fv2p_batch
from tests.test_mgaf_model import TINY_MODEL_CFG
from tests.test_torch_model import BACKBONE, one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
MGAF_YAML = REPO / 'tools/cfgs/kitti_models/MGAF-3DSSD/mgaf-3dssd.yaml'
ROUND_READ = 'host_reads.iou3d.fixed_point_round'

# span -> its parent, for one FV2P eval forward and one MGAF-3DSSD train step
FV2P_FORWARD = {
    'slot:vfe': None, 'slot:backbone_3d': None, 'slot:map_to_bev_module': None,
    'slot:backbone_2d': None, 'slot:dense_head': None, 'slot:post_pfe': None,
    'slot:point_head': None, 'slot:roi_head': None, 'slot:post_processing': None,
    'slot:sparse_conv': 'slot:backbone_3d', 'slot:sparse_conv.gather': 'slot:sparse_conv',
    'slot:roi_head.proposal_nms': 'slot:roi_head', 'slot:roi_head.pass1': 'slot:roi_head',
    'slot:roi_head.pass2': 'slot:roi_head',
    'slot:post_processing.nms': 'slot:post_processing'}
MGAF_TRAIN_STEP = {
    'phase:forward_loss': None, 'phase:backward': None, 'phase:update': None,
    'slot:vfe': 'phase:forward_loss', 'slot:backbone_3d': 'phase:forward_loss',
    'slot:map_to_bev_module': 'phase:forward_loss', 'slot:backbone_2d': 'phase:forward_loss',
    'slot:dense_head': 'phase:forward_loss',
    'slot:sparse_conv': 'slot:backbone_3d', 'slot:sparse_conv.gather': 'slot:sparse_conv',
    'phase:sparse_conv.backward': 'phase:backward',
    'phase:sparse_conv.backward.gather': 'phase:sparse_conv.backward',
    'slot:dcn': ('slot:backbone_2d', 'slot:dense_head'), 'slot:dcn.sample': 'slot:dcn',
    'phase:dcn.backward': 'phase:backward'}


def _np(batch):
    return {k: np.array(v) for k, v in batch.items()}


@pytest.fixture(autouse=True)
def fresh_registry():
    """Each test starts from an empty registry with the gate shut."""
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


@pytest.fixture(scope='module')
def fv2p():
    """The tiny FV2P in eval mode, seeded, and its batch on the CPU."""
    batch, meta = make_fv2p_batch()
    b = _np(batch)
    b.pop('gt_boxes')
    host_rulebook.prepare_batch_rulebooks(b, BACKBONE, meta['grid_size'])
    model = torch_models.build_network(TINY_FV2P_CFG, 1, ['Car'], meta, device='cpu')
    return init_random_(model, 0).eval(), batch_to_torch(b, 'cpu')


@pytest.fixture(scope='module')
def mgaf():
    """A function that builds the tiny MGAF-3DSSD's train step from seed 0,
    and the tiny FV2P's batch (its two gt cars included) on the CPU."""
    batch, meta = make_fv2p_batch()
    b = _np(batch)
    host_rulebook.prepare_batch_rulebooks(b, BACKBONE, meta['grid_size'])
    optim = EasyDict()
    cfg_from_yaml_file(str(MGAF_YAML), optim)

    def new_step():
        model = torch_models.build_network(TINY_MODEL_CFG, 1, ['Car'], meta, device='cpu')
        return TrainStep(init_random_(model, 0), optim.OPTIMIZATION, 100)
    return new_step, batch_to_torch(b, 'cpu')


def _fv2p_forward(fv2p):
    model, batch = fv2p
    return model(dict(batch))


def _mgaf_train_step(mgaf):
    new_step, batch = mgaf
    step = new_step()
    return step, step.step(dict(batch))


def _expected_counts(case, fv2p, mgaf):
    """Span openings a step that the module structure fixes."""
    model = fv2p[0] if case == 'fv2p_forward' else mgaf[0]().module
    convs = sum(isinstance(m, _SparseConvBase) for m in model.modules())
    if case == 'fv2p_forward':
        return {'slot:sparse_conv': convs, 'slot:sparse_conv.gather': convs,
                'slot:roi_head.pass1': 1, 'slot:roi_head.pass2': 1,
                'slot:post_processing.nms': 2}       # one NMS a scan
    dcns = [m for m in model.modules() if isinstance(m, MdeformConvBlock)]
    taps = sum(m.kernel_size ** 2 for m in dcns)
    # the first conv's input (the VFE's means) needs no gradient: one
    # gather in its backward, two in every other
    return {'slot:sparse_conv': convs, 'slot:sparse_conv.gather': convs,
            'phase:sparse_conv.backward': convs,
            'phase:sparse_conv.backward.gather': 2 * convs - 1,
            'slot:dcn': len(dcns), 'slot:dcn.sample': len(dcns) + taps,
            'phase:dcn.backward': len(dcns)}


def test_a_shut_gate_records_nothing(fv2p, mgaf):
    assert not tracing.enabled()
    assert tracing.span('slot:anything') is tracing.NO_SPAN
    _fv2p_forward(fv2p)
    _mgaf_train_step(mgaf)
    snap = tracing.snapshot()
    assert snap['spans'] == {} and snap['traced_steps'] == 0
    assert snap['steps'] == 2
    assert tracing.REGISTRY.stack == [] and tracing.REGISTRY.pending == []


@pytest.mark.parametrize('case', ['fv2p_forward', 'mgaf_train_step'])
def test_each_span_has_its_parent_and_count_a_step(case, fv2p, mgaf):
    table = FV2P_FORWARD if case == 'fv2p_forward' else MGAF_TRAIN_STEP
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _fv2p_forward(fv2p) if case == 'fv2p_forward' else _mgaf_train_step(mgaf)
    snap = tracing.snapshot()
    assert snap['steps'] == snap['traced_steps'] == 1
    assert set(snap['spans']) == set(table)
    for name, parent in table.items():
        span = snap['spans'][name]
        parents = parent if isinstance(parent, tuple) else (parent,) if parent else ()
        assert set(span['parents']) == set(parents), name
        assert span['count'] >= 1, name
        assert span['device_ms'] is span['self_device_ms'] is None   # no card
    for name, n in _expected_counts(case, fv2p, mgaf).items():
        assert snap['spans'][name]['count'] == n, name
    # every program range of the profiler's trace lies inside its parent's
    ranges = [e for e in prof.events() if e.name in table]
    assert {e.name for e in ranges} == set(table)
    for e in ranges:
        parents = table[e.name] if isinstance(table[e.name], tuple) else (table[e.name],)
        if parents == (None,):
            continue
        assert any(p.name in parents and p.time_range.start <= e.time_range.start
                   and e.time_range.end <= p.time_range.end for p in ranges), e.name


def test_every_span_name_starts_with_slot_or_phase(fv2p, mgaf):
    tracing.enable()
    _fv2p_forward(fv2p)
    _mgaf_train_step(mgaf)
    names = set(tracing.snapshot()['spans'])
    assert names >= set(FV2P_FORWARD) | set(MGAF_TRAIN_STEP)
    assert all(n.startswith(tracing.PREFIXES) for n in names)


def test_counts_are_filed_under_the_innermost_span(fv2p):
    tracing.enable()
    _fv2p_forward(fv2p)
    snap = tracing.snapshot()
    by_site = {name: s['counts'].get(ROUND_READ, 0) for name, s in snap['spans'].items()}
    assert by_site['slot:roi_head.proposal_nms'] >= 2          # one NMS a scan
    assert by_site['slot:post_processing.nms'] >= 2
    assert sum(by_site.values()) == snap['counters'][ROUND_READ]


@pytest.mark.parametrize('what', ['detections', 'train_step'])
def test_results_are_bitwise_the_same_with_the_gate_open(what, fv2p, mgaf):
    runs = []
    for gate in (False, True):
        tracing.enable() if gate else tracing.disable()
        if what == 'detections':
            out = _fv2p_forward(fv2p)
            runs.append({k: v for k, v in out.items() if k.startswith('pred_')})
        else:
            step, terms = _mgaf_train_step(mgaf)
            grads = {k: p.grad.clone() for k, p in step.module.named_parameters()
                     if p.grad is not None}
            params = {k: p.detach().clone() for k, p in step.module.named_parameters()}
            runs.append({**{f'term.{k}': v for k, v in terms.items()},
                         **{f'grad.{k}': v for k, v in grads.items()},
                         **{f'param.{k}': v for k, v in params.items()}})
    off, on = runs
    assert set(off) == set(on) and len(off) >= 4
    for k in off:
        assert torch.equal(off[k], on[k]), k
    assert tracing.snapshot()['traced_steps'] == 1


def _chain(n, gap=0.8):
    """n unit boxes in a row, each overlapping only its neighbours (IoU
    0.2 / 1.8 at gap 0.8), scores falling along the row; gap 2 parts
    them all."""
    boxes = torch.zeros((n, 7))
    boxes[:, 0] = torch.arange(n) * gap
    boxes[:, 3:6] = 1.0
    return boxes, torch.linspace(1.0, 0.5, n)


def _rounds(boxes, thresh):
    """The reads ``_greedy_by_fixed_point`` makes, from a plain simulation
    of its map: the first step that changes nothing ends the first round
    that holds it, within the loop's n + 1 steps."""
    n = boxes.shape[0]
    iou = iou3d.boxes_iou_bev(boxes, boxes).numpy()
    over = np.triu(iou > thresh, 1)
    keep, step = np.ones(n, bool), 0
    while True:
        step += 1
        nxt = ~((keep.astype(np.float32) @ over) > 0)
        if (nxt == keep).all():
            break
        keep = nxt
    per = iou3d._FIXED_POINT_ROUND
    return min(-(-step // per), len(range(0, n + 1, per)))


@pytest.mark.parametrize('n, gap', [(6, 2.0), (12, 0.8), (20, 0.8), (40, 0.8)])
def test_host_reads_count_the_fixed_point_rounds(n, gap):
    boxes, scores = _chain(n, gap)
    expected = _rounds(boxes, 0.1)
    assert expected == {(6, 2.0): 1, (12, 0.8): 2, (20, 0.8): 3, (40, 0.8): 5}[(n, gap)]
    keep_idx, keep_valid = iou3d.nms_rotated(boxes, scores, 0.1, pre_max=n, post_max=n)
    assert tracing.counter(ROUND_READ) == expected
    kept = keep_idx[keep_valid].tolist()
    assert kept == (list(range(n)) if gap > 1 else list(range(0, n, 2)))


def test_roiaware_pooling_counts_its_read_of_the_inside_pairs():
    points = torch.rand((32, 3), generator=torch.Generator().manual_seed(0)) * 2 - 1
    rois = torch.tensor([[0.0, 0.0, 0.0, 1.0, 1.0, 1.0, 0.3],
                         [0.5, 0.0, 0.0, 0.5, 0.5, 0.5, 0.0]])
    tracing.enable()
    with tracing.span('slot:roi_head'):
        for method in ('max', 'avg'):
            roiaware_pool.roiaware_pool3d(points, torch.ones((32, 4)),
                                          torch.ones(32, dtype=torch.bool), rois, 2, method)
    snap = tracing.snapshot()
    site = 'host_reads.roiaware_pool.inside_pairs'
    assert snap['counters'] == {site: 2}
    assert snap['spans']['slot:roi_head']['counts'] == {site: 2}


def test_launch_counts_read_the_registry(monkeypatch):
    assert dict(kcuda.launch_counts) == {k: 0 for k in kcuda.KERNELS}
    monkeypatch.setattr(fps_mod, '_launch', lambda *args: None)
    fps_mod.fps_cuda(None, None, 1)
    fps_mod.fps_cuda(None, None, 1)
    tracing.count('launches.three_nn')
    assert kcuda.launch_counts['fps'] == 2 == tracing.counter('launches.fps')
    assert kcuda.launch_counts['three_nn'] == 1
    assert len(kcuda.launch_counts) == len(kcuda.KERNELS)
    with pytest.raises(KeyError):
        kcuda.launch_counts['no_such_kernel']
    tracing.count('host_reads.elsewhere')
    kcuda.reset_launch_counts()
    assert all(v == 0 for v in kcuda.launch_counts.values())
    assert tracing.counter('host_reads.elsewhere') == 1


def _size(reg):
    """Entries the registry holds."""
    return (len(reg.counters) + len(reg.stack) + len(reg.pending) + len(reg.idle_events)
            + sum(1 + len(a['parents']) + len(a['counts']) for a in reg.spans.values()))


def test_the_registry_does_not_grow_with_the_steps_it_traces(fv2p):
    tracing.enable()
    model, batch = fv2p
    for _ in range(5):
        model(dict(batch))
    size = _size(tracing.REGISTRY)
    five = copy.deepcopy(tracing.snapshot())
    for _ in range(45):
        model(dict(batch))
    fifty = tracing.snapshot()
    assert _size(tracing.REGISTRY) == size
    assert fifty['traced_steps'] == 50 and five['traced_steps'] == 5
    assert set(fifty['spans']) == set(five['spans'])
    for name, span in fifty['spans'].items():
        assert span['count'] == 10 * five['spans'][name]['count'], name
