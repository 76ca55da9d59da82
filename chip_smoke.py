#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py          # from the repository root, one CUDA card

It builds the four hand-written CUDA kernels (nvcc, sm_90a), builds FV2P
(tools/cfgs/kitti_models/FV2P/fv2p.yaml) at full width in bf16 with seeded
random weights, and drives KITTI Car inference on the bench batch: batch 4,
16000-voxel cap with 14000 filled from ray-cast surface scans, host
rulebooks, 18000 raw points per scan. Then it

  * checks that each kernel's launch counter moved during that forward;
  * replays every kernel call the forward made, kernel against its plain
    PyTorch version on the same card tensors (B2/B3 indices identical, B3
    squared distances within rtol 1e-6 + atol 1e-6, B1 areas within 1e-4
    and NMS keep lists identical, B4 within 2^-7 of max(|ref|, 2^-3)
    element by element: a sound kernel differs by at most one bf16 ulp);
  * runs the forward once more in f32 (no TF32) with the kernels and once
    with the plain versions, and compares the detections;
  * holds the FPS and SA-group kernels against their plain versions on small
    seeded corner cases (rows without valid points, ties, ball counts at and
    around nsample, ragged sizes), with the same comparisons;
  * times each kernel's calls of one forward with CUDA events beside its
    plain version, the least time the card could take for the same work,
    (B3) torch.cdist + topk as a library yardstick and (B2) the kernel's
    chain of cluster exchanges without its distance work; and times the whole
    forward on the batch already on the card (median of 20), per module, and
    the device's busy share in one profiled pass; and counts the calls in
    one forward that make the host wait for the card, by source line.

Exits non-zero on any failure, and without a CUDA card. The second-to-last
lines are a JSON ``kernels`` object and the nvidia-smi name and power limit;
the last line is ``{"ok": true, "device": {...}}``. A fuller record goes to
chiprun_out/chip_smoke.json.
"""
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
CFG = REPO / 'tools' / 'cfgs' / 'kitti_models' / 'FV2P' / 'fv2p.yaml'
OUT_DIR = REPO / 'chiprun_out'
BATCH, N_CAP, N_FILL, N_POINTS, SEED = 4, 16000, 14000, 18000, 0

# H100 SXM data sheet (dense): HBM rate, f32 outside the tensor cores, bf16
HBM_BYTES_S, F32_OPS_S, BF16_OPS_S = 3.35e12, 67e12, 989e12
# Sutherland-Hodgman over 4 edges x 8 slots + the shoelace sum (clip_area)
CLIP_OPS_PER_PAIR = 460
B1_ATOL = 1e-4
# B4 rounds its f32 sums to bf16 (8 significant bits) as the plain version
# does; another order of summation moves an output by one ulp at most, and
# one ulp of v is at most 2^-7 |v|. Below 2^-3 the allowance stays 2^-10.
B4_REL, B4_FLOOR = 2.0 ** -7, 2.0 ** -3
B3_DIST_TOL = 1e-6          # rtol and atol (m^2): both sides round alike
F32_ATOL = 1e-4
FORWARD_REPS = 20


def log(*a):
    print(*a, flush=True)


def fail(msg):
    log(f'FAIL: {msg}')
    sys.exit(1)


def sync():
    torch.cuda.synchronize()


def time_events(fn, reps, warmup=1):
    """Mean ms of fn() over reps runs, CUDA events around the whole loop."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    sync()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps


def clone_args(args):
    return tuple(a.clone() if torch.is_tensor(a) else a for a in args)


class Kernel:
    """One kernel: its wrapper module, entry points, the TPU kernel it
    replaces, and the calls the main path made to it."""

    def __init__(self, name, module, cuda_fn, plain_fn, source, replaces):
        self.name, self.module = name, module
        self.cuda_fn, self.plain_fn = cuda_fn, plain_fn
        self.source, self.replaces = source, replaces
        self.calls = []

    def launch(self, args):
        return getattr(self.module, self.cuda_fn)(*args)

    def plain(self, args):
        return getattr(self.module, self.plain_fn)(*args)


@contextlib.contextmanager
def patched(kernels, make):
    """Temporarily replace each kernel's CUDA entry point by make(k, orig)."""
    saved = [(k, getattr(k.module, k.cuda_fn)) for k in kernels]
    for k, orig in saved:
        setattr(k.module, k.cuda_fn, make(k, orig))
    try:
        yield
    finally:
        for k, orig in saved:
            setattr(k.module, k.cuda_fn, orig)


def capturing(k, orig):
    def fn(*args):
        k.calls.append(clone_args(args))
        return orig(*args)
    return fn


def plain_route(k, _orig):
    return lambda *args: k.plain(args)


# ----------------------------------------------------------------- bounds

def bound_rotated_iou(args):
    n, m = args[0].shape[0], args[1].shape[0]
    nbytes = (n + m) * 32 + n * m * 4
    return nbytes / HBM_BYTES_S, n * m * CLIP_OPS_PER_PAIR / F32_OPS_S


def bound_fps(args):
    pts, valid, k = args
    b, n, _ = pts.shape
    nbytes = b * n * 13 + b * k * 4
    # each pick: 3 sub, 3 mul, 2 add, min, compare per valid point
    ops = 10 * (k - 1) * int(valid.sum())
    return nbytes / HBM_BYTES_S, ops / F32_OPS_S


def bound_three_nn(args):
    src, valid, q = args
    b, n, _ = src.shape
    m = q.shape[1]
    nbytes = b * n * 13 + b * m * 12 + b * m * 3 * 8
    ops = 10 * m * int(valid.sum())            # every valid source per query
    return nbytes / HBM_BYTES_S, ops / F32_OPS_S


def sa_slots(args):
    """Distinct MLP slots per (radius): max(1, min(in-ball count, nsample))."""
    centers, xyz, valid, _, _, _, _, _, radii, nsamples = args
    d2 = ((centers[:, :, None, :] - xyz[:, None, :, :]) ** 2).sum(-1)
    out = []
    for r, ns in zip(radii, nsamples):
        cnt = ((d2 < r * r) & valid[:, None, :]).sum(-1)
        out.append(int(cnt.clamp(min=1, max=ns).sum()))
    return out


def bound_sa_group(args):
    centers, xyz, valid, z, cw, w2, b1, b2, _, _ = args
    r, g, _ = centers.shape
    nbytes = sum(t.numel() * t.element_size()
                 for t in (centers, xyz, valid, z, cw, w2, b1, b2))
    nbytes += r * g * 128 * 2                   # bf16 output
    slots = sum(sa_slots(args))
    h = z.shape[-1]
    f32_ops = 8 * g * int(valid.sum()) + 2 * h * slots   # distances, layer 1
    bf16_ops = 2 * h * h * slots                         # layer 2
    return nbytes / HBM_BYTES_S, f32_ops / F32_OPS_S + bf16_ops / BF16_OPS_S


# ------------------------------------------------------------ comparisons

def compare(k, calls=None):
    """Kernel against plain version over every captured call (or the given
    (label, args) cases); returns the max abs error (indices must be
    identical) and the largest |plain| float output, which shows the
    comparison is not between zeros."""
    err = ref_max = 0.0
    if calls is None:
        calls = [(f'main-path call {i}', a) for i, a in enumerate(k.calls)]
    for label, args in calls:
        got, ref = k.launch(args), k.plain(args)
        sync()
        ref_f = ref[0] if k.name == 'three_nn' else ref
        if ref_f.is_floating_point() and ref_f.numel():
            ref_max = max(ref_max, float(ref_f.float().abs().max()))
        if k.name == 'fps':
            if not torch.equal(got, ref):
                fail(f'fps kernel indices differ from the plain version ({label})')
        elif k.name == 'three_nn':
            if not torch.equal(got[1], ref[1]):
                fail(f'three_nn kernel indices differ from the plain version ({label})')
            if not torch.allclose(got[0], ref[0], rtol=B3_DIST_TOL, atol=B3_DIST_TOL):
                fail(f'three_nn kernel distances differ from the plain version ({label})')
            err = max(err, float((got[0] - ref[0]).abs().max()))
        elif k.name == 'rotated_iou':
            e = float((got - ref).abs().max()) if got.numel() else 0.0
            if e > B1_ATOL:
                fail(f'rotated_iou areas differ by {e} > {B1_ATOL} ({label})')
            err = max(err, e)
        else:
            g32, r32 = got.float(), ref.float()
            e = float(((g32 - r32).abs() / r32.abs().clamp(min=B4_FLOOR)).max())
            if not e <= B4_REL:      # a NaN fails too
                fail(f'sa_group differs by {e} of max(|ref|, {B4_FLOOR}) > {B4_REL} '
                     f'({label})')
            err = max(err, float((g32 - r32).abs().max()))
    return err, ref_max


def library_three_nn(args):
    """torch.cdist + topk over the same inputs (a yardstick only)."""
    src, valid, q = args
    d = torch.cdist(q, src) ** 2 + torch.where(valid, 0.0, 1e10)[:, None, :]
    return torch.topk(d, 3, dim=-1, largest=False)


# ------------------------------------------------------------ corner cases

def fps_corner_cases():
    """(label, (points, valid, picks)) on the card: what a cluster-wide
    argmax over ordered keys puts at risk."""
    rng = np.random.RandomState(SEED)

    def case(label, pts, valid, k):
        return label, (torch.from_numpy(pts.astype(np.float32)).cuda(),
                       torch.from_numpy(valid).cuda(), k)

    cases = []
    pts = rng.rand(3, 300, 3) * 50
    valid = np.ones((3, 300), bool)
    valid[0] = False                                  # no valid point
    valid[1, 7:] = False                              # 7 valid < 64 picks
    valid[1, :3] = False
    valid[2, ::3] = False
    cases.append(case('no valid row / fewer valid than picks', pts, valid, 64))
    dup = np.repeat(rng.rand(1, 40, 3) * 10, 5, axis=1)     # each point 5 times
    cases.append(case('duplicated points', dup[:, rng.permutation(200)],
                      np.ones((1, 200), bool), 100))
    cases.append(case('all points equal', np.full((2, 100, 3), 1.5),
                      np.ones((2, 100), bool), 16))
    for n, k in ((1, 4), (255, 64), (2251, 256), (18432, 64)):
        valid = rng.rand(2, n) < 0.8
        valid[0] = True
        cases.append(case(f'N = {n}', rng.randn(2, n, 3) * 20, valid, k))
    return cases


def sa_corner_cases():
    """(label, args of sa_group_pool_*) on the card: ball counts at and around
    nsample, empty balls, ragged P and G, one RoI, many points per RoI."""
    rng = np.random.RandomState(SEED + 1)
    h, radii, nsamples = 64, (0.8, 1.6), (16, 32)

    def case(label, centers, xyz, valid, ns=nsamples):
        r, g, p = centers.shape[0], centers.shape[1], xyz.shape[1]
        f = lambda a, dt=torch.float32: torch.from_numpy(
            np.asarray(a, np.float32)).cuda().to(dt)
        return label, (
            f(centers), f(xyz), torch.from_numpy(valid).cuda(),
            f(rng.randn(2, r, p, h), torch.bfloat16), f(rng.randn(2, r, g, h)),
            f(rng.randn(2, h, h) / 8, torch.bfloat16), f(rng.randn(2, h) * 0.5),
            # b2 > 0: a slot wrongly filled with zeros would pool relu(b2)
            f(0.5 + rng.rand(2, h)), radii, ns)

    def unit(n):
        v = rng.randn(n, 3)
        return v / np.linalg.norm(v, axis=1, keepdims=True)

    # RoI i: `a` points 0.4 m from the origin (in both balls), `b` points
    # 1.2 m away (in the larger ball only), the rest 100 m away; center 0 is
    # the origin, centers 1-2 a millimetre off it, centers 3-4 see nothing.
    counts = ((16, 16), (17, 0), (0, 0), (0, 5), (1, 0), (16, 17), (3, 14),
              (15, 2), (0, 32))
    p = 80
    xyz = np.full((len(counts), p, 3), 100.0)
    for i, (a, b) in enumerate(counts):
        pts = np.concatenate([unit(a) * 0.4, unit(b) * 1.2])
        slots = np.sort(rng.permutation(p)[:a + b])
        xyz[i, slots] = pts[rng.permutation(a + b)]
    centers = np.zeros((len(counts), 5, 3))
    centers[:, 1:3] = rng.randn(len(counts), 2, 3) * 1e-3
    centers[:, 3:] = -50.0
    cases = [case('ball counts 0/1/16/17/32/33', centers, xyz,
                  np.ones((len(counts), p), bool))]
    for r, g, p in ((1, 37, 1), (2, 37, 33), (3, 50, 512), (1, 1, 64), (2, 9, 8192)):
        cases.append(case(
            f'R = {r}, G = {g}, P = {p}, valid sparse', rng.randn(r, g, 3) * 0.7,
            rng.randn(r, p, 3), rng.rand(r, p) < (0.3 if p < 8192 else 0.02)))
    cases.append(case('nsamples (32, 32)', rng.randn(2, 20, 3) * 0.5,
                      rng.randn(2, 300, 3), rng.rand(2, 300) < 0.9, ns=(32, 32)))
    return cases


def corner_phase(by_name):
    """Kernel against plain on the corner cases; fails the run on a mismatch."""
    for name, cases in (('fps', fps_corner_cases()), ('sa_group', sa_corner_cases())):
        err, ref_max = compare(by_name[name], cases)
        log(f'# {name}: {len(cases)} corner cases agree with the plain version '
            f'(max abs error {err}, largest |plain output| {ref_max})')


# --------------------------------------------------------------- the run

def nvidia_smi():
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def build_inputs():
    from fv2p_torch.config import EasyDict, cfg_from_yaml_file
    from fv2p_torch.datasets import dataset_meta_from_cfg
    from fv2p_torch.utils.synthetic import synthetic_batch_np
    cfg = EasyDict()
    cfg_from_yaml_file(str(CFG), cfg)
    meta = dataset_meta_from_cfg(cfg.DATA_CONFIG, 'train')
    t0 = time.perf_counter()
    batch_np = synthetic_batch_np(meta, BATCH, N_CAP, N_FILL,
                                  n_points=N_POINTS, seed=SEED)
    host_s = time.perf_counter() - t0
    return cfg, meta, batch_np, host_s


def make_model(cfg, meta, dtype):
    from fv2p_torch.models import build_network
    from fv2p_torch.weights import init_random_
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), cfg.CLASS_NAMES,
                          meta, compute_dtype=dtype)
    return init_random_(model, seed=SEED)


def forward(model, batch):
    """One inference pass over the batch already on the card (the model
    adds its outputs to a fresh copy of the batch dict)."""
    return model(dict(batch))


def check_outputs(out, post):
    for key, shape in (('pred_boxes', (BATCH, post, 7)), ('pred_scores', (BATCH, post)),
                       ('pred_labels', (BATCH, post)), ('pred_valid', (BATCH, post))):
        if tuple(out[key].shape) != shape:
            fail(f'{key} has shape {tuple(out[key].shape)}, expected {shape}')
    for key in ('pred_boxes', 'pred_scores', 'batch_box_preds',
                'batch_iouscore_preds', 'point_features'):
        if not torch.isfinite(out[key].float()).all():
            fail(f'{key} is not finite')
    n_valid = int(out['pred_valid'].sum())
    if n_valid == 0:
        fail('no detection survived post-processing')
    return n_valid


def timed_forwards(model, batch, n):
    """Host-clock ms of n forwards, each ended by a synchronise."""
    ms = []
    for _ in range(n):
        sync()
        t0 = time.perf_counter()
        forward(model, batch)
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms


def profiled_forward(model, batch):
    """One forward under torch.profiler: the device's busy share of the
    wall time (kernel and copy time on the card over host time) and the
    kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        forward(model, batch)
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name[:90]] = by_name.get(e.name[:90], 0.0) + e.device_time / 1e3
    busy_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    return {'wall_ms': wall_ms, 'device_busy_ms': busy_ms,
            'busy_share': busy_ms / wall_ms, 'top_device_ms': dict(top)}


def host_syncs(model, batch):
    """Calls in one forward that make the host wait for the card (CUDA
    sync debug mode), counted by the source line that made them."""
    import warnings
    sites = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        try:
            forward(model, batch)
            sync()
        finally:
            torch.cuda.set_sync_debug_mode('default')
    for w in caught:
        if 'synchroniz' not in str(w.message):
            continue
        path = Path(w.filename)
        where = path.relative_to(REPO) if path.is_relative_to(REPO) else path.name
        site = f'{where}:{w.lineno}'
        sites[site] = sites.get(site, 0) + 1
    return sum(sites.values()), dict(sorted(sites.items(), key=lambda kv: -kv[1]))


def module_times(model, batch):
    """ms per top-level module of one forward (CUDA events), plus the
    post-processing that follows them."""
    from fv2p_torch.models.detectors.detector3d_template import MODULE_TOPOLOGY
    events = {}
    handles = []
    for slot in MODULE_TOPOLOGY:
        if not hasattr(model, slot):
            continue
        mod = getattr(model, slot)
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        events[slot] = ev
        handles.append(mod.register_forward_pre_hook(lambda m, a, e=ev: e[0].record()))
        handles.append(mod.register_forward_hook(lambda m, a, o, e=ev: e[1].record()))
    end = torch.cuda.Event(enable_timing=True)
    sync()
    out = forward(model, batch)
    end.record()
    sync()
    for h in handles:
        h.remove()
    times = {slot: e[0].elapsed_time(e[1]) for slot, e in events.items()}
    times['post_processing'] = events['roi_head'][1].elapsed_time(end)
    return times, out


def main():
    if not torch.cuda.is_available():
        log('chip_smoke.py needs a CUDA card; none is available')
        return 2
    if not (REPO / 'fv2p_torch').is_dir() or not CFG.exists():
        log('chip_smoke.py must run from a checkout of the repository')
        return 2
    sys.path.insert(0, str(REPO))
    from fv2p_torch.models.roi_heads.iouguided_roi_head import proposal_layer
    from fv2p_torch.ops import cuda as kcuda
    from fv2p_torch.ops.cuda import fps, rotated_iou, sa_group, three_nn

    record = {'device': torch.cuda.get_device_name(0),
              'torch': torch.__version__, 'cuda': torch.version.cuda}
    smi = nvidia_smi()
    log(f'# card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}')

    # 1. build the kernels (one nvcc per source, in parallel)
    t0 = time.perf_counter()
    built = kcuda.build()
    record['build_s'] = time.perf_counter() - t0
    record['ptxas'] = {n: log_ for n, (_, log_) in built.items()}
    log(f'# built {sorted(built)} in {record["build_s"]:.1f} s')

    kernels = [
        Kernel('rotated_iou', rotated_iou, 'overlap_matrix_cuda',
               'overlap_matrix_plain', 'fv2p_torch/ops/csrc/rotated_iou.cu',
               'fv2p_tpu/ops/pallas/rotated_iou.py:125'),
        Kernel('fps', fps, 'fps_cuda', 'fps_plain', 'fv2p_torch/ops/csrc/fps.cu',
               'fv2p_tpu/ops/pallas/fps.py:89'),
        Kernel('three_nn', three_nn, 'three_nn_cuda', 'three_nn_plain',
               'fv2p_torch/ops/csrc/three_nn.cu',
               'fv2p_tpu/ops/pallas/three_nn.py:124'),
        Kernel('sa_group', sa_group, 'sa_group_pool_cuda', 'sa_group_pool_plain',
               'fv2p_torch/ops/csrc/sa_group.cu',
               'fv2p_tpu/ops/pallas/sa_group.py:153'),
    ]
    bounds = {'rotated_iou': bound_rotated_iou, 'fps': bound_fps,
              'three_nn': bound_three_nn, 'sa_group': bound_sa_group}
    by_name = {k.name: k for k in kernels}

    # 2-3. the model and the bench batch (built on the host, copied once)
    from fv2p_torch.utils.synthetic import batch_to_torch
    cfg, meta, batch_np, host_s = build_inputs()
    t0 = time.perf_counter()
    batch = batch_to_torch(batch_np, 'cuda')
    sync()
    record.update(batch_host_s=host_s,
                  batch_to_device_ms=(time.perf_counter() - t0) * 1e3)
    model = make_model(cfg, meta, torch.bfloat16)
    post = int(cfg.MODEL.POST_PROCESSING.NMS_CONFIG.NMS_POST_MAXSIZE)
    log(f'# bench batch built on the host in {host_s:.1f} s; '
        f'{sum(p.numel() for p in model.parameters())} parameters')

    # 4. the main path, counted: every count is 0 just before, read just after
    head_io = {}
    hook = model.dense_head.register_forward_hook(lambda m, a, o: head_io.update(
        box=o['batch_box_preds'].clone(), cls=o['batch_cls_preds'].clone()))
    kcuda.reset_launch_counts()
    with patched(kernels, capturing):
        out = forward(model, batch)
    sync()
    launches = dict(kcuda.launch_counts)
    hook.remove()
    log(f'# main path launches: {launches}')
    for k in kernels:
        if launches[k.name] == 0:
            fail(f'kernel {k.name} was not launched on the main path')
        if launches[k.name] != len(k.calls):
            fail(f'{k.name}: {launches[k.name]} launches, {len(k.calls)} calls')
    n_valid = check_outputs(out, post)
    log(f'# bf16 forward: {n_valid} valid detections over {BATCH} scans')

    # 5. each kernel against its plain version on the main path's inputs
    compared = {k.name: compare(k) for k in kernels}
    errs = {name: c[0] for name, c in compared.items()}
    record['kernel_ref_max_abs'] = {name: c[1] for name, c in compared.items()}
    log(f'# kernel vs plain max abs error: {errs}; largest |plain output|: '
        f'{record["kernel_ref_max_abs"]}')
    # NMS keep lists: proposal NMS and final NMS, kernel vs plain overlaps
    nms_cfg = cfg.MODEL.ROI_HEAD.NMS_CONFIG.TEST
    final_in = {k: out[k] for k in ('batch_box_preds', 'batch_cls_preds',
                                    'batch_iouscore_preds', 'roi_labels',
                                    'has_class_labels', 'cls_preds_normalized')}
    ker = (proposal_layer(head_io['box'], head_io['cls'], nms_cfg),
           model.post_processing_withfgscores(dict(final_in)))
    with patched(kernels, plain_route):
        pln = (proposal_layer(head_io['box'], head_io['cls'], nms_cfg),
               model.post_processing_withfgscores(dict(final_in)))
    if not (torch.equal(ker[0][0], pln[0][0]) and torch.equal(ker[0][3], pln[0][3])):
        fail('proposal NMS keeps differ between kernel and plain overlaps')
    for key in ('pred_boxes', 'pred_valid', 'pred_labels'):
        if not torch.equal(ker[1][key], pln[1][key]):
            fail(f'final NMS {key} differs between kernel and plain overlaps')
    log('# NMS keep lists identical (proposal and final)')

    # 6. the whole forward in f32 without TF32: kernels against plain versions
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision('highest')
    model32 = make_model(cfg, meta, None)
    out_k = forward(model32, batch)
    with patched(kernels, plain_route):
        out_p = forward(model32, batch)
    sync()
    check_outputs(out_k, post)
    f32 = {}
    for key in ('pred_valid', 'pred_labels'):
        if not torch.equal(out_k[key], out_p[key]):
            fail(f'f32 forward: {key} differs between kernels and plain versions')
    for key in ('pred_boxes', 'pred_scores', 'point_features', 'batch_iouscore_preds'):
        f32[key] = float((out_k[key] - out_p[key]).abs().max())
        if f32[key] > F32_ATOL:
            fail(f'f32 forward: {key} differs by {f32[key]} > {F32_ATOL}')
    record['f32_kernel_vs_plain_max_abs'] = f32
    log(f'# f32 forward, kernels vs plain versions: {f32}')
    del model32, out_k, out_p
    torch.cuda.empty_cache()

    # 7. FPS and SA group on the corner cases their designs put at risk
    corner_phase(by_name)

    # 8. times: each kernel's calls of one forward, then the whole forward
    rows = []
    for k in kernels:
        ms = time_events(lambda: [k.launch(a) for a in k.calls],
                         reps=3 if k.name == 'fps' else 10)
        plain_ms = time_events(lambda: [k.plain(a) for a in k.calls], reps=1,
                               warmup=0 if k.name == 'fps' else 1)
        lib_ms = None
        if k.name == 'three_nn':
            lib_ms = time_events(lambda: [library_three_nn(a) for a in k.calls],
                                 reps=3)
        b_bytes, b_ops = (sum(x) for x in zip(*(bounds[k.name](a) for a in k.calls)))
        rows.append({'name': k.name, 'route': 'cuda', 'source': k.source,
                     'replaces': k.replaces, 'launches': launches[k.name],
                     'max_abs_err': errs[k.name], 'ms': ms, 'plain_ms': plain_ms,
                     'bound_ms': max(b_bytes, b_ops) * 1e3,
                     'bound_by': 'bytes' if b_bytes >= b_ops else 'operations',
                     'library_ms': lib_ms})
        log(f'# {k.name}: {ms:.3f} ms kernel, {plain_ms:.3f} ms plain, '
            f'bound {rows[-1]["bound_ms"]:.4f} ms ({rows[-1]["bound_by"]})'
            + (f', library {lib_ms:.3f} ms' if lib_ms is not None else ''))
        if k.name == 'fps':
            # the K-1 cluster exchanges alone: what the chain of picks costs
            # with no distance work, beside the rate bound above
            rows[-1]['chain_floor_ms'] = time_events(
                lambda: [fps.fps_chain_floor_cuda(*a) for a in k.calls], reps=3)
            log(f'# fps chain floor (exchanges only): '
                f'{rows[-1]["chain_floor_ms"]:.3f} ms')
        k.calls.clear()

    timed_forwards(model, batch, 2)                      # warm-up
    fwd = np.array(timed_forwards(model, batch, FORWARD_REPS))
    q1, med, q3 = (float(x) for x in np.percentile(fwd, [25, 50, 75]))
    per_module, _ = module_times(model, batch)
    prof = profiled_forward(model, batch)
    n_syncs, sync_sites = host_syncs(model, batch)
    torch.cuda.reset_peak_memory_stats()
    forward(model, batch)
    sync()
    record.update(forward_ms={'median': med, 'q1': q1, 'q3': q3,
                              'min': float(fwd.min()), 'max': float(fwd.max()),
                              'n': FORWARD_REPS, 'all': fwd.tolist()},
                  ms_per_scan=med / BATCH, per_module_ms=per_module,
                  profile=prof, launches=launches, host_syncs=n_syncs,
                  host_sync_sites=sync_sites,
                  peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                  kernels=rows, nvidia_smi=smi, valid_detections=n_valid)
    log(f'# bf16 forward at batch {BATCH}: median {med:.2f} ms '
        f'(quartiles {q1:.2f}-{q3:.2f}, n={FORWARD_REPS}; {med / BATCH:.2f} '
        f'ms/scan); device busy {prof["busy_share"]:.1%} of a profiled pass')
    log(f'# per module (ms): {per_module}')
    log(f'# host waits in one forward: {n_syncs}; by line: {sync_sites}')

    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / 'chip_smoke.json').write_text(json.dumps(record, indent=1))
    log(json.dumps({'kernels': rows}))
    log(smi)
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
