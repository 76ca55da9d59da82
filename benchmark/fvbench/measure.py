"""What the traced run (``--trace 1``) measures after the window, and the
device's description. Every span here is recorded from the benchmark's own
files, around the calls into the program's layers:

* CUDA events before and after each slot of the detector (forward hooks),
  and around a train step's forward + loss, backward and optimizer;
* ``record_function`` ranges with the same names, so that the profiler's
  trace says which slot the host was in during each idle gap of the card;
* wrappers around the hand kernels' CUDA entry points and the deformable
  conv's, which capture each call's inputs for the bounds;
* the count of calls that make the host wait (CUDA sync debug mode).

``OpCounter`` counts the model operations the inputs need, on the
reference's forward: two a multiply-add of each dense layer, convolution,
transposed convolution and deformable product, and of each sparse conv's
active (output row, tap) pairs, not its capacity rows."""
import contextlib
import itertools
import math
import time
import warnings

import torch

from . import bounds, program
from .cell import kernel_of
from refnet.models.layers import Conv2d, Conv3d, ConvTranspose2d, Dense
from refnet.ops.dcn import MdeformConvBlock
from refnet.ops.sparse.conv import _SparseConvBase

SPAN_PASSES = 2          # passes over the pool for the span and profile stretches
RANGES = ('slot:', 'phase:')   # the names of the benchmark's record_function ranges
REPLAYS = 5


def device_info(device):
    if torch.device(device).type != 'cuda':
        return {'platform': 'cpu', 'kind': 'cpu', 'count': 1}
    return {'platform': 'gpu', 'kind': torch.cuda.get_device_name(device), 'count': 1}


def sync():
    torch.cuda.synchronize()


class OpCounter:
    """Model operations of the forwards run inside it (``ops``)."""

    def __init__(self, model):
        self.model, self.ops, self.handles = model, 0, []

    def _hook(self, module, args, out):
        if isinstance(module, _SparseConvBase):
            feats = args[0].features
            nbr = next(a for a in args[1:] if torch.is_tensor(a))
            pairs = int(((nbr >= 0) & (nbr < feats.shape[0])).sum())
            self.ops += 2 * pairs * module.kernel.shape[1] * module.kernel.shape[2]
        elif isinstance(module, MdeformConvBlock):
            b, h, w, _ = out.shape
            k, cin, cout = module.kernel.shape
            self.ops += 2 * b * h * w * k * cin * cout
        elif isinstance(module, Dense):
            rows = args[0].numel() // module.in_features
            self.ops += 2 * rows * module.in_features * module.out_features
        elif isinstance(module, ConvTranspose2d):
            x = args[0]
            taps = math.prod(module.kernel_size)
            self.ops += 2 * x.numel() * module.out_channels * taps
        elif isinstance(module, (Conv2d, Conv3d)):
            per_out = module.in_channels // module.groups * math.prod(module.kernel_size)
            self.ops += 2 * out.numel() * per_out

    def __enter__(self):
        self.handles = [m.register_forward_hook(self._hook) for m in self.model.modules()
                        if isinstance(m, (_SparseConvBase, MdeformConvBlock, Dense,
                                          ConvTranspose2d, Conv2d, Conv3d))]
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()


@contextlib.contextmanager
def slot_spans(model, events=None):
    """``record_function`` ranges named by slot (and, with ``events``, a pair
    of CUDA events a slot and pass: {slot: [(start, end), ...]})."""
    handles = []
    for name, mod in program.slots(model):
        def pre(m, a, name=name):
            m._bench_range = torch.autograd.profiler.record_function(f'slot:{name}')
            m._bench_range.__enter__()
            if events is not None:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                events.setdefault(name, []).append([ev, None])

        def post(m, a, o, name=name):
            if events is not None:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                events[name][-1][1] = ev
            m._bench_range.__exit__(None, None, None)
        handles += [mod.register_forward_pre_hook(pre), mod.register_forward_hook(post)]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


@contextlib.contextmanager
def captured(entries):
    """Replace each (module, attribute) entry point by a wrapper that keeps
    (attribute, cloned arguments) of every call in the yielded list."""
    calls, saved = [], []
    for key, (module, names) in entries.items():
        for name in names:
            orig = getattr(module, name)

            def wrapper(*args, orig=orig, key=key, name=name):
                calls.append((key, name, tuple(a.detach().clone() if torch.is_tensor(a)
                                                else a for a in args)))
                return orig(*args)
            saved.append((module, name, orig))
            setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        for module, name, orig in saved:
            setattr(module, name, orig)


def _device_intervals(prof):
    """(start us, end us, name) of every operation on the card."""
    out = []
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and e.time_range.end > e.time_range.start
                and not e.name.startswith(RANGES)):       # the ranges' own annotations
            out.append((e.time_range.start, e.time_range.end, e.name))
    return sorted(out)


def _union(intervals):
    merged = []
    for s, e, _ in intervals:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _host_activity(prof, t):
    """What the host was in at time t: the innermost slot or phase range and
    the innermost operation around t."""
    best_range, best_op = None, None
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CPU:
            continue
        if not e.time_range.start <= t <= e.time_range.end:
            continue
        if e.name.startswith(RANGES):
            if best_range is None or e.time_range.start >= best_range.time_range.start:
                best_range = e
        elif best_op is None or e.time_range.start >= best_op.time_range.start:
            best_op = e
    where = best_range.name.split(':', 1)[1] if best_range else 'between batches'
    return f'{where} / {best_op.name}' if best_op else where


def profiled(run_once, n, kernels):
    """``run_once()`` n times under the profiler, twice. The first stretch
    traces the card alone (CUPTI's few microseconds a launch): its wall
    seconds, the card's busy seconds in it (the union of its operations),
    the device seconds a pass of each hand kernel and the operations that
    took the most time. The second traces the host too, whose recording
    slows the host: it only names what the host was in (the innermost slot
    or phase range and operation) during the card's longest idle gaps."""
    from torch.profiler import ProfilerActivity, profile
    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            run_once()
        sync()
        wall = time.perf_counter() - t0
    ivs = _device_intervals(prof)
    busy = sum(e - s for s, e in _union(ivs)) / 1e6
    by_name, kernel_s = {}, {}
    for s, e, name in ivs:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
        k = kernel_of(kernels, name)
        if k is not None:
            kernel_s[k] = kernel_s.get(k, 0.0) + (e - s) / 1e6 / n
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            run_once()
        sync()
    merged = _union(_device_intervals(prof))
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1])
                   for i in range(len(merged) - 1)), reverse=True)[:10]
    breakdown = {
        'device_ops': sorted(([k[:120], v] for k, v in by_name.items()),
                             key=lambda kv: -kv[1])[:10],
        'idle_gaps': [[_host_activity(prof, start + gap / 2)[:120], gap / 1e6]
                      for gap, start in gaps]}
    return wall, busy, kernel_s, breakdown


def event_ms(pairs):
    return sum(s.elapsed_time(e) for s, e in pairs)


def host_waits(fn):
    """Calls in one fn() that make the host wait for the card."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        try:
            fn()
            sync()
        finally:
            torch.cuda.set_sync_debug_mode('default')
    return sum('synchroniz' in str(w.message) for w in caught)


def kernel_bounds(run_pass, n_passes, kernels):
    """The hand kernels' least seconds a pass, from their captured calls."""
    with captured(program.entry_points(kernels)) as calls:
        for i in range(n_passes):
            run_pass(i)
        sync()
    out = {}
    for kernel, name, args in calls:
        least = max(kernels[kernel].bound((name, args))[:2])
        out[kernel] = out.get(kernel, 0.0) + least / n_passes
    return out


def time_events(fn, reps=REPLAYS):
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    sync()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / 1e3 / reps


def dcn_replay(run_pass, backward):
    """The deformable conv's calls of one pass, each replayed on its own
    inputs (forward, or forward + backward with an f32 output gradient).
    Returns (least seconds, replayed seconds) of all the calls, or None
    where the pass makes none."""
    module, name = program.dcn_entry()
    with captured({'dcn': (module, (name,))}) as calls:
        run_pass()
        sync()
    if not calls:
        return None
    orig = getattr(module, name)
    bound_s = time_s = 0.0
    for _, _, args in calls:
        fwd = bounds.bound_dcn(args)
        bound_s += max(fwd[:2])
        if not backward:
            time_s += time_events(lambda a=args: orig(*a))
            continue
        bound_s += max(bounds.bound_dcn_backward(args)[:2])
        leaves = [a.detach().clone().requires_grad_(True) if torch.is_tensor(a) else a
                  for a in args]

        def fwd_bwd(leaves=leaves):
            out = orig(*leaves)
            out.backward(torch.ones_like(out, dtype=torch.float32))
        time_s += time_events(fwd_bwd)
    return bound_s, time_s


def traced(cell, subject, batches):
    """The per-layer record of the traced stretch after the window."""
    n = SPAN_PASSES * len(batches)
    rec = {}
    if cell.mode == 'infer':
        model = subject

        def one(i):
            with torch.autograd.profiler.record_function('phase:batch'):
                return {k: v.cpu() for k, v in model(dict(batches[i % len(batches)])).items()
                        if k.startswith('pred_')}
        events, ends = {}, []
        sync()
        with slot_spans(model, events):
            for i in range(n):
                one(i)
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                ends.append(end)
            sync()
        rec['slot_ms'] = {s: event_ms(p) / n for s, p in events.items()}
        last = list(events.values())[-1]
        rec['post_processing_ms'] = sum(last[i][1].elapsed_time(ends[i])
                                        for i in range(n)) / n
        counter = itertools.count()
        with slot_spans(model):
            wall, busy, kernel_s, breakdown = profiled(lambda: one(next(counter)), n,
                                                       cell.kernels)
        rec['kernel_bound_s'] = kernel_bounds(one, len(batches), cell.kernels)
        rec['host_waits'] = host_waits(lambda: one(0))
        dcn = dcn_replay(lambda: one(0), backward=False)
    else:
        step = subject
        phases = {'forward_loss': [], 'backward': [], 'update': []}

        def one(i, timed=None):
            b = batches[i % len(batches)]
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)] if timed else None
            if ev:
                ev[0].record()
            with torch.autograd.profiler.record_function('phase:forward_loss'):
                loss, _, _ = step.forward_loss(b)
            if ev:
                ev[1].record()
            with torch.autograd.profiler.record_function('phase:backward'):
                step.backward(loss)
            if ev:
                ev[2].record()
            with torch.autograd.profiler.record_function('phase:update'):
                step.update()
            if ev:
                ev[3].record()
                for k, (a, z) in zip(phases, ((0, 1), (1, 2), (2, 3))):
                    phases[k].append((ev[a], ev[z]))
        sync()
        for i in range(n):
            one(i, timed=True)
        sync()
        rec['phase_ms'] = {k: event_ms(p) / n for k, p in phases.items()}
        counter = itertools.count()
        with slot_spans(step.module):
            wall, busy, kernel_s, breakdown = profiled(lambda: one(next(counter)), n,
                                                       cell.kernels)
        rec['kernel_bound_s'] = kernel_bounds(one, len(batches), cell.kernels)

        def forward_only():
            with torch.no_grad():
                step.forward_loss(batches[0])
        dcn = dcn_replay(forward_only, backward=True)
    rec.update(profiled_s=wall, busy_s=busy, kernel_device_s=kernel_s,
               breakdown=breakdown, profiled_batches=n)
    if dcn is not None:
        rec['dcn_bound_s'], rec['dcn_time_s'] = dcn
    return rec


def per_layer(cell, record):
    """Each per-layer metric of the cell that its reader finds, {name:
    {'value', 'unit'}}; a reader that finds nothing to read gives None and
    the metric is left out."""
    out = {}
    for m in cell.per_layer:
        value = cell.readers[m['name']].read(record)
        if value is not None:
            out[m['name']] = {'value': float(value), 'unit': m['unit']}
    return out
