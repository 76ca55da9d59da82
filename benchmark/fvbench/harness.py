"""One run of one cell: set-up, the measured window, the traced stretch
(``--trace 1``), then the reference and the comparison that decides
``correct``.

Inference (``mode: infer``): a closed loop with one batch in flight. A
batch is ``model(batch)`` of the detector in eval mode followed by the
copy of its detections to the host; its latency runs from its submission
to that copy. Training (``mode: train``): a closed loop of the train step
(forward, targets, loss, backward, clip, optimizer); set-up drives the same
step object through its first steps, which the reference follows.

The inputs are a pool of distinct batches drawn from the seed and cycled;
the weights are drawn on the card from the seed. Both sides get the same
raw batches and the same state; each builds its own voxel tables."""
import gc
import time

import numpy as np
import torch

from . import compare, measure, program, reference, scans
from .cell import dataset_meta
from .weights import calibrate_batchnorm_, init_seeded_

PRED_KEYS = reference.PRED_KEYS
CHECK_STREAM = 1 << 20         # the draw of the pool batches that are checked


def batch_rng(seed, stream):
    """The numpy generator of one stream of a run (a pool batch's index, or
    ``CHECK_STREAM``): any integer seed."""
    words = np.random.SeedSequence([int(seed) % (1 << 64), int(stream)]).generate_state(1)
    return np.random.RandomState(int(words[0]))


def draw_pool(cell, seed, meta):
    t = cell.traffic
    return [scans.draw_batch(batch_rng(seed, i), meta, cell.batch_size, t['voxel_cap'],
                             t['fill'], t['raw_points'], t['pad_points_to'],
                             t['sample_points'], t['max_objs'])
            for i in range(t['pool'])]


def prepared(side, cell, batch_np, meta, device):
    """A drawn batch with ``side``'s own voxel tables (``program`` or
    ``reference``), on ``device``."""
    return side.to_device(side.with_tables(batch_np, cell.cfg, meta['grid_size'],
                                           cell.level_caps), device)


def make_state(cell, seed, meta, pool_np, device):
    """The weights (and, where the configuration says so for this mode, the
    BatchNorm statistics of the reference's f32 pass over the first batch),
    as a state dict on ``device``, drawn on a model the reference builds.
    Returns (state, seconds of the reference's own work: its build and its
    calibration pass, which ``setup_s`` leaves out)."""
    t0 = time.perf_counter()
    ref = reference.build_model(cell.cfg, meta, device)
    sync(device)
    reference_s = time.perf_counter() - t0
    init_seeded_(ref, seed, cell.config['weights'].get('dcn_offsets', 'drawn'))
    if cell.config['weights']['batchnorm'].get(cell.mode) == 'calibrate_on_first_batch':
        t0 = time.perf_counter()
        calibrate_batchnorm_(ref, prepared(reference, cell, pool_np[0], meta, device))
        sync(device)
        reference_s += time.perf_counter() - t0
    state = {k: v.detach().clone() for k, v in ref.state_dict().items()}
    del ref
    return state, reference_s


def compute_dtype(cell):
    return getattr(torch, cell.config['compute_dtype'])


def sync(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)


def host_detections(out):
    return {k: out[k].cpu() for k in PRED_KEYS}


def infer_window(model, batches, seconds, keep):
    """The closed loop: batches in turn until ``seconds`` have passed and
    the pool has been run once. Returns (batch latencies in s, window in s,
    detections of the batches whose pool index is in ``keep``: {index:
    [detections, ...]})."""
    lat, kept = [], {i: [] for i in keep}
    start = time.perf_counter()
    i = 0
    while True:
        t0 = time.perf_counter()
        if t0 - start >= seconds and i >= len(batches):
            break
        k = i % len(batches)
        det = host_detections(model(dict(batches[k])))
        lat.append(time.perf_counter() - t0)
        if k in kept:
            kept[k].append(det)
        i += 1
    return lat, time.perf_counter() - start, kept


def train_window(step, batches, first, seconds, device):
    """The closed loop of train steps, pool batches in turn from ``first``,
    until ``seconds`` have passed on the host clock; the window ends when
    the card has finished the last step. Returns (steps, window in s)."""
    n = 0
    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
        step.step(batches[(first + n) % len(batches)])
        n += 1
    sync(device)
    return n, time.perf_counter() - start


def checked_steps(step, batches, n):
    """Set-up's first ``n`` steps, through the window's own call: the loss
    terms of each, the first gradient (from the optimizer's state) and the
    parameters after the last, for the comparison."""
    params = list(step.module.parameters())
    start = [p.detach().clone() for p in params]
    losses, grads = [], None
    for i in range(n):
        terms = step.step(batches[i])
        losses.append({k: float(v) for k, v in terms.items()})
        if i == 0:
            grads = [g.clone() for g in reference.first_gradient(step.optimizer)]
    change = [p.detach() - s for p, s in zip(params, start)]
    return losses, grads, change


def run(cell, seed, seconds, trace, t_start, device='cuda'):
    """One run. Returns the result's fields (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, ``breakdown`` with ``trace``) and the
    comparison's (``checks``: each number compared with its limit;
    ``readings``: every reading)."""
    tr = cell.traffic
    meta = dataset_meta(cell.cfg, tr['voxel_cap'])
    pool_np = draw_pool(cell, seed, meta)
    state, reference_s = make_state(cell, seed, meta, pool_np, device)
    batches = [prepared(program, cell, b, meta, device) for b in pool_np]
    if torch.device(device).type == 'cuda':
        program.build_kernels()
    model = program.build_model(cell.config['cfg'], meta, compute_dtype(cell), state, device)
    rng = batch_rng(seed, CHECK_STREAM)
    fields = {'failed': 0}
    if cell.mode == 'infer':
        keep = sorted(rng.choice(tr['pool'], tr['checked_batches'], replace=False).tolist())
        for b in batches + batches[:1]:                          # warm-up
            host_detections(model(dict(b)))
        sync(device)
        setup_s = time.perf_counter() - t_start - reference_s
        if device != 'cpu':
            torch.cuda.reset_peak_memory_stats(device)
        lat, window_s, kept = infer_window(model, batches, seconds, keep)
        n = len(lat)
        fields['metrics'] = {
            'infer_scans_per_s': n * cell.batch_size / window_s,
            'infer_batch_p95_ms': float(np.percentile(np.array(lat) * 1e3, 95)),
            'setup_s': setup_s}
        fields['attempted'] = n
        run_record = {'batches': n, 'window_s': window_s, 'batch_size': cell.batch_size}
        subject = model
    else:
        subject = program.train_step(model, cell.config['cfg'], tr['total_steps'])
        prog_checked = checked_steps(subject, batches, tr['checked_steps'])
        sync(device)
        setup_s = time.perf_counter() - t_start - reference_s
        if device != 'cpu':
            torch.cuda.reset_peak_memory_stats(device)
        n, window_s = train_window(subject, batches, tr['checked_steps'], seconds, device)
        fields['metrics'] = {'train_scans_per_s': n * cell.batch_size / window_s,
                             'setup_s': setup_s}
        fields['attempted'] = n
        run_record = {'batches': n, 'window_s': window_s, 'batch_size': cell.batch_size}
    fields['device'] = measure.device_info(device)
    if device != 'cpu':
        fields['device']['memory_peak_bytes'] = int(torch.cuda.max_memory_allocated(device))
    if trace:
        traced = measure.traced(cell, subject, batches)
        run_record.update(traced)
        fields['device'].update(busy_s=traced['busy_s'], window_s=traced['profiled_s'])
        fields['breakdown'] = traced['breakdown']
    names = [k for k, _ in model.named_parameters()]
    del model, subject, batches              # the program's state, freed for the reference
    gc.collect()
    if device != 'cpu':
        torch.cuda.empty_cache()

    ref_model = reference.build_model(cell.cfg, meta, device, compute_dtype(cell))
    ref_model.load_state_dict(state)
    if cell.mode == 'infer':
        ref_det, ops = {}, []
        for k in keep:
            rb = prepared(reference, cell, pool_np[k], meta, device)
            with measure.OpCounter(ref_model) as counter:
                ref_det[k] = reference.detections(ref_model, rb)
            ops.append(counter.ops)
        checks = compare.detections(kept, ref_det)
    else:
        rbs = [prepared(reference, cell, b, meta, device)
               for b in pool_np[:tr['checked_steps']]]
        with measure.OpCounter(ref_model) as counter:
            ref_checked = reference.train_steps(ref_model, cell.cfg.OPTIMIZATION,
                                                tr['total_steps'], rbs)
        ops = [3 * counter.ops / len(rbs)]
        checks = compare.train(prog_checked, ref_checked, names,
                               cell.limits['steady_terms'])
    run_record['model_ops'] = float(np.mean(ops))
    fields['checks'] = compare.judge(checks, cell.limits)
    fields['readings'] = checks
    fields['correct'] = all(c['ok'] for c in fields['checks'].values())
    if trace:
        fields['metrics'] = measure.per_layer(cell, run_record)
    return fields
