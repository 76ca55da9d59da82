"""What the per-layer metrics of the program's own spans and counters read:
the registry of ``fv2p_torch/utils/tracing.py``, found among the modules the
run has loaded (this file imports nothing of the program: ``program.py``
stays the benchmark's only importer of the port). A program without that
registry, or a record of no profiled stretch, gives None.

A span's time is its CUDA-event time: the card's wall clock from the span's
first launch to its end, idle stretches inside it included. It is summed
over the steps traced under the profiler (both profiled stretches after the
window) and divided by their number. Where the host issues a span's
launches slower than the card runs them, that time is the host's pace,
lengthened by the profiler's host slowdown (``profiler_slowdown_pct.*``).
A count is the counter's total since the process started, over the
forwards (steps) the registry counted."""
import sys


def _snapshot(rec):
    tracing = sys.modules.get('fv2p_torch.utils.tracing')
    if not rec.get('profiled_batches') or tracing is None:
        return None
    return tracing.snapshot()


def span_ms(rec, names):
    """The named spans' device ms a traced step, summed; None where one of
    them recorded no CUDA events."""
    snap = _snapshot(rec)
    if snap is None or not snap['traced_steps']:
        return None
    found = [snap['spans'].get(name) for name in names]
    if any(s is None or s['device_ms'] is None for s in found):
        return None
    return sum(s['device_ms'] for s in found) / snap['traced_steps']


def count_per_step(rec, prefix):
    """The counters whose names start with ``prefix``, summed, a step."""
    snap = _snapshot(rec)
    if snap is None or not snap['steps']:
        return None
    return sum(n for name, n in snap['counters'].items() if name.startswith(prefix)) \
        / snap['steps']
