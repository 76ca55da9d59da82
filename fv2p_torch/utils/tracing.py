"""Spans and counters inside the port: one registry for the process.

Spans. ``with tracing.span('slot:roi_head.proposal_nms'):`` times a part of
the program. While the gate is shut, ``span`` returns one shared no-op
object after one check and records nothing. The gate is open while a
``torch.profiler`` session records, or after ``enable()``. An open span
then

* opens ``torch.autograd.profiler.record_function(name)`` while a profiler
  records, so the part is named in the profiler's trace;
* records a pair of CUDA events on the current stream (none on a process
  that has not initialised CUDA);
* notes its parent, the innermost span open when it opened.

Every name starts with ``slot:`` (the forward) or ``phase:`` (the train
step and the backward), then a dotted path: the benchmark leaves ranges
with these prefixes out of the card's busy time.

The gate. ``enable()`` opens it without a profiler: a loop timed with the
program's spans then runs without the profiler's host slowdown, which
lengthens a span whose launches the host issues slower than the card runs
them (an NMS round, the DCN's taps). The profiler's trace holds each
range's host time; the registry keeps the card's.

Steps. ``open_step()`` runs at each call of ``Detector3DTemplate.forward``.
The registry counts every step, and apart the steps that open while the
gate is open (the traced steps): a span's time a step is its total over
the traced steps.

Aggregates. The registry keeps per span name the count, its device
milliseconds, its self time (its time less the part its children cover),
its parents and the counts filed under it: no list of events. A span's
events are resolved once its end has completed, checked with
``Event.query()`` when a step opens, never with a synchronise. While a profiler records, that check waits until the
profiler has stopped (or ``MAX_PENDING`` spans wait), so that the trace
shows the program and not the tracer's own calls. ``snapshot()``
synchronises once and returns a plain dict.

Counters. ``count(name, n)`` is always on, one dict increment; while a span
is open the count is also filed under the innermost one, so that the
snapshot gives counts by call site. ``host_reads.<site>`` counts the lines
that make the host wait for the card, ``launches.<kernel>`` the launches of
each hand kernel (``ops/cuda``'s ``launch_counts`` reads them).
"""
import torch
from torch.autograd import profiler as _profiler

PREFIXES = ('slot:', 'phase:')
MAX_PENDING = 16384      # closed spans whose events may wait for resolution


class _NoSpan:
    """The shared span of a shut gate."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ('registry', 'name', 'parent', 'range', 'start', 'end')

    def __init__(self, registry, name):
        self.registry, self.name = registry, name
        self.range = self.start = self.end = None

    def __enter__(self):
        reg = self.registry
        self.parent = reg.stack[-1].name if reg.stack else None
        reg.stack.append(self)
        if _profiler._is_profiler_enabled:
            self.range = _profiler.record_function(self.name)
            self.range.__enter__()
        if torch.cuda.is_initialized():
            self.start = reg.event()
            self.start.record()
        return self

    def __exit__(self, *exc):
        reg = self.registry
        if self.start is not None:
            self.end = reg.event()
            self.end.record()
        if self.range is not None:
            self.range.__exit__(*exc)
        reg.stack.pop()
        reg.closed(self)
        return False


def _aggregate():
    return {'count': 0, 'device_ms': None, 'self_device_ms': None, 'parents': {},
            'counts': {}}


def _timed(agg):
    if agg['device_ms'] is None:
        agg['device_ms'] = agg['self_device_ms'] = 0.0


class Registry:
    """Spans, steps and counters of one process (module functions below act
    on the process's one instance)."""

    def __init__(self):
        self.forced = False
        self.counters = {}
        self.steps = 0
        self.traced_steps = 0
        self.stack = []          # open spans, innermost last
        self.pending = []        # closed spans whose events are not resolved yet
        self.spans = {}          # name -> aggregate
        self.idle_events = []    # CUDA events free for reuse

    def enabled(self):
        return self.forced or _profiler._is_profiler_enabled

    def span(self, name):
        if not (self.forced or _profiler._is_profiler_enabled):
            return NO_SPAN
        return _Span(self, name)

    def event(self):
        if self.idle_events:
            return self.idle_events.pop()
        return torch.cuda.Event(enable_timing=True)

    def _agg(self, name):
        agg = self.spans.get(name)
        if agg is None:
            agg = self.spans[name] = _aggregate()
        return agg

    def closed(self, span):
        agg = self._agg(span.name)
        agg['count'] += 1
        if span.parent is not None:
            agg['parents'][span.parent] = agg['parents'].get(span.parent, 0) + 1
        if span.start is not None:
            _timed(agg)
            if span.parent is not None:      # its parent's events too
                _timed(self._agg(span.parent))
            self.pending.append(span)

    def resolve(self, wait=False):
        """Add the device time of every closed span whose end event has
        completed (all of them with ``wait``, after a synchronise) and
        return its events for reuse."""
        left = []
        for span in self.pending:
            if not (wait or span.end.query()):
                left.append(span)
                continue
            ms = span.start.elapsed_time(span.end)
            agg = self.spans[span.name]
            agg['device_ms'] += ms
            agg['self_device_ms'] += ms
            if span.parent is not None:
                self.spans[span.parent]['self_device_ms'] -= ms
            self.idle_events += (span.start, span.end)
            span.start = span.end = None
        self.pending = left

    def open_step(self):
        self.steps += 1
        if self.forced or _profiler._is_profiler_enabled:
            self.traced_steps += 1
        if self.pending and (not _profiler._is_profiler_enabled
                             or len(self.pending) >= MAX_PENDING):
            self.resolve()

    def count(self, name, n=1):
        self.counters[name] = self.counters.get(name, 0) + n
        if self.stack:
            counts = self._agg(self.stack[-1].name)['counts']
            counts[name] = counts.get(name, 0) + n

    def reset_counters(self, prefix=''):
        for name in [k for k in self.counters if k.startswith(prefix)]:
            del self.counters[name]

    def reset(self):
        """Forget every span, step and counter (the gate keeps its state)."""
        if self.pending and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        forced = self.forced
        self.__init__()
        self.forced = forced

    def snapshot(self):
        """{'steps', 'traced_steps', 'counters', 'spans': {name: {'count',
        'device_ms', 'self_device_ms', 'parents', 'counts'}}}; device times
        are None where no span of the name recorded CUDA events."""
        if self.pending:
            torch.cuda.synchronize()
            self.resolve(wait=True)
        spans = {name: {**agg, 'parents': dict(agg['parents']), 'counts': dict(agg['counts'])}
                 for name, agg in self.spans.items()}
        return {'steps': self.steps, 'traced_steps': self.traced_steps,
                'counters': dict(self.counters), 'spans': spans}


REGISTRY = Registry()


def enabled():
    return REGISTRY.enabled()


def enable():
    """Open the gate without a profiler (a runner's or a test's choice)."""
    REGISTRY.forced = True


def disable():
    REGISTRY.forced = False


def span(name):
    return REGISTRY.span(name)


def open_step():
    REGISTRY.open_step()


def count(name, n=1):
    REGISTRY.count(name, n)


def counter(name):
    return REGISTRY.counters.get(name, 0)


def reset_counters(prefix=''):
    REGISTRY.reset_counters(prefix)


def reset():
    REGISTRY.reset()


def snapshot():
    return REGISTRY.snapshot()
