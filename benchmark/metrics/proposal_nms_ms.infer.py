"""A batch's proposal NMS in the RoI head, one greedy rotated NMS a scan. The
program's span ``slot:roi_head.proposal_nms``
(``fv2p_torch/utils/tracing.py``), a traced batch
(``fvbench/program_spans.py``). The NMS is bound by the host (a read of the
card each fixed-point round), so this is the host's pace under the
profiler: it swings with the profiler's host slowdown
(``profiler_slowdown_pct.infer``): 7.3-14.5 ms over six runs of one tree
on an H100 80GB.
It says how long the proposal NMS holds the batch, not how fast its
kernel runs: judge a change of the NMS kernel by its device time in the
trace (``kernels_roofline_pct.infer``)."""
from fvbench.program_spans import span_ms

UNIT = 'ms'
LAYER = 'point and RoI path'
MOVES = 'infer_scans_per_s'
SPANS = ('slot:roi_head.proposal_nms',)


def read(rec):
    return span_ms(rec, SPANS)
