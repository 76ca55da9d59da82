"""A batch's sparse convolutions whole: gather, matmul, bias and mask. The
program's span ``slot:sparse_conv`` (``fv2p_torch/utils/tracing.py``), a
traced batch (``fvbench/program_spans.py``)."""
from fvbench.program_spans import span_ms

UNIT = 'ms'
LAYER = 'sparse trunk'
MOVES = 'infer_scans_per_s'
SPANS = ('slot:sparse_conv',)


def read(rec):
    return span_ms(rec, SPANS)
