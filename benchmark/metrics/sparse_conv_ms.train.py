"""A step's sparse convolutions, forward and backward. The program's spans
``slot:sparse_conv`` and ``phase:sparse_conv.backward``
(``fv2p_torch/utils/tracing.py``), a traced step
(``fvbench/program_spans.py``)."""
from fvbench.program_spans import span_ms

UNIT = 'ms'
LAYER = 'sparse trunk'
MOVES = 'train_scans_per_s'
SPANS = ('slot:sparse_conv', 'phase:sparse_conv.backward')


def read(rec):
    return span_ms(rec, SPANS)
