"""A batch's gathers of the sparse convolutions' input rows through their
tables. The program's span ``slot:sparse_conv.gather``
(``fv2p_torch/utils/tracing.py``), a traced batch
(``fvbench/program_spans.py``)."""
from fvbench.program_spans import span_ms

UNIT = 'ms'
LAYER = 'sparse trunk'
MOVES = 'infer_scans_per_s'
SPANS = ('slot:sparse_conv.gather',)


def read(rec):
    return span_ms(rec, SPANS)
