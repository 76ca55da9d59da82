"""A batch's bilinear sampling in the deformable convs: the taps' corner rows
and weights, the padded source, and each tap's four corners gathered and
blended (the products are the parent span's self time). The program's span
``slot:dcn.sample`` (``fv2p_torch/utils/tracing.py``), a traced batch
(``fvbench/program_spans.py``)."""
from fvbench.program_spans import span_ms

UNIT = 'ms'
LAYER = 'kernels'
MOVES = 'infer_scans_per_s'
SPANS = ('slot:dcn.sample',)


def read(rec):
    return span_ms(rec, SPANS)
