"""A step's gathers of the sparse convolutions: the forward's, and the
backward's two (the input rows for dW, the output gradients for dfeat). The
program's spans ``slot:sparse_conv.gather`` and
``phase:sparse_conv.backward.gather`` (``fv2p_torch/utils/tracing.py``), a
traced step (``fvbench/program_spans.py``). The backward's launches are
issued by autograd's host thread, so part of this can be the host's pace."""
from fvbench.program_spans import span_ms

UNIT = 'ms'
LAYER = 'sparse trunk'
MOVES = 'train_scans_per_s'
SPANS = ('slot:sparse_conv.gather', 'phase:sparse_conv.backward.gather')


def read(rec):
    return span_ms(rec, SPANS)
