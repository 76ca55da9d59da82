"""Program lines that make the host wait for the card, a batch: the
``host_reads.*`` counters of ``fv2p_torch/utils/tracing.py``
(``fvbench/program_spans.py``). Each counter sits at one line found to wait
(an NMS round's read, a ``nonzero``, a ``.tolist()`` of the sparse levels'
bounds; PERF.md names them); a wait at a line with no counter is not
counted. The benchmark's own copies of the detections are not among them."""
from fvbench.program_spans import count_per_step

UNIT = 'count'
LAYER = 'post-processing'
MOVES = 'infer_scans_per_s'


def read(rec):
    return count_per_step(rec, 'host_reads.')
