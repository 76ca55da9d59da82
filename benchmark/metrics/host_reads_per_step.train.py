"""Program lines that make the host wait for the card in one train step
(forward, targets, loss, backward, update): the ``host_reads.*`` counters of
``fv2p_torch/utils/tracing.py`` a step (``fvbench/program_spans.py``). Each
counter sits at one line found to wait (PERF.md names them); a wait at a
line with no counter is not counted."""
from fvbench.program_spans import count_per_step

UNIT = 'count'
LAYER = 'training'
MOVES = 'train_scans_per_s'


def read(rec):
    return count_per_step(rec, 'host_reads.')
