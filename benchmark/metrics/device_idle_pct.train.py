"""Share of the untraced window in which no operation ran on the card: one
minus the card's busy time a step (the union of its operations in the
profiled stretch after the window, over that stretch's steps) over the
window's time a step. The profiler slows the host, not the card, so busy
time comes from the trace and wall time from the window of the same run
(the profiler's own slowdown: ``profiler_slowdown_pct.train``)."""
UNIT = '%'
LAYER = 'model step'
MOVES = 'train_scans_per_s'


def read(rec):
    if not rec.get('profiled_batches') or not rec.get('batches'):
        return None
    busy = rec['busy_s'] / rec['profiled_batches']
    wall = rec['window_s'] / rec['batches']
    return 100.0 * (1.0 - busy / wall)
