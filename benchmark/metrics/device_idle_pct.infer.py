"""Share of the untraced window in which no operation ran on the card: one
minus the card's busy time a batch (the union of its operations in the
profiled stretch after the window, over that stretch's batches) over the
window's time a batch. The profiler slows the host, not the card, so busy
time comes from the trace and wall time from the window of the same run
(the profiler's own slowdown: ``profiler_slowdown_pct.infer``)."""
UNIT = '%'
LAYER = 'model step'
MOVES = 'infer_scans_per_s'


def read(rec):
    if not rec.get('profiled_batches') or not rec.get('batches'):
        return None
    busy = rec['busy_s'] / rec['profiled_batches']
    wall = rec['window_s'] / rec['batches']
    return 100.0 * (1.0 - busy / wall)
