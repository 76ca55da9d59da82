"""How much longer a batch takes in the profiled stretch than in the
untraced window of the same run: the profiler's cost on the host, which
``device_idle_pct.infer`` leaves out by taking its wall time from the
window."""
UNIT = '%'
LAYER = 'model step'
MOVES = 'infer_scans_per_s'


def read(rec):
    if not rec.get('profiled_batches') or not rec.get('batches'):
        return None
    traced = rec['profiled_s'] / rec['profiled_batches']
    wall = rec['window_s'] / rec['batches']
    return 100.0 * (traced / wall - 1.0)
