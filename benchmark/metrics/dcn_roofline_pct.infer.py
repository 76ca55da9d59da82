"""The deformable conv's calls of one batch, each replayed on its own inputs:
their least time (forward) over their replayed time."""
UNIT = '%'
LAYER = 'kernels'
MOVES = 'infer_scans_per_s'


def read(rec):
    if not rec.get('dcn_time_s'):
        return None
    return 100.0 * rec['dcn_bound_s'] / rec['dcn_time_s']
