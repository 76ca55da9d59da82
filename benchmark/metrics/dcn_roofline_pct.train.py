"""The deformable conv's calls of one train step, each replayed forward and
backward on its own inputs: their least time over their replayed time."""
UNIT = '%'
LAYER = 'kernels'
MOVES = 'train_scans_per_s'


def read(rec):
    if not rec.get('dcn_time_s'):
        return None
    return 100.0 * rec['dcn_bound_s'] / rec['dcn_time_s']
