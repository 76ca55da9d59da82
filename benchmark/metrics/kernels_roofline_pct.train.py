"""The hand kernels' least time a train step over their device time a step
in the profiled stretch."""
UNIT = '%'
LAYER = 'kernels'
MOVES = 'train_scans_per_s'


def read(rec):
    dev = sum(rec.get('kernel_device_s', {}).values())
    if dev <= 0:
        return None
    return 100.0 * sum(rec['kernel_bound_s'].values()) / dev
