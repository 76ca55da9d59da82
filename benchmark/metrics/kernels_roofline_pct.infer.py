"""The hand kernels' least time a batch (the bounds of their captured calls)
over their device time a batch in the profiled stretch."""
UNIT = '%'
LAYER = 'kernels'
MOVES = 'infer_scans_per_s'


def read(rec):
    dev = sum(rec.get('kernel_device_s', {}).values())
    if dev <= 0:
        return None
    return 100.0 * sum(rec['kernel_bound_s'].values()) / dev
