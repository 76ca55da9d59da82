"""CUDA-event time a train step of the backward pass."""
UNIT = 'ms'
LAYER = 'training'
MOVES = 'train_scans_per_s'


def read(rec):
    return rec.get('phase_ms', {}).get('backward')
