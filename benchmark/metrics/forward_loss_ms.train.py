"""CUDA-event time a train step of the forward in train mode, the targets and
the loss."""
UNIT = 'ms'
LAYER = 'training'
MOVES = 'train_scans_per_s'


def read(rec):
    return rec.get('phase_ms', {}).get('forward_loss')
