"""CUDA-event time a batch of the dense_head slot."""
UNIT = 'ms'
LAYER = 'dense head'
MOVES = 'infer_scans_per_s'


def read(rec):
    return rec.get('slot_ms', {}).get('dense_head')
