"""CUDA-event time a batch of the backbone_2d slot."""
UNIT = 'ms'
LAYER = 'BEV backbone'
MOVES = 'infer_scans_per_s'


def read(rec):
    return rec.get('slot_ms', {}).get('backbone_2d')
