"""CUDA-event time a batch of the roi_head slot (proposal NMS through B1, B4,
the two passes)."""
UNIT = 'ms'
LAYER = 'point and RoI path'
MOVES = 'infer_scans_per_s'


def read(rec):
    return rec.get('slot_ms', {}).get('roi_head')
