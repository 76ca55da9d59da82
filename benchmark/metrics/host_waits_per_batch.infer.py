"""Calls in one batch that make the host wait for the card, counted under
CUDA sync debug mode (the detections' copies to the host included)."""
UNIT = 'count'
LAYER = 'post-processing'
MOVES = 'infer_scans_per_s'


def read(rec):
    return rec.get('host_waits')
