"""CUDA-event time a batch of the post_pfe slot (the voxel-to-point decoder:
B2 FPS, B3 3-NN)."""
UNIT = 'ms'
LAYER = 'point and RoI path'
MOVES = 'infer_scans_per_s'


def read(rec):
    return rec.get('slot_ms', {}).get('post_pfe')
