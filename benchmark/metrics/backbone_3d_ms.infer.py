"""CUDA-event time a batch from the start of the vfe slot to the end of
map_to_bev_module: MeanVFE, VoxelResBackBone8x, HeightCompression."""
UNIT = 'ms'
LAYER = 'sparse trunk'
MOVES = 'infer_scans_per_s'


SLOTS = ('vfe', 'backbone_3d', 'map_to_bev_module')


def read(rec):
    ms = rec.get('slot_ms', {})
    if not all(s in ms for s in SLOTS):
        return None
    return sum(ms[s] for s in SLOTS)
