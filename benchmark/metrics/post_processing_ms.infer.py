"""CUDA-event time a batch from the end of the last slot to the batch's end
(its detections copied to the host): the final NMS through B1."""
UNIT = 'ms'
LAYER = 'post-processing'
MOVES = 'infer_scans_per_s'


def read(rec):
    return rec.get('post_processing_ms')
