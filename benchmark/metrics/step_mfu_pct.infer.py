"""The model operations a batch needs (the benchmark's counter on the
reference's forward) over the window's time a batch, against the card's
989 TFLOP/s bf16 peak."""
UNIT = '%'
LAYER = 'model step'
MOVES = 'infer_scans_per_s'


PEAK_OPS_S = 989e12


def read(rec):
    per_batch_s = rec['window_s'] / rec['batches']
    return 100.0 * rec['model_ops'] / per_batch_s / PEAK_OPS_S
