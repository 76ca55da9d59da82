"""The model operations a train step needs (three times the forward's) over
the window's time a step, against the card's 989 TFLOP/s bf16 peak."""
UNIT = '%'
LAYER = 'model step'
MOVES = 'train_scans_per_s'


PEAK_OPS_S = 989e12


def read(rec):
    per_step_s = rec['window_s'] / rec['batches']
    return 100.0 * rec['model_ops'] / per_step_s / PEAK_OPS_S
