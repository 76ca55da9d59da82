"""The control of ``correct``: the reference put in the program's place and
computed one precision below the configuration's bf16 (``reference.Fp8``:
every product's operands rounded to float8 e4m3), on the cell's own inputs,
weights and sizes, compared with the reference by the cell's own
numbers. A limit is sound only where the control reads above it. A
training cell's numbers are also read with a fault planted in the
reference put in the program's place, and every cell's with a sound
witness there: the reference summing its products in another order
(``reference.F32Sums``), which a limit has to let pass."""
import contextlib

import torch

from . import compare, harness, reference
from .cell import dataset_meta


def half_batch(batch):
    """The first half of a batch's scans (every tensor of it is batch-first,
    the per-sample tables too): the fault of a step that leaves half the
    batch out and takes the mean over the rest."""
    def cut(v):
        if isinstance(v, dict):
            return {k: cut(x) for k, x in v.items()}
        return v[:v.shape[0] // 2] if torch.is_tensor(v) and v.dim() else v
    return cut(batch)


SIDES = {'control': reference.Fp8, 'reorder': reference.F32Sums}


def readings(cell, seed, device='cuda', side='control'):
    """The readings of one seed by the numbers of the cell's mode, of the
    reference put in the program's place as ``side``: ``control`` (fp8),
    ``reorder`` (the sound witness) or, in training, ``half_batch`` (the
    fault), against the reference."""
    tr = cell.traffic
    meta = dataset_meta(cell.cfg, tr['voxel_cap'])
    pool_np = harness.draw_pool(cell, seed, meta)
    state, _ = harness.make_state(cell, seed, meta, pool_np, device)
    rng = harness.batch_rng(seed, harness.CHECK_STREAM)
    if cell.mode == 'infer':
        keep = sorted(rng.choice(tr['pool'], tr['checked_batches'], replace=False).tolist())
        low, ref = {}, {}
        for k in keep:
            batch = harness.prepared(reference, cell, pool_np[k], meta, device)
            model = reference.build_model(cell.cfg, meta, device, harness.compute_dtype(cell))
            model.load_state_dict(state)
            ref[k] = reference.detections(model, batch)
            with SIDES[side]():
                low[k] = [{key: torch.from_numpy(v) for key, v in
                           reference.detections(model, batch).items()}]
        return compare.detections(low, ref)
    batches = [harness.prepared(reference, cell, b, meta, device)
               for b in pool_np[:tr['checked_steps']]]
    runs = []
    for planted in (True, False):
        model = reference.build_model(cell.cfg, meta, device, harness.compute_dtype(cell))
        model.load_state_dict(state)
        names = [k for k, _ in model.named_parameters()]
        fed = [half_batch(b) for b in batches] if planted and side == 'half_batch' \
            else batches
        mode = SIDES.get(side) if planted else None
        with mode() if mode else contextlib.nullcontext():
            runs.append(reference.train_steps(model, cell.cfg.OPTIMIZATION,
                                              tr['total_steps'], fed))
        del model
    return compare.train(runs[0], runs[1], names, cell.limits['steady_terms'])
