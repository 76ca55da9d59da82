"""Data-parallel train steps of the tiny models: the counterpart of
``__graft_entry__.dryrun_multichip``.

    python -m fv2p_torch.parallel.dryrun [N]               # N NCCL ranks, cuda:0..N-1
    python -m fv2p_torch.parallel.dryrun [N] --device cpu  # N gloo ranks on the CPU

N ranks (default 2), one a card or, with ``--device cpu``, on the CPU over
gloo, each take STEPS train steps of the tiny MGAF-3DSSD and the tiny FV2P
(``dryrun_models.yaml``) on their slice of a global batch of N synthetic
scans, and rank 0 prints one ``dryrun_multichip(N) [name]: OK, 2 steps,
loss=...`` line a model (the last step's loss), then
``dryrun_multichip(N): ALL OK [...]``. It shows that the ranks form their
group, that DDP averages the gradients, that a second step finds every
parameter's gradient reduced in the first (DDP raises at the next forward
otherwise) and that the losses are finite; the check of the numbers
against JAX is ``tests/test_torch_ddp.py``.
"""
import argparse
import math
from pathlib import Path

import yaml

from . import global_batch_slice, launch, rank, rank_device, slice_batch, world_size

STEPS = 2
MODELS = Path(__file__).resolve().parent / 'dryrun_models.yaml'
# the optimizer of __graft_entry__.dryrun_multichip
OPTIM = {'OPTIMIZER': 'adam_onecycle', 'LR': 0.003, 'WEIGHT_DECAY': 0.01, 'MOMENTUM': 0.9,
         'MOMS': [0.95, 0.85], 'PCT_START': 0.4, 'DIV_FACTOR': 10, 'GRAD_NORM_CLIP': 10}


def load_models():
    """{'DATA_CONFIG', 'MGAF', 'FV2P'} as EasyDicts."""
    from ..config import EasyDict
    return EasyDict(yaml.safe_load(MODELS.read_text()))


def _rank_step(device_type):
    from .. import parallel
    from ..config import EasyDict
    from ..datasets import dataset_meta_from_cfg
    from ..models import build_network
    from ..train_utils.train_state import TrainStep
    from ..utils.synthetic import batch_to_torch, synthetic_batch_np
    from ..weights import init_random_
    cfgs = load_models()
    device = rank_device(device_type)
    meta = dataset_meta_from_cfg(cfgs.DATA_CONFIG, 'train')
    world = world_size()
    ok = []
    for name, n_points in (('mgaf', 0), ('fv2p', 256)):
        batch = synthetic_batch_np(meta, world, 64, 48, n_points, seed=0, gt='bench',
                                   max_objs=10)
        local = slice_batch(batch, global_batch_slice(world, rank(), world))
        model = build_network(cfgs[name.upper()], 1, ['Car'], meta, device=device)
        init_random_(model, seed=0)
        step = TrainStep(parallel.wrap_model(model), EasyDict(OPTIM), 100)
        local_t = batch_to_torch(local, device)
        losses = [float(step.step(local_t)['loss']) for _ in range(STEPS)]
        if not all(math.isfinite(x) for x in losses):
            raise RuntimeError(f'dryrun_multichip({world}) [{name}]: losses {losses}')
        if rank() == 0:
            print(f'dryrun_multichip({world}) [{name}]: OK, {STEPS} steps, '
                  f'loss={losses[-1]:.4f}', flush=True)
        ok.append(name)
    if rank() == 0:
        print(f'dryrun_multichip({world}): ALL OK [{", ".join(ok)}]', flush=True)


def dryrun_multichip(n_ranks=2, device='cuda'):
    """STEPS data-parallel train steps of both tiny models over ``n_ranks``
    ranks, one a card (NCCL; raises without ``n_ranks`` cards) or on the
    CPU (``device='cpu'``, gloo); rank 0 prints the verdicts."""
    launch(_rank_step, n_ranks, (device,), device)


if __name__ == '__main__':
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('n_ranks', nargs='?', type=int, default=2)
    ap.add_argument('--device', choices=('cuda', 'cpu'), default='cuda')
    args = ap.parse_args()
    dryrun_multichip(args.n_ranks, args.device)
