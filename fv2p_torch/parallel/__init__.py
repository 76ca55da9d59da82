"""Multi-GPU data parallelism (counterpart of ``fv2p_tpu/parallel/__init__.py``
and of the axis-name branch of ``make_train_step``,
``fv2p_tpu/train_utils/train_state.py``).

JAX shards each global batch of B samples over a 1-D mesh of W devices:
device d takes samples [d B/W, (d+1) B/W), runs the whole model on them
(its BatchNorms normalise by the batch statistics of its own samples) and
``pmean``s three things over the mesh after the backward pass: the
gradients, the loss terms and the new running statistics. The port runs one
process a card (a rank), joined by ``torch.distributed``:

* ``init_process_group``: torchrun's ``env://`` (RANK, WORLD_SIZE,
  LOCAL_RANK, MASTER_ADDR, MASTER_PORT), NCCL for ranks on the card, gloo
  for ranks on the CPU; ``launch`` starts such ranks itself;
* ``wrap_model``: ``DistributedDataParallel`` with ``broadcast_buffers``
  off, which averages the gradients in the backward pass (DDP's default
  would copy rank 0's running statistics over the others' at every forward);
* ``average_running_stats``: the mean of every BatchNorm's running mean and
  variance over the ranks, after each step (JAX's ``pmean(new_stats)``).
  This is not SyncBN: SyncBN would normalise by statistics of the whole
  global batch, a different forward from JAX's;
* ``global_batch_slice``: rank r's samples of a global batch, JAX's
  contiguous split; ``stride_shard`` and ``interleave``: the eval split
  ``rank::world`` and the merge back into dataset order.

Every function works without a process group, as one rank of one.
"""
import datetime
import os
import pickle
import socket
from pathlib import Path

import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(minutes=30)
_TORCHRUN_ENV = ('RANK', 'WORLD_SIZE', 'MASTER_ADDR', 'MASTER_PORT')


def is_distributed():
    return dist.is_available() and dist.is_initialized()


def rank():
    return dist.get_rank() if is_distributed() else 0


def world_size():
    return dist.get_world_size() if is_distributed() else 1


def local_rank():
    return int(os.environ.get('LOCAL_RANK', rank()))


def init_process_group(device_type, timeout=TIMEOUT):
    """Join the ranks that torchrun (or ``launch``) started, from its
    environment: NCCL when the ranks run on the card, gloo on the CPU. A
    missing variable raises: a run asked to be distributed never falls back
    to one process."""
    missing = [k for k in _TORCHRUN_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f'--dist: {missing} not set; launch the ranks with torchrun '
                           '(torchrun --nproc_per_node N -m fv2p_torch.tools.train --dist ...) '
                           'or pass --num_devices N')
    backend = 'nccl' if device_type == 'cuda' else 'gloo'
    if device_type == 'cuda':
        rank_device(device_type)            # NCCL binds each rank to its card first
    dist.init_process_group(backend, init_method='env://', timeout=timeout)


def rank_device(device_type):
    """This rank's device: ``cuda:LOCAL_RANK`` (made current), which must
    exist, or the CPU."""
    if device_type == 'cpu':
        return torch.device('cpu')
    idx = local_rank()
    if not torch.cuda.is_available() or idx >= torch.cuda.device_count():
        raise RuntimeError(f'rank {rank()} runs on cuda:{idx}, but this machine has '
                           f'{torch.cuda.device_count()} CUDA card(s)')
    torch.cuda.set_device(idx)
    return torch.device('cuda', idx)


def _collective_device():
    """Where a collective's tensors live: the card under NCCL, else the CPU."""
    if dist.get_backend() == 'nccl':
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device('cpu')


def wrap_model(model):
    """``model`` in ``DistributedDataParallel``, its buffers left alone;
    the model itself without a process group."""
    if not is_distributed():
        return model
    dev = next(model.parameters()).device
    return torch.nn.parallel.DistributedDataParallel(
        model, device_ids=[dev.index] if dev.type == 'cuda' else None,
        broadcast_buffers=False)


def unwrap(model):
    """The module inside a DDP wrapper (or the model itself)."""
    return model.module if isinstance(model, torch.nn.parallel.DistributedDataParallel) \
        else model


def _mean_(tensors):
    """Average equal-shaped lists of tensors over the ranks in place, in one
    collective."""
    if world_size() == 1 or not tensors:
        return
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dev = _collective_device()
    buf = flat.to(dev)
    dist.all_reduce(buf)                    # gloo has no AVG: sum, then divide
    buf = (buf / world_size()).to(flat.device)
    torch._foreach_copy_(tensors, [p.view_as(t) for p, t in
                                   zip(buf.split([t.numel() for t in tensors]), tensors)])


@torch.no_grad()
def average_running_stats(model):
    """Every BatchNorm's running mean and variance, averaged over the ranks
    (JAX's ``pmean`` of the new ``batch_stats``)."""
    from ..models.layers import BatchNorm
    from ..ops.sparse.conv import MaskedBatchNorm
    bns = [m for m in unwrap(model).modules() if isinstance(m, (BatchNorm, MaskedBatchNorm))]
    _mean_([t for m in bns for t in (m.running_mean, m.running_var)])


def mean_over_ranks(values):
    """{name: 0-d tensor} averaged over the ranks (JAX's ``pmean(tb)``); a
    new dict of f32 tensors, the same values without a process group."""
    names = sorted(values)
    if world_size() == 1:
        return dict(values)
    stacked = torch.stack([values[k].detach().float() for k in names])
    _mean_([stacked])
    return dict(zip(names, stacked.unbind()))


def sum_over_ranks(tensor):
    """A tensor summed over the ranks (a new tensor)."""
    if world_size() == 1:
        return tensor
    buf = tensor.detach().clone().to(_collective_device())
    dist.all_reduce(buf)
    return buf.to(tensor.device)


def broadcast_int(value):
    """Rank 0's integer on every rank."""
    if world_size() == 1:
        return int(value)
    buf = torch.tensor([int(value)], dtype=torch.int64, device=_collective_device())
    dist.broadcast(buf, 0)
    return int(buf.item())


def global_batch_slice(batch_size, rank, world):
    """Rank ``rank``'s samples of a global batch of ``batch_size``: the
    contiguous block [r B/W, (r+1) B/W), as JAX's ``shard_batch`` splits
    along the sample axis. Raises unless W divides B."""
    if batch_size % world:
        raise ValueError(f'the global batch of {batch_size} does not split over '
                         f'{world} ranks')
    per = batch_size // world
    return slice(rank * per, (rank + 1) * per)


def slice_batch(batch, sl):
    """Every array of a batch dict (nested dicts too, every leaf sample-
    leading) cut to the samples ``sl``."""
    return {k: slice_batch(v, sl) if isinstance(v, dict) else v[sl] for k, v in batch.items()}


def stride_shard(n, rank, world):
    """Rank ``rank``'s samples of an eval set of ``n``: ``rank::world``."""
    return list(range(rank, n, world))


def interleave(parts):
    """Merge per-rank lists sharded ``rank::world`` back into dataset order
    (round robin; only trailing ranks run short)."""
    out = []
    for i in range(max((len(p) for p in parts), default=0)):
        out.extend(p[i] for p in parts if i < len(p))
    return out


# ------------------------------------------------------- starting ranks

def free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _rank_entry(local, world, port, device_type, fn, args, result_path, timeout):
    os.environ.update(RANK=str(local), LOCAL_RANK=str(local), WORLD_SIZE=str(world),
                      MASTER_ADDR='127.0.0.1', MASTER_PORT=str(port))
    if device_type == 'cpu':            # the ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    init_process_group(device_type, timeout)
    try:
        result = fn(*args)
        if local == 0 and result_path is not None:
            tmp = Path(f'{result_path}.tmp')
            tmp.write_bytes(pickle.dumps(result))
            os.replace(tmp, result_path)
    finally:
        dist.destroy_process_group()


def launch(fn, world, args, device_type, result_path=None, timeout=TIMEOUT):
    """Run ``fn(*args)`` in ``world`` spawned processes joined in one process
    group on this host (rank r on ``cuda:r`` with ``device_type`` 'cuda', or
    on the CPU over gloo with 'cpu') and wait for all of them. A rank that
    raises ends the others and the launch raises. With ``result_path`` rank
    0's return value is pickled there and returned."""
    import torch.multiprocessing as mp
    if device_type == 'cuda' and torch.cuda.device_count() < world:
        raise RuntimeError(f'{world} ranks on the card need {world} CUDA cards; this '
                           f'machine has {torch.cuda.device_count()}')
    mp.start_processes(_rank_entry, nprocs=world, start_method='spawn',
                       args=(world, free_port(), device_type, fn, tuple(args),
                             None if result_path is None else str(result_path), timeout))
    if result_path is None:
        return None
    with open(result_path, 'rb') as f:
        return pickle.load(f)
