"""Rank functions of ``tests/test_torch_ddp.py``, run by
``fv2p_torch.parallel.launch`` in spawned processes. This module imports
torch and the port only, so that a rank starts without JAX."""
import pickle

import torch

from fv2p_torch import parallel
from fv2p_torch.config import EasyDict
from fv2p_torch.datasets import GlobalBatchSampler
from fv2p_torch.models import build_network
from fv2p_torch.models.roi_heads import iouguided_roi_head as torch_roi
from fv2p_torch.train_utils.train_state import TrainStep
from fv2p_torch.utils import misc
from fv2p_torch.utils.synthetic import batch_to_torch
from fv2p_torch.weights import flax_variables, load_flax_variables


def dp_step(spec_path):
    """``spec['steps']`` (default 1) data-parallel train steps from the spec
    the test wrote (config, meta, flax variables, the global numpy batch,
    the optimizer, and for a two-stage model the RoI draws of one rank's
    scans): this rank's slice of the batch through ``TrainStep`` over the
    DDP-wrapped model. Returns the first step's metrics (host floats), every
    step's, and the parameters, running statistics and (clipped, averaged)
    gradients after the last step as flat {flax path: array}."""
    with open(spec_path, 'rb') as f:
        spec = pickle.load(f)
    world = parallel.world_size()
    cfg = EasyDict(spec['cfg'])
    model = build_network(cfg, 1, ['Car'], spec['meta'], device='cpu')
    load_flax_variables(model, spec['variables'])
    step = TrainStep(parallel.wrap_model(model), EasyDict(spec['optim']), spec['total'])
    local = parallel.slice_batch(spec['batch'],
                                 parallel.global_batch_slice(spec['batch_size'],
                                                             parallel.rank(), world))
    if spec.get('draws') is not None:
        draws = {k: torch.from_numpy(v) for k, v in spec['draws'].items()}
        torch_roi.draw_roi_sampling = lambda b, r, n, gen, dev: draws
    local = batch_to_torch(local, 'cpu')
    steps = [{k: float(v) for k, v in step.step(local).items()}
             for _ in range(spec.get('steps', 1))]
    out = {'metrics': steps[0], 'steps': steps,
           'variables': flax_variables(model), 'grads': flax_variables(model, grads=True)}
    return misc.all_gather(out)          # every rank's state, for rank 0


def ddp_equals_plain(spec_path):
    """At one rank: two train steps of TrainStep over the DDP-wrapped model
    and over the bare model, from the same weights and batch, on one CPU
    thread (several threads add autograd's scatter-adds in an order that
    changes from run to run, wrapper or not). Returns the largest difference
    of any loss term and of any parameter or running statistic."""
    torch.set_num_threads(1)
    with open(spec_path, 'rb') as f:
        spec = pickle.load(f)
    cfg = EasyDict(spec['cfg'])
    runs = []
    for wrap in (True, False):
        model = build_network(cfg, 1, ['Car'], spec['meta'], device='cpu')
        load_flax_variables(model, spec['variables'])
        step = TrainStep(parallel.wrap_model(model) if wrap else model,
                         EasyDict(spec['optim']), spec['total'])
        assert isinstance(step.model, torch.nn.parallel.DistributedDataParallel) == wrap
        batch = batch_to_torch(spec['batch'], 'cpu')
        terms = [step.step(batch) for _ in range(2)]
        runs.append((terms, model.state_dict()))
    (ta, sa), (tb, sb) = runs
    loss_diff = max(float((a[k] - b[k]).abs()) for a, b in zip(ta, tb) for k in a)
    state_diff = max(float((sa[k].float() - sb[k].float()).abs().max()) for k in sa)
    return {'loss_diff': loss_diff, 'state_diff': state_diff, 'terms': len(ta[0])}


def sampler_orders(n, batch_size, epochs, seed):
    """This rank's indices of each epoch of a GlobalBatchSampler, its global
    generator seeded with ``seed + rank`` (the ranks' generators differ;
    rank 0's seed decides), gathered on every rank."""
    torch.manual_seed(seed + parallel.rank())
    sampler = GlobalBatchSampler(n, batch_size, parallel.rank(), parallel.world_size())
    mine = [list(sampler) for _ in range(epochs)]
    return misc.all_gather({'orders': mine, 'len': len(sampler)})
