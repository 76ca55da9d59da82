# Frozen at commit c8e3fcd from fv2p_torch/train_utils/train_state.py; data parallel left out; the loss is the detector's own training_loss.
"""One training step: forward in train mode, loss, backward, gradient
clipping, optimizer step. The BatchNorm running statistics update in the
forward. The random draws of a step come from two generators seeded by the
step number: one for the RoI sampling, one for the dropout masks."""
import torch

from .optimization import build_optimizer


def step_generators(step, device):
    """{'sampling', 'dropout'}: generators on ``device`` seeded from the
    step number."""
    gens = {}
    for stream, name in enumerate(('sampling', 'dropout')):
        g = torch.Generator(device=device)
        g.manual_seed((13 << 32) + (int(step) << 1) + stream)
        gens[name] = g
    return gens


class TrainStep:
    """A model in train mode with its optimizer. ``step(batch)`` runs one
    training step and returns the loss terms and ``grad_norm`` (the global
    norm before clipping), all 0-d tensors on the model's device; the three
    phases are also callable one by one (``forward_loss``, ``backward``,
    ``update``), so that a caller can time them. With device rulebooks the
    metrics also hold ``rulebook_dropped``, the sparse rows the levels'
    capacities dropped in the step, and ``dropped_rows`` keeps their running
    sum per level (x_conv2, x_conv3, x_conv4, out) on the device, which a
    caller reads now and then (``tools/train.py``) to raise without a host
    read a step."""

    def __init__(self, model, optim_cfg, total_steps):
        self.model = model.train()
        self.module = model
        self.optimizer = build_optimizer(self.module.parameters(), optim_cfg, total_steps)
        self.device = next(self.module.parameters()).device
        self.dropped_rows = None

    @property
    def step_count(self):
        return self.optimizer.count

    def forward_loss(self, batch_dict):
        bd = dict(batch_dict)
        bd['generators'] = step_generators(self.step_count, self.device)
        out = self.model(bd)
        loss, terms = self.module.training_loss(out)
        return loss, terms, out

    def backward(self, loss):
        self.optimizer.zero_grad()
        loss.backward()

    def update(self):
        grad_norm = self.optimizer.clip_grads()
        self.optimizer.step()
        return grad_norm

    def step(self, batch_dict):
        loss, terms, out = self.forward_loss(batch_dict)
        self.backward(loss)
        grad_norm = self.update()
        metrics = {k: v.detach() for k, v in terms.items()}
        metrics['grad_norm'] = grad_norm
        if 'rulebook_overflow' in out:
            dropped = out['rulebook_overflow']
            metrics['rulebook_dropped'] = dropped.sum()
            self.dropped_rows = dropped if self.dropped_rows is None \
                else self.dropped_rows + dropped
        return metrics
