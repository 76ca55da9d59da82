"""The optimizer of the KITTI configs (counterpart of
``fv2p_tpu/train_utils/optimization.py``): ``adam_onecycle``, with optax's
numerics.

One step is ``clip_by_global_norm(GRAD_NORM_CLIP)`` followed by
``adamw(lr(t), b1=mom(t), b2=0.99, eps=1e-8, weight_decay=WEIGHT_DECAY)``,
the learning rate and beta1 read from cosine one-cycle schedules at the
step count before the update:

    g    <- g * (clip / |g|)          only where |g| > clip (the global norm)
    mu   <- (1 - b1) g + b1 mu ;  nu <- (1 - b2) g^2 + b2 nu ;  t <- t + 1
    p    <- p - lr (mu / (1 - b1^t) / (sqrt(nu / (1 - b2^t)) + eps) + wd p)

The weight decay is decoupled and applies to every parameter. Not
``clip_grad_norm_``: it divides by ``|g| + 1e-6``.
"""
import math

import torch


def annealing_cos(start, end, pct):
    return end + (start - end) / 2.0 * (torch.cos(math.pi * pct) + 1.0)


def _phases(step, pct_start, total_steps):
    """(step < a1, progress in phase 1, progress in phase 2) in f32, as the
    JAX schedules compute them."""
    a1 = int(total_steps * pct_start)
    s = torch.tensor(float(step), dtype=torch.float32)
    p1 = torch.clamp(s / max(a1, 1), 0.0, 1.0)
    p2 = torch.clamp((s - a1) / max(total_steps - a1, 1), 0.0, 1.0)
    return step < a1, p1, p2


def one_cycle_lr(step, lr_max, div_factor, pct_start, total_steps):
    """lr_max / div_factor up to lr_max over the first pct_start of the
    steps, then down to lr_max / div_factor / 1e4, cosine in both."""
    low = lr_max / div_factor
    first, p1, p2 = _phases(step, pct_start, total_steps)
    if first:
        return float(annealing_cos(low, lr_max, p1))
    return float(annealing_cos(lr_max, low / 1e4, p2))


def one_cycle_mom(step, moms, pct_start, total_steps):
    """Adam's beta1: moms[0] down to moms[1] and back, cosine."""
    first, p1, p2 = _phases(step, pct_start, total_steps)
    if first:
        return float(annealing_cos(moms[0], moms[1], p1))
    return float(annealing_cos(moms[1], moms[0], p2))


class AdamOneCycle:
    """optax's ``chain(clip_by_global_norm, inject_hyperparams(adamw))``
    over a list of parameters, reading their ``.grad``."""

    def __init__(self, params, optim_cfg, total_steps):
        self.params = list(params)
        self.lr_max = float(optim_cfg.LR)
        self.div_factor = float(optim_cfg.DIV_FACTOR)
        self.pct_start = float(optim_cfg.PCT_START)
        self.moms = tuple(float(m) for m in optim_cfg.MOMS)
        self.weight_decay = float(optim_cfg.WEIGHT_DECAY)
        self.clip = float(optim_cfg.get('GRAD_NORM_CLIP', 0) or 0)
        self.total_steps = int(total_steps)
        self.b2, self.eps = 0.99, 1e-8
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def hyperparams(self):
        """(lr, beta1) of the next step."""
        return (one_cycle_lr(self.count, self.lr_max, self.div_factor,
                             self.pct_start, self.total_steps),
                one_cycle_mom(self.count, self.moms, self.pct_start,
                              self.total_steps))

    def state_dict(self):
        """The one-cycle step and the moments (the tensors themselves)."""
        return {'count': self.count, 'mu': self.mu, 'nu': self.nu}

    @torch.no_grad()
    def load_state_dict(self, state):
        """Restore a ``state_dict``: the moments are copied into the
        optimizer's own tensors."""
        if len(state['mu']) != len(self.mu) or len(state['nu']) != len(self.nu):
            raise ValueError('optimizer state of another model')
        self.count = int(state['count'])
        torch._foreach_copy_(self.mu, list(state['mu']))
        torch._foreach_copy_(self.nu, list(state['nu']))

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    def _grads(self):
        """Every parameter's gradient (zeros set where it has none), the
        tensors held by the parameters, so the clip scales them in place."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return [p.grad for p in self.params]

    @torch.no_grad()
    def clip_grads(self):
        """Scale the gradients to the global norm GRAD_NORM_CLIP where they
        exceed it (no host wait); returns the norm before clipping."""
        grads = self._grads()
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        if self.clip > 0:
            under = norm < self.clip
            torch._foreach_div_(grads, torch.where(under, 1.0, norm))
            torch._foreach_mul_(grads, torch.where(under, 1.0, self.clip))
        return norm

    @torch.no_grad()
    def step(self):
        """One update of every parameter, as multi-tensor operations (a few
        launches for the whole model, each rounding as the formula above)."""
        lr, b1 = self.hyperparams()
        self.count += 1
        t = self.count
        # the bias corrections in f32, as optax computes them
        c1 = float(1.0 - torch.tensor(b1, dtype=torch.float32) ** t)
        c2 = float(1.0 - torch.tensor(self.b2, dtype=torch.float32) ** t)
        grads = self._grads()
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1.0 - b1))
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(torch._foreach_mul(grads, grads),
                                                        1.0 - self.b2))
        den = torch._foreach_div(self.nu, c2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        update = torch._foreach_div(self.mu, c1)
        torch._foreach_div_(update, den)
        torch._foreach_add_(update, torch._foreach_mul(self.params, self.weight_decay))
        torch._foreach_mul_(update, -lr)
        torch._foreach_add_(self.params, update)


def build_optimizer(params, optim_cfg, total_steps):
    if optim_cfg.OPTIMIZER != 'adam_onecycle':
        raise NotImplementedError(
            f'optimizer {optim_cfg.OPTIMIZER} is not in fv2p_torch yet '
            '(ROADMAP.md, queue A: the runner)')
    return AdamOneCycle(params, optim_cfg, total_steps)
