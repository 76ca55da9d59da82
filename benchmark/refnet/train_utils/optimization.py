# Frozen at commit c8e3fcd from fv2p_torch/train_utils/optimization.py, unchanged.
"""The optimizers (counterpart of ``fv2p_tpu/train_utils/optimization.py``),
with optax's numerics. Each step is ``clip_by_global_norm(GRAD_NORM_CLIP)``
(when it is set) followed by the yaml's OPTIMIZER:

* ``adam_onecycle`` (every shipped yaml): ``adamw(lr(t), b1=mom(t),
  b2=0.99, eps=1e-8, weight_decay=WEIGHT_DECAY)``, the learning rate and
  beta1 read from cosine one-cycle schedules at the step count before the
  update;
* ``adam``: ``adamw`` at the constant LR, b1 0.9, b2 0.999, eps 1e-8;
* ``sgd``: ``add_decayed_weights(WEIGHT_DECAY)`` then ``sgd(LR,
  MOMENTUM)``, so that the decay enters the momentum trace (no Nesterov).

    g    <- g * (clip / |g|)          only where |g| > clip (the global norm)
    adamw: mu <- (1 - b1) g + b1 mu ;  nu <- (1 - b2) g^2 + b2 nu ;  t <- t + 1
           p  <- p - lr (mu / (1 - b1^t) / (sqrt(nu / (1 - b2^t)) + eps) + wd p)
    sgd:   m  <- (g + wd p) + momentum m ;  p <- p - lr m

The weight decay applies to every parameter. Not ``clip_grad_norm_``: it
divides by ``|g| + 1e-6``. ``decay_lr_schedule`` is JAX's stepped decay,
which JAX's ``build_optimizer`` does not use either.
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


def decay_lr_schedule(lr, decay_step_list, lr_decay, lr_clip, steps_per_epoch,
                      warmup_epoch=1, warmup=False):
    """The step -> learning rate function of a stepped decay: ``lr`` times
    ``lr_decay`` at each epoch of ``decay_step_list``, never under
    ``lr_clip``, with an optional linear warmup over ``warmup_epoch``
    epochs; in f32, as JAX computes it."""
    boundaries = [int(e * steps_per_epoch) for e in decay_step_list]
    f32 = torch.float32

    def sched(step):
        s = torch.tensor(float(step), dtype=f32)
        decay = torch.ones((), dtype=f32)
        for b in boundaries:
            decay = torch.where(s >= b, decay * lr_decay, decay)
        cur = torch.clamp(lr * decay, min=lr_clip)
        if warmup:
            w_steps = warmup_epoch * steps_per_epoch
            warm = torch.clamp(lr * (s / max(w_steps, 1)), min=lr_clip)
            cur = torch.where(s < w_steps, warm, cur)
        return float(cur)

    return sched


def one_cycle_mom(step, moms, pct_start, total_steps):
    """Adam's beta1: moms[0] down to moms[1] and back, cosine."""
    first, p1, p2 = _phases(step, pct_start, total_steps)
    if first:
        return float(annealing_cos(moms[0], moms[1], p1))
    return float(annealing_cos(moms[1], moms[0], p2))


class _Optimizer:
    """The clip, the step count and the state tensors of an optax
    ``chain(clip_by_global_norm, ...)`` over a list of parameters, reading
    their ``.grad``; a subclass names its state (``state_names``, one
    tensor a parameter each) and gives ``step``."""
    state_names = ()

    def __init__(self, params, optim_cfg):
        self.params = list(params)
        self.lr = float(optim_cfg.LR)
        self.weight_decay = float(optim_cfg.WEIGHT_DECAY)
        self.clip = float(optim_cfg.get('GRAD_NORM_CLIP', 0) or 0)
        self.count = 0
        for name in self.state_names:
            setattr(self, name, [torch.zeros_like(p) for p in self.params])

    def state_dict(self):
        """The step count and the state (the tensors themselves)."""
        return {'count': self.count, **{n: getattr(self, n) for n in self.state_names}}

    @torch.no_grad()
    def load_state_dict(self, state):
        """Restore a ``state_dict``: the state is copied into the
        optimizer's own tensors."""
        if any(len(state[n]) != len(getattr(self, n)) for n in self.state_names):
            raise ValueError('optimizer state of another model')
        self.count = int(state['count'])
        for n in self.state_names:
            torch._foreach_copy_(getattr(self, n), list(state[n]))

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


class _AdamW(_Optimizer):
    """optax's ``adamw``; ``hyperparams()`` gives (lr, b1) of the next
    step."""
    state_names = ('mu', 'nu')
    b2, eps = 0.999, 1e-8

    @torch.no_grad()
    def step(self):
        """One update of every parameter, as multi-tensor operations (a few
        launches for the whole model, each rounding as the formula above)."""
        lr, b1 = self.hyperparams()
        self.count += 1
        t = self.count
        # the decays, their complements and the bias corrections in f32, as
        # optax computes them from its f32 hyperparameters
        b1_, b2_ = (torch.tensor(b, dtype=torch.float32) for b in (b1, self.b2))
        c1, c2 = float(1.0 - b1_ ** t), float(1.0 - b2_ ** t)
        grads = self._grads()
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, float(1.0 - b1_)))
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(torch._foreach_mul(grads, grads),
                                                        float(1.0 - b2_)))
        den = torch._foreach_div(self.nu, c2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        update = torch._foreach_div(self.mu, c1)
        torch._foreach_div_(update, den)
        torch._foreach_add_(update, torch._foreach_mul(self.params, self.weight_decay))
        torch._foreach_mul_(update, -lr)
        torch._foreach_add_(self.params, update)


class AdamOneCycle(_AdamW):
    """``adam_onecycle``: b2 0.99, the learning rate and beta1 on the
    one-cycle schedules."""
    b2 = 0.99

    def __init__(self, params, optim_cfg, total_steps):
        super().__init__(params, optim_cfg)
        self.div_factor = float(optim_cfg.DIV_FACTOR)
        self.pct_start = float(optim_cfg.PCT_START)
        self.moms = tuple(float(m) for m in optim_cfg.MOMS)
        self.total_steps = int(total_steps)

    def hyperparams(self):
        return (one_cycle_lr(self.count, self.lr, self.div_factor, self.pct_start,
                             self.total_steps),
                one_cycle_mom(self.count, self.moms, self.pct_start, self.total_steps))


class Adam(_AdamW):
    """``adam``: the constant LR, b1 0.9."""

    def hyperparams(self):
        return self.lr, 0.9


class SGD(_Optimizer):
    """``sgd``: the decayed weights added to the gradient, then a momentum
    trace; ``hyperparams()`` gives (lr, momentum)."""
    state_names = ('trace',)

    def __init__(self, params, optim_cfg):
        super().__init__(params, optim_cfg)
        self.momentum = float(optim_cfg.MOMENTUM)

    def hyperparams(self):
        return self.lr, self.momentum

    @torch.no_grad()
    def step(self):
        self.count += 1
        decayed = torch._foreach_add(self._grads(),
                                     torch._foreach_mul(self.params, self.weight_decay))
        torch._foreach_mul_(self.trace, self.momentum)
        torch._foreach_add_(self.trace, decayed)
        torch._foreach_add_(self.params, torch._foreach_mul(self.trace, -self.lr))


def build_optimizer(params, optim_cfg, total_steps):
    name = optim_cfg.OPTIMIZER
    if name == 'adam_onecycle':
        return AdamOneCycle(params, optim_cfg, total_steps)
    if name == 'adam':
        return Adam(params, optim_cfg)
    if name == 'sgd':
        return SGD(params, optim_cfg)
    raise NotImplementedError(f'optimizer {name}: adam_onecycle, adam and sgd are built')
