"""Optimizer and learning-rate schedules: the twin of the optax chain that
``vsta_tpu/training/optim.py`` builds.

* ``Adam``: weight decay as an L2 term ahead of Adam
  (``add_decayed_weights`` then ``adam``), which is ``torch.optim.Adam``'s
  ``weight_decay``; ``adamw``: the decoupled decay of ``torch.optim.AdamW``.
  b1 0.9, b2 0.999, eps 1e-8, as optax's defaults.
* ``TRAIN.FREEZE_BACKBONE``: the backbone's parameters get no update at
  all, not even the decay (optax ``set_to_zero``).
* ``TRAIN.ACCUM_STEPS`` k > 1: ``optax.MultiSteps`` semantics. Every call
  folds the gradients into a running mean; every k-th call applies the
  inner update with that mean and starts a new one.
* The schedule is evaluated at the inner optimizer's update count, not at
  the number of calls: with accumulation, ``cosine_warm``'s "epoch" is
  ``updates // steps_per_epoch``, as in the reference.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict

import torch
from torch import nn

from ..config import Config

FROZEN_PREFIX = "encoder.backbone."


def lr_schedule(cfg: Config, steps_per_epoch: int) -> Callable[[int], float]:
    """The learning rate as a function of the inner update count."""
    base = cfg.train.lr
    name = cfg.train.lr_scheduler
    epochs = max(1, cfg.train.epochs)
    spe = max(1, steps_per_epoch)

    if name == "step":  # StepLR(step_size=10 epochs, gamma=0.5), staircase
        return lambda count: base * 0.5 ** (count // (10 * spe))

    if name == "cosine_warm":  # warmup x cosine, both per epoch
        warm = max(1, cfg.train.warmup_epochs)
        total = max(1, epochs - warm)

        def sched(count: int) -> float:
            epoch = count // spe
            warm_f = min((epoch + 1) / warm, 1.0)
            cos_f = 0.5 * (1.0 + math.cos(math.pi * min(epoch, total) / total))
            return base * warm_f * cos_f

        return sched

    decay = epochs * spe  # plain cosine over all epochs
    return lambda count: base * 0.5 * (1.0 + math.cos(math.pi * min(count, decay) / decay))


@dataclass
class OptState:
    """The optimizer's state beside the model's parameters."""

    inner: torch.optim.Optimizer  # Adam/AdamW over the trainable parameters
    acc: Dict[str, torch.Tensor]  # running mean of the gradients (ACCUM_STEPS > 1)
    mini_step: int = 0  # calls since the last update
    count: int = 0  # inner updates so far: the schedule's count


class Optimizer:
    """``build_optimizer``'s chain, applied in place to a model's parameters."""

    def __init__(self, cfg: Config, steps_per_epoch: int):
        t = cfg.train
        self.schedule = lr_schedule(cfg, steps_per_epoch)
        self.adamw = t.opt.lower() == "adamw"
        self.weight_decay = t.weight_decay
        self.accum_steps = max(1, t.accum_steps)
        self.freeze_backbone = t.freeze_backbone

    def trainable(self, name: str) -> bool:
        return not (self.freeze_backbone and name.startswith(FROZEN_PREFIX))

    def init(self, model: nn.Module) -> OptState:
        named = [(n, p) for n, p in model.named_parameters() if self.trainable(n)]
        cls = torch.optim.AdamW if self.adamw else torch.optim.Adam
        inner = cls(
            [p for _, p in named], lr=self.schedule(0), betas=(0.9, 0.999), eps=1e-8,
            weight_decay=self.weight_decay,
        )
        acc = {n: torch.zeros_like(p) for n, p in named} if self.accum_steps > 1 else {}
        return OptState(inner=inner, acc=acc)

    @torch.no_grad()
    def update(self, state: OptState, model: nn.Module, grads: Dict[str, torch.Tensor]) -> bool:
        """One call with one mini-batch's gradients (every parameter's, zeros
        where it had none). Returns True when the parameters moved."""
        named = [(n, p) for n, p in model.named_parameters() if self.trainable(n)]
        k = state.mini_step
        accs = [state.acc[n] for n, _ in named] if self.accum_steps > 1 else []
        if accs:  # acc += (g - acc) / (k + 1), as MultiSteps' running mean
            step = torch._foreach_sub([grads[n] for n, _ in named], accs)
            torch._foreach_div_(step, float(k + 1))
            torch._foreach_add_(accs, step)
        state.mini_step = (k + 1) % self.accum_steps
        if state.mini_step != 0:
            return False
        for n, p in named:
            # every parameter gets a gradient, zero where the loss does not
            # reach it: Adam skips a parameter whose .grad is None, but the
            # reference's L2 term still moves it
            p.grad = state.acc[n] if self.accum_steps > 1 else grads[n]
        for group in state.inner.param_groups:
            group["lr"] = self.schedule(state.count)
        state.inner.step()
        state.count += 1
        for _, p in named:
            p.grad = None
        if accs:
            torch._foreach_zero_(accs)
        return True


def build_optimizer(cfg: Config, steps_per_epoch: int) -> Optimizer:
    """The optimizer for ``cfg``; ``init(model)`` gives its state."""
    return Optimizer(cfg, steps_per_epoch)
