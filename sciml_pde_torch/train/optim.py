"""Learning-rate schedules and the transformer trainers' optimizer (port of
``sciml_pde_tpu/train/optim.py::make_lr_schedule`` and the optax chain of
``sciml_pde_tpu/train/transformer_train.py::make_transformer_optimizer``).

The chain, as optax runs it:

  MultiSteps(k)            mean of k micro-batch gradients; the inner chain
                           runs on every k-th call, the rest apply nothing
  clip_by_global_norm(c)   unchanged below c, else g / ||g|| * c
  per parameter group      g + wd * p (L2 before the moments, torch Adam's
                           weight_decay, not AdamW) -> Adam(0.9, 0.999,
                           1e-8) -> times -lr(count), count = applied updates
                           so far (the schedule ticks once per update)

Schedules are plain functions of the update count.  The optimizer is plain
tensor code (``torch._foreach_*`` over the parameter lists), as in the JAX
package, where it is XLA and not a kernel.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

Schedule = Callable[[int], float]
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def make_lr_schedule(kind: str, learning_rate: float, total_steps: int,
                     scheduler_step: int = 100, scheduler_gamma: float = 0.5) -> Schedule:
    """``cosine``: optax ``cosine_decay_schedule(lr, total_steps)``;
    ``step``: ``exponential_decay(lr, scheduler_step, scheduler_gamma,
    staircase=True)``."""
    if kind == "cosine":
        decay_steps = max(total_steps, 1)

        def cosine(count: int) -> float:
            c = min(count, decay_steps)
            return learning_rate * 0.5 * (1.0 + math.cos(math.pi * c / decay_steps))
        return cosine
    if kind == "step":
        def step(count: int) -> float:
            return learning_rate * scheduler_gamma ** (count // scheduler_step)
        return step
    raise ValueError(f"unknown scheduler {kind!r}")


def with_warmup(schedule: Schedule, learning_rate: float, warmup_steps: int) -> Schedule:
    """optax ``join_schedules([linear_schedule(0, lr, warmup), schedule],
    [warmup])``: linear from 0 over ``warmup_steps``, then ``schedule``
    counted from the boundary."""
    if warmup_steps <= 0:
        return schedule

    def joined(count: int) -> float:
        if count < warmup_steps:
            return learning_rate * count / warmup_steps
        return schedule(count - warmup_steps)
    return joined


class GroupedAdamMultiSteps:
    """The transformer optimizer on named parameters, in place.

    ``groups`` maps each group name to its parameter names and
    ``schedules`` maps it to its learning-rate schedule.  ``step(params,
    grads)`` takes one micro-batch's gradients (dicts of tensors by name),
    accumulates their mean, and on every ``grad_accum``-th call clips the
    mean on its global norm, applies L2 and Adam per group and updates
    ``params``.  Returns True when it updated."""

    def __init__(self, params: dict[str, torch.Tensor], groups: dict[str, list[str]],
                 schedules: dict[str, Schedule], clip: float, weight_decay: float,
                 grad_accum: int = 1):
        self.groups, self.schedules = groups, schedules
        self.clip, self.weight_decay = float(clip), float(weight_decay)
        self.k = max(int(grad_accum), 1)
        self.names = [n for g in groups.values() for n in g]
        if sorted(self.names) != sorted(params):
            raise ValueError("the groups must cover every parameter exactly once")
        zeros = lambda: {n: torch.zeros_like(params[n]) for n in self.names}  # noqa: E731
        self.m, self.v, self.acc = zeros(), zeros(), zeros()
        self.count = 0       # updates applied (Adam's step and the schedules')
        self.mini_step = 0   # micro-batches accumulated towards the next update

    @torch.no_grad()
    def step(self, params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor]) -> bool:
        acc = [self.acc[n] for n in self.names]
        g = [grads[n] for n in self.names]
        # running mean, optax's acc + (g - acc) / (n + 1)
        diff = torch._foreach_sub(g, acc)
        torch._foreach_div_(diff, float(self.mini_step + 1))
        torch._foreach_add_(acc, diff)
        if self.mini_step < self.k - 1:
            self.mini_step += 1
            return False
        self.mini_step = 0
        g_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(acc)))
        # clip_by_global_norm: select(g_norm < c, g, g / g_norm * c), no sync
        inside = g_norm < self.clip
        div = torch.where(inside, torch.ones_like(g_norm), g_norm)
        mul = torch.where(inside, torch.ones_like(g_norm), torch.full_like(g_norm, self.clip))
        upd = torch._foreach_div(acc, div)
        torch._foreach_mul_(upd, mul)
        count = self.count + 1
        bc1, bc2 = 1.0 - ADAM_B1 ** count, 1.0 - ADAM_B2 ** count
        by_name = dict(zip(self.names, upd))
        for group, names in self.groups.items():
            if not names:
                continue
            p = [params[n] for n in names]
            u = [by_name[n] for n in names]
            m = [self.m[n] for n in names]
            v = [self.v[n] for n in names]
            torch._foreach_add_(u, p, alpha=self.weight_decay)
            torch._foreach_mul_(m, ADAM_B1)
            torch._foreach_add_(m, u, alpha=1.0 - ADAM_B1)
            torch._foreach_mul_(v, ADAM_B2)
            torch._foreach_addcmul_(v, u, u, value=1.0 - ADAM_B2)
            mhat = torch._foreach_div(m, bc1)
            den = torch._foreach_div(v, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, ADAM_EPS)
            torch._foreach_div_(mhat, den)
            torch._foreach_add_(p, mhat, alpha=-self.schedules[group](self.count))
        for a in acc:
            a.zero_()
        self.count = count
        return True

    def state_dict(self) -> dict:
        return {"m": dict(self.m), "v": dict(self.v), "acc": dict(self.acc),
                "count": self.count, "mini_step": self.mini_step}

    def load_state_dict(self, state: dict) -> None:
        for key in ("m", "v", "acc"):
            for n, t in state[key].items():
                getattr(self, key)[n].copy_(t)
        self.count, self.mini_step = int(state["count"]), int(state["mini_step"])
