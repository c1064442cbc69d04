"""Learning-rate schedules and the optimizers of the plain-model trainers
(port of ``sciml_pde_tpu/train/optim.py`` -- ``adaptive_clip``,
``make_lr_schedule``, ``_torch_adam``, ``make_optimizer``,
``make_grouped_optimizer``, ``aux_group_of`` -- and of the optax chain of
``sciml_pde_tpu/train/transformer_train.py::make_transformer_optimizer``).

The FNO production chain (``make_optimizer`` -> ``TorchAdam``), as optax
runs it: adaptive clip to max(5, 0.1 * ||g||) on the global norm ->
g + wd * p -> Adam(0.9, 0.999, 1e-8) -> times -lr(count).  The aux chain
(``make_grouped_optimizer``) is the same with one schedule per parameter
group: the clip sees the global norm over every group, then each group
takes its L2, Adam and learning rate (optax ``multi_transform``).

The transformer chain (``GroupedAdamMultiSteps``), as optax runs it:

  MultiSteps(k)            mean of k micro-batch gradients; the inner chain
                           runs on every k-th call, the rest apply nothing
  clip_by_global_norm(c)   unchanged below c, else g / ||g|| * c
  per parameter group      g + wd * p (L2 before the moments, torch Adam's
                           weight_decay, not AdamW) -> Adam(0.9, 0.999,
                           1e-8) -> times -lr(count), count = applied updates
                           so far (the schedule ticks once per update)

``AdamW`` is optax ``adamw`` (the masked-SSL pretraining and the comparison
trainers): Adam(0.9, 0.999, 1e-8) -> + wd * p (decoupled, after the
moments) -> times -lr(count), with ``clip`` first optax
``clip_by_global_norm(clip)``.  ``AMSGrad`` is the point-set BVP's
reference recipe, optax ``chain(clip_by_global_norm(clip),
add_decayed_weights(wd), scale_by_amsgrad(), scale_by_learning_rate(lr))``:
L2 before the moments, and the running maximum taken of the
bias-corrected second moment (optax's rule; ``torch.optim.Adam(amsgrad=
True)`` maxes the raw one).  ``warmup_cosine_decay_schedule`` is optax's.

``TorchAdam`` and ``GroupedAdamMultiSteps`` share ``adam_update_``.  Each
optimizer's ``optax_tree(state, to_tree)`` is its ``state_dict()`` as the
JAX package's checkpoints hold it -- optax's state tree of the same
chain, nested dicts (named fields) and lists (chain elements) with None
for optax's empty states and masked leaves -- and ``state_from_optax(tree,
to_sd)`` reads one back; ``to_tree`` and ``to_sd`` are the parameters'
layout maps (``utils/weights.py``), which carry each moment as they carry
its parameter (Adam is elementwise).  Schedules are plain functions of
the update count.  The optimizers are plain tensor code (``torch._foreach_*`` over the
parameter lists) that never waits for the device, as in the JAX package,
where they are XLA and not kernels.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

Schedule = Callable[[int], float]
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def _count(n) -> np.ndarray:
    return np.asarray(int(n), np.int32)  # optax's step counts


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _masked(sd: dict, groups: dict[str, list[str]], to_tree) -> dict:
    """{group: the flax tree of ``sd`` with None at every other group's
    parameters} (optax ``masked``'s ``MaskedNode``), the groups found by
    carrying each parameter's group index through ``to_tree``."""
    full = to_tree(sd)
    label = to_tree({n: torch.full(tuple(sd[n].shape), float(i)) for i, names in
                     enumerate(groups.values()) for n in names})
    first = lambda a: float(np.asarray(a).reshape(-1)[0])  # noqa: E731
    return {g: _tree_map(lambda a, lab, i=i: a if first(lab) == i else None, full, label)
            for i, g in enumerate(groups)}


def _merged(trees: list) -> dict:
    return _tree_map(lambda *leaves: next(x for x in leaves if x is not None), *trees)


def _adam(m, v, count) -> dict:
    return {"count": _count(count), "mu": m, "nu": v}


def _partition(state: dict, groups: dict[str, list[str]], to_tree) -> list:
    """optax ``chain(clip, multi_transform({group: chain(L2, adam, lr)}))``'s
    state: an empty clip state, then per group the masked chain's."""
    mu, nu = _masked(state["m"], groups, to_tree), _masked(state["v"], groups, to_tree)
    return [None, {"inner_states": {
        g: {"inner_state": [None, _adam(mu[g], nu[g], state["count"]),
                            {"count": _count(state["count"])}]} for g in groups}}]


def _from_partition(tree, groups, to_sd) -> dict:
    adams = [tree[1]["inner_states"][g]["inner_state"][1] for g in groups]
    return {"m": to_sd(_merged([a["mu"] for a in adams])),
            "v": to_sd(_merged([a["nu"] for a in adams])), "count": int(adams[0]["count"])}


def _wrong_state(kind: str) -> ValueError:
    return ValueError(f"the optimizer state is not the {kind} optimizer's (a run resumes "
                      f"with the optimizer and fast_step setting it started with)")


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


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0,
                                 exponent: float = 1.0) -> Schedule:
    """optax ``warmup_cosine_decay_schedule``: linear from ``init_value`` to
    ``peak_value`` over ``warmup_steps``, then a cosine from the peak to
    ``end_value`` over the remaining ``decay_steps - warmup_steps``."""
    alpha = 0.0 if peak_value == 0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps
    if not cos_steps > 0:
        raise ValueError("The cosine_decay_schedule requires positive decay_steps, got"
                         f" decay_steps={cos_steps}.")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - min(max(count, 0), warmup_steps) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(count - warmup_steps, cos_steps)
        decayed = (1 - alpha) * (0.5 * (1 + math.cos(math.pi * c / cos_steps))) ** exponent
        return peak_value * (decayed + alpha)
    return schedule


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


def with_constant_from(schedule: Schedule, value: float, start: int | None) -> Schedule:
    """optax ``join_schedules([schedule, constant_schedule(value)], [start])``:
    ``schedule`` before update ``start``, ``value`` from it on (the SWA
    window's constant learning rate); ``schedule`` itself when ``start`` is
    None."""
    if start is None:
        return schedule

    def joined(count: int) -> float:
        return schedule(count) if count < start else value
    return joined


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor (optax ``global_norm``).
    On the CPU each tensor's sum of squares is ``torch.sum``'s cascade sum,
    as XLA's reduction: ``_foreach_norm`` keeps one f32 running sum there,
    2.4e-4 off at 9.2M elements.  On the card it is a tree reduction."""
    if tensors and tensors[0].device.type == "cpu":
        return torch.sqrt(torch.stack([torch.sum(t * t) for t in tensors]).sum())
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float
                        ) -> tuple[list[torch.Tensor], torch.Tensor]:
    """optax ``clip_by_global_norm``: the gradients unchanged below
    ``max_norm``, else g / ||g|| * max_norm (no epsilon; not
    ``clip_grad_norm_``), new tensors, and the pre-clip global norm, with no
    wait for the device."""
    g_norm = global_norm(grads)
    inside = g_norm < max_norm
    one = torch.ones_like(g_norm)
    upd = torch._foreach_div(grads, torch.where(inside, one, g_norm))
    torch._foreach_mul_(upd, torch.where(inside, one, torch.full_like(g_norm, max_norm)))
    return upd, g_norm


def adaptive_clip(grads: list[torch.Tensor], floor: float = 5.0,
                  frac: float = 0.1) -> tuple[list[torch.Tensor], torch.Tensor]:
    """``clip_grad_norm_`` with threshold max(floor, frac * ||g||): the
    gradients times min(1, max(floor, frac ||g||) / (||g|| + 1e-12)), and the
    pre-clip global norm, all on the device."""
    g_norm = global_norm(grads)
    clip_value = torch.clamp(frac * g_norm, min=floor)
    scale = torch.clamp(clip_value / (g_norm + 1e-12), max=1.0)
    return torch._foreach_mul(grads, scale), g_norm


@torch.no_grad()
def adam_update_(params: list[torch.Tensor], updates: list[torch.Tensor],
                 m: list[torch.Tensor], v: list[torch.Tensor], count: int, lr: float,
                 weight_decay: float) -> None:
    """One torch-style Adam update in place: u = g + wd * p (L2 before the
    moments, not AdamW), the moments, bias correction at ``count + 1``, and
    p -= lr * mhat / (sqrt(vhat) + eps).  ``updates`` are overwritten."""
    bc1, bc2 = 1.0 - ADAM_B1 ** (count + 1), 1.0 - ADAM_B2 ** (count + 1)
    torch._foreach_add_(updates, params, alpha=weight_decay)
    torch._foreach_mul_(m, ADAM_B1)
    torch._foreach_add_(m, updates, alpha=1.0 - ADAM_B1)
    torch._foreach_mul_(v, ADAM_B2)
    torch._foreach_addcmul_(v, updates, updates, value=1.0 - ADAM_B2)
    mhat = torch._foreach_div(m, bc1)
    den = torch._foreach_div(v, bc2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, ADAM_EPS)
    torch._foreach_div_(mhat, den)
    torch._foreach_add_(params, mhat, alpha=-lr)


class TorchAdam:
    """The FNO production optimizer on named parameters, in place (port of
    ``_torch_adam``, and of ``make_grouped_optimizer``'s chain): ``groups``
    maps each group to its parameter names and ``schedules`` to its
    learning-rate schedule.  ``step(params, grads)`` clips the gradients
    adaptively on their global norm, then per group adds ``weight_decay *
    p``, applies Adam and the learning rate ``schedules[group](count)`` read
    before the count advances, and returns the pre-clip global norm."""

    def __init__(self, params: dict[str, torch.Tensor], groups: dict[str, list[str]],
                 schedules: dict[str, Schedule], weight_decay: float = 1e-4):
        self.names = list(params)
        if sorted(n for g in groups.values() for n in g) != sorted(self.names):
            raise ValueError("the groups must cover every parameter exactly once")
        self.groups, self.schedules = groups, schedules
        self.weight_decay = float(weight_decay)
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor]):
        upd, g_norm = adaptive_clip([grads[n] for n in self.names])
        by_name = dict(zip(self.names, upd))
        for group, names in self.groups.items():
            if names:
                adam_update_([params[n] for n in names], [by_name[n] for n in names],
                             [self.m[n] for n in names], [self.v[n] for n in names],
                             self.count, self.schedules[group](self.count), self.weight_decay)
        self.count += 1
        return g_norm

    def state_dict(self) -> dict:
        return {"m": dict(self.m), "v": dict(self.v), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        if not isinstance(state.get("m"), dict):
            raise _wrong_state("production")
        for key in ("m", "v"):
            for n, t in state[key].items():
                getattr(self, key)[n].copy_(t)
        self.count = int(state["count"])

    def optax_tree(self, state: dict, to_tree) -> list:
        """optax's state of ``_torch_adam`` (one group) -- (clip, L2,
        ScaleByAdamState, ScaleByScheduleState) -- or of
        ``make_grouped_optimizer``'s chain."""
        if list(self.groups) == ["all"]:
            return [None, None, _adam(to_tree(state["m"]), to_tree(state["v"]), state["count"]),
                    {"count": _count(state["count"])}]
        return _partition(state, self.groups, to_tree)

    def state_from_optax(self, tree, to_sd) -> dict:
        try:
            if list(self.groups) == ["all"]:
                if len(tree) != 4:
                    raise _wrong_state("production")
                a = tree[2]
                return {"m": to_sd(a["mu"]), "v": to_sd(a["nu"]), "count": int(a["count"])}
            return _from_partition(tree, self.groups, to_sd)
        except (KeyError, IndexError, TypeError):
            raise _wrong_state("production") from None


def make_optimizer(params: dict[str, torch.Tensor], learning_rate: float, total_steps: int,
                   scheduler: str = "cosine", weight_decay: float = 1e-4,
                   scheduler_step: int = 100, scheduler_gamma: float = 0.5) -> TorchAdam:
    """The single-group production optimizer of the baseline FNO trainer."""
    sched = make_lr_schedule(scheduler, learning_rate, total_steps, scheduler_step,
                             scheduler_gamma)
    return TorchAdam(params, {"all": list(params)}, {"all": sched}, weight_decay)


def make_grouped_optimizer(params: dict[str, torch.Tensor], group_of: Callable[[tuple], str],
                           learning_rates: dict[str, float], total_steps: int,
                           scheduler: str = "cosine", weight_decay: float = 1e-4,
                           scheduler_step: int = 100,
                           scheduler_gamma: float = 0.5) -> TorchAdam:
    """Per-group learning rates: ``group_of`` maps a parameter's path (its
    name split at the dots) to a group of ``learning_rates``, each group
    with its own schedule of the same kind.  The adaptive clip stays on the
    global norm, before the partition, as the reference clips."""
    groups: dict[str, list[str]] = {g: [] for g in learning_rates}
    for n in params:
        groups[group_of(tuple(n.split(".")))].append(n)
    schedules = {g: make_lr_schedule(scheduler, lr, total_steps, scheduler_step,
                                     scheduler_gamma) for g, lr in learning_rates.items()}
    return TorchAdam(params, groups, schedules, weight_decay)


def aux_group_of(path: tuple) -> str:
    """FNO2dAux parameter path -> ``shared``, ``primary_head`` or ``aux_head``."""
    top = str(path[0]) if path else ""
    if top.startswith("fc2_primary"):
        return "primary_head"
    if top.startswith("fc2_auxiliary"):
        return "aux_head"
    return "shared"


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
        upd, _ = clip_by_global_norm(acc, self.clip)
        by_name = dict(zip(self.names, upd))
        for group, names in self.groups.items():
            if not names:
                continue
            adam_update_([params[n] for n in names], [by_name[n] for n in names],
                         [self.m[n] for n in names], [self.v[n] for n in names], self.count,
                         self.schedules[group](self.count), self.weight_decay)
        for a in acc:
            a.zero_()
        self.count += 1
        return True

    def state_dict(self) -> dict:
        return {"m": dict(self.m), "v": dict(self.v), "acc": dict(self.acc),
                "count": self.count, "mini_step": self.mini_step}

    def load_state_dict(self, state: dict) -> None:
        for key in ("m", "v", "acc"):
            for n, t in state[key].items():
                getattr(self, key)[n].copy_(t)
        self.count, self.mini_step = int(state["count"]), int(state["mini_step"])

    def optax_tree(self, state: dict, to_tree):
        """optax's state of ``make_transformer_optimizer``'s chain, inside
        ``MultiStepsState`` where ``grad_accum`` > 1."""
        inner = _partition(state, self.groups, to_tree)
        if self.k == 1:
            return inner
        return {"mini_step": _count(state["mini_step"]), "gradient_step": _count(state["count"]),
                "inner_opt_state": inner, "acc_grads": to_tree(state["acc"]), "skip_state": ()}

    def state_from_optax(self, tree, to_sd) -> dict:
        try:
            if self.k == 1:
                if not isinstance(tree, list):
                    raise _wrong_state("transformer")
                st = _from_partition(tree, self.groups, to_sd)
                return dict(st, acc={n: torch.zeros_like(t) for n, t in st["m"].items()},
                            mini_step=0)
            st = _from_partition(tree["inner_opt_state"], self.groups, to_sd)
            return dict(st, acc=to_sd(tree["acc_grads"]), mini_step=int(tree["mini_step"]))
        except (KeyError, IndexError, TypeError):
            raise _wrong_state("transformer") from None


class AdamW:
    """optax ``adamw(schedule, weight_decay=wd)`` on named parameters, in
    place: the Adam moments of the raw gradients, bias correction at
    ``count + 1``, then p -= lr(count) * (mhat / (sqrt(vhat) + eps) + wd * p)
    on every parameter.  ``clip``: optax ``clip_by_global_norm(clip)``
    before it (the comparison trainers' chain)."""

    def __init__(self, params: dict[str, torch.Tensor], schedule: Schedule,
                 weight_decay: float = 1e-4, clip: float | None = None):
        self.names, self.schedule = list(params), schedule
        self.weight_decay, self.clip = float(weight_decay), clip
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor]) -> None:
        p = [params[n] for n in self.names]
        g = [grads[n] for n in self.names]
        if self.clip is not None:
            g, _ = clip_by_global_norm(g, self.clip)
        m, v = [self.m[n] for n in self.names], [self.v[n] for n in self.names]
        bc1, bc2 = 1.0 - ADAM_B1 ** (self.count + 1), 1.0 - ADAM_B2 ** (self.count + 1)
        torch._foreach_mul_(m, ADAM_B1)
        torch._foreach_add_(m, g, alpha=1.0 - ADAM_B1)
        torch._foreach_mul_(v, ADAM_B2)
        torch._foreach_addcmul_(v, g, g, value=1.0 - ADAM_B2)
        upd = torch._foreach_div(m, bc1)
        den = torch._foreach_div(v, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, ADAM_EPS)
        torch._foreach_div_(upd, den)
        torch._foreach_add_(upd, p, alpha=self.weight_decay)
        torch._foreach_add_(p, upd, alpha=-self.schedule(self.count))
        self.count += 1

    def state_dict(self) -> dict:
        return {"m": dict(self.m), "v": dict(self.v), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        for key in ("m", "v"):
            for n, t in state[key].items():
                getattr(self, key)[n].copy_(t)
        self.count = int(state["count"])

    def optax_tree(self, state: dict, to_tree) -> list:
        """optax ``adamw``'s state: (ScaleByAdamState, the decay's empty
        state, ScaleByScheduleState); under ``clip`` the clip's empty state
        comes first, as in ``chain(clip_by_global_norm, adamw)``."""
        tree = [_adam(to_tree(state["m"]), to_tree(state["v"]), state["count"]), None,
                {"count": _count(state["count"])}]
        return tree if self.clip is None else [None, tree]

    def state_from_optax(self, tree, to_sd) -> dict:
        try:
            a = (tree if self.clip is None else tree[1])[0]
            return {"m": to_sd(a["mu"]), "v": to_sd(a["nu"]), "count": int(a["count"])}
        except (KeyError, IndexError, TypeError):
            raise _wrong_state("AdamW") from None


class AMSGrad:
    """optax ``chain(clip_by_global_norm(clip), add_decayed_weights(wd),
    scale_by_amsgrad(), scale_by_learning_rate(schedule))`` on named
    parameters, in place (no clip where ``clip`` is None): u = g + wd * p,
    the moments of u, bias correction at ``count + 1``, vmax = max(vmax,
    vhat) of the bias-corrected second moment, p -= lr(count) * mhat /
    (sqrt(vmax) + eps)."""

    def __init__(self, params: dict[str, torch.Tensor], schedule: Schedule,
                 weight_decay: float = 1e-4, clip: float | None = None):
        self.names, self.schedule = list(params), schedule
        self.weight_decay, self.clip = float(weight_decay), clip
        zeros = lambda: {n: torch.zeros_like(p) for n, p in params.items()}  # noqa: E731
        self.m, self.v, self.v_max = zeros(), zeros(), zeros()
        self.count = 0

    @torch.no_grad()
    def step(self, params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor]) -> None:
        p = [params[n] for n in self.names]
        g = [grads[n] for n in self.names]
        if self.clip is not None:
            g, _ = clip_by_global_norm(g, self.clip)
        u = torch._foreach_add(g, p, alpha=self.weight_decay)
        m, v = [self.m[n] for n in self.names], [self.v[n] for n in self.names]
        v_max = [self.v_max[n] for n in self.names]
        bc1, bc2 = 1.0 - ADAM_B1 ** (self.count + 1), 1.0 - ADAM_B2 ** (self.count + 1)
        torch._foreach_mul_(m, ADAM_B1)
        torch._foreach_add_(m, u, alpha=1.0 - ADAM_B1)
        torch._foreach_mul_(v, ADAM_B2)
        torch._foreach_addcmul_(v, u, u, value=1.0 - ADAM_B2)
        torch._foreach_maximum_(v_max, torch._foreach_div(v, bc2))
        upd = torch._foreach_div(m, bc1)
        den = torch._foreach_sqrt(v_max)
        torch._foreach_add_(den, ADAM_EPS)
        torch._foreach_div_(upd, den)
        torch._foreach_add_(p, upd, alpha=-self.schedule(self.count))
        self.count += 1
