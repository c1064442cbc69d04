"""Autoregressive rollout evaluation (port of ``sciml_pde_tpu/eval/rollout.py``).

Seed with the first ``initial_step`` frames of each test window, feed
``rollout_test`` predictions back, and score them with the six PDEBench
metrics, batch by batch.  Where JAX scans a jitted carry, the port loops:
each step is one model call on the device.  Per-batch results are summed
on the host as float64 and divided by the number of batches, as in JAX, so
a ragged last batch weighs as much as a full one.
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch

from sciml_pde_torch.data.windows import WindowedTrajectories, gather_windows
from sciml_pde_torch.metrics import metric_func

METRIC_NAMES = ("RMSE", "nRMSE", "CSV", "Max", "BD", "F")
CONVENTIONS = ("joint_final", "joint_all", "perch_final", "perch_all")


def rollout_predict(apply_fn: Callable, x0: torch.Tensor, grid: torch.Tensor,
                    steps: int) -> torch.Tensor:
    """Roll the one-step operator ``apply_fn(x, grid) -> (B, *spatial, 1, C)``
    ``steps`` times, each prediction sliding into the window.  Returns every
    prediction along the time axis: (B, *spatial, steps, C)."""
    xx, preds = x0, []
    for _ in range(steps):
        pred = apply_fn(xx, grid)
        xx = torch.cat([xx[..., 1:, :], pred], dim=-2)
        preds.append(pred)
    return torch.cat(preds, dim=-2)


def _batches(apply_fn, test: WindowedTrajectories, rollout_test: int, params, batch_size):
    """Per test batch: (predictions (B, *sp, R, C), targets (B, *sp, R, C))."""
    fn = apply_fn if params is None else functools.partial(apply_fn, params)
    idx = torch.as_tensor(test.window_index(), dtype=torch.long, device=test.data.device)
    for b in range(0, len(idx), batch_size):
        x, y = gather_windows(test.data, idx[b:b + batch_size], test.initial_step,
                              rollout_test)
        gb = test.grid.expand(x.shape[0], *test.grid.shape)
        yield rollout_predict(fn, x.float(), gb, rollout_test), y.float()


@torch.no_grad()
def convention_table(apply_fn: Callable, test: WindowedTrajectories, rollout_test: int,
                     params=None, batch_size: int = 8) -> dict[str, list[float]]:
    """Rollout-k nRMSE under the four published metric conventions, for k =
    1 .. ``rollout_test``: normalised jointly over (spatial, C) or per
    channel, on the k-th step only or on all k steps.  Returns
    ``{joint_final, joint_all, perch_final, perch_all}`` -> list over k,
    averaged over the test batches."""
    def joint(pred, tgt, axes):
        mse = (pred - tgt).square().mean(dim=axes)
        den = tgt.square().mean(dim=axes) + 1e-7
        return (torch.sqrt(mse) / torch.sqrt(den)).mean()

    def perch(pred, tgt, axes):
        rmse = torch.sqrt((pred - tgt).square().mean(dim=axes))
        den = torch.sqrt(tgt.square().mean(dim=axes)) + 1e-7
        return (rmse / den).mean()

    sums = {k: np.zeros(rollout_test) for k in CONVENTIONS}
    nb = 0
    for preds, y in _batches(apply_fn, test, rollout_test, params, batch_size):
        sp = tuple(range(1, preds.ndim - 2))
        t_ax, c_ax = preds.ndim - 2, preds.ndim - 1
        rows = {k: [] for k in CONVENTIONS}
        for k in range(rollout_test):
            pf, tf = preds[..., k, :], y[..., k, :]
            pa, ta = preds[..., :k + 1, :], y[..., :k + 1, :]
            rows["joint_final"].append(joint(pf, tf, sp + (t_ax,)))
            rows["perch_final"].append(perch(pf, tf, sp))
            rows["joint_all"].append(joint(pa, ta, sp + (t_ax, c_ax)))
            rows["perch_all"].append(perch(pa, ta, sp + (t_ax,)))
        for k, v in rows.items():
            sums[k] += torch.stack(v).cpu().numpy()
        nb += 1
    return {k: (v / max(nb, 1)).tolist() for k, v in sums.items()}


@torch.no_grad()
def evaluate_rollout(apply_fn: Callable, test: WindowedTrajectories, rollout_test: int,
                     batch_size: int = 8, iLow: int = 4, iHigh: int = 12, params=None,
                     score: str = "final") -> dict:
    """The six metrics of the rollout over the test split, and ``mse_time``,
    the RMSE of each unrolled step.

    ``score="final"`` (the FNO tables) scores the last unrolled step against
    the last target frame; ``"all_steps"`` (the transformer tables) scores
    all unrolled frames.  With ``params``, ``apply_fn(params, x, grid)`` is
    called."""
    if score not in ("final", "all_steps"):
        raise ValueError(f"unknown score {score!r}")
    sums = np.zeros(len(METRIC_NAMES))
    mse_time_sum = np.zeros(rollout_test)
    nb = 0
    for preds, y in _batches(apply_fn, test, rollout_test, params, batch_size):
        if score == "final":
            pred_s, tar_s = preds[..., -1:, :], y[..., -1:, :]
        else:
            pred_s, tar_s = preds, y
        sq = (preds - y).square()
        mse_time = torch.sqrt(sq.mean(dim=tuple(i for i in range(sq.ndim) if i != sq.ndim - 2)))
        vals = metric_func(pred_s, tar_s, if_mean=True, iLow=iLow, iHigh=iHigh)
        sums += np.array([float(v) for v in vals])
        mse_time_sum += mse_time.cpu().numpy()
        nb += 1
    out = {k: v / nb for k, v in zip(METRIC_NAMES, sums)}
    out["mse_time"] = (mse_time_sum / nb).tolist()
    return out
