"""Rollout experiment: score nRMSE at multiple horizons (port of
``sciml_pde_tpu/eval/rollout_experiment.py``; reference ``Rollout
Experiment/``, the rows ``Plot Generator/rollout.py`` tabulates).

Rollout predictions are prefix-identical across horizons, and horizon k is
scored by the six metrics on step k, so one max-horizon rollout per test
batch scores every horizon.  Per-batch results are summed on the host in
float64 and divided by the number of batches, as JAX does.
"""

from __future__ import annotations

import functools
import json
from pathlib import Path

import numpy as np
import torch

from sciml_pde_torch._device import resolve_device
from sciml_pde_torch.data.windows import gather_windows
from sciml_pde_torch.eval.rollout import METRIC_NAMES, rollout_predict
from sciml_pde_torch.metrics import metric_func
from sciml_pde_torch.ops.fno_fused_step import fno2d_fused_apply


def fused_fno_apply(p, x: torch.Tensor, grid: torch.Tensor, modes: int) -> torch.Tensor:
    """``fno2d_fused_apply`` (the hand-written FNO forward kernels on the
    card) on packed parameters ``p``, in the model-facing layout: x (B, X,
    Y, T, C), grid (B, X, Y, 2) -> (B, X, Y, 1, C), as a rollout's
    ``apply_fn(p, x, grid)`` with ``modes`` bound."""
    win = x.permute(0, 3, 4, 1, 2)
    pred = fno2d_fused_apply(win, grid[0].permute(2, 0, 1), p, modes, modes)
    return pred.permute(0, 2, 3, 1)[..., None, :]


@torch.no_grad()
def rollout_study_fused(
    apply_fn,
    params,
    test_w,
    horizons=(1, 2, 3, 4, 5),
    batch_size: int = 4,
    iLow: int = 4,
    iHigh: int = 12,
    out_path: str | Path | None = None,
    device=None,
) -> dict[int, dict[str, float]]:
    """All horizons from one max-horizon rollout per batch.  ``apply_fn(x,
    grid)``, or ``apply_fn(params, x, grid)`` where ``params`` is not None
    (a module's forward, or ``ops/fno_fused_step.py::fno2d_fused_apply`` on
    packed parameters).  Returns {k: six metrics and ``mse_time``, the RMSE
    of steps 1..k}; writes them as JSON to ``out_path``."""
    dev = resolve_device(device)
    horizons = sorted(int(k) for k in horizons)
    max_h = horizons[-1]
    idx_np = test_w.window_index()
    initial_step = test_w.initial_step
    # only the frames a window can touch go to the device
    span = int(idx_np[:, 1].max()) + initial_step + max_h if len(idx_np) else 0
    data = test_w.data[:, :span].to(dev)
    grid = test_w.grid.to(dev)
    idx = torch.as_tensor(idx_np, dtype=torch.long, device=dev)
    fn = functools.partial(apply_fn, params) if params is not None else apply_fn

    sums = np.zeros((len(horizons), len(METRIC_NAMES)))
    mse_time_sum = np.zeros(max_h)
    nb = 0
    for b in range(0, len(idx), batch_size):
        chunk = idx[b : b + batch_size]
        x, y = gather_windows(data, chunk, initial_step, max_h)
        x, y = x.float(), y.float()
        gb = grid.expand(chunk.shape[0], *grid.shape)
        preds = rollout_predict(fn, x, gb, max_h)
        per_h = [metric_func(preds[..., k - 1 : k, :], y[..., k - 1 : k, :],
                             if_mean=True, iLow=iLow, iHigh=iHigh) for k in horizons]
        sq = (preds - y).square()
        mse_time = torch.sqrt(sq.mean(dim=tuple(i for i in range(sq.ndim) if i != sq.ndim - 2)))
        sums += np.array([[float(v) for v in vals] for vals in per_h])
        mse_time_sum += mse_time.cpu().numpy()
        nb += 1
    mse_time = (mse_time_sum / nb).tolist()
    results = {
        k: {**dict(zip(METRIC_NAMES, sums[i] / nb)), "mse_time": mse_time[:k]}
        for i, k in enumerate(horizons)
    }
    for k in horizons:
        print(f"rollout {k}: nRMSE={results[k]['nRMSE']:.6f}", flush=True)
    if out_path is not None:
        Path(out_path).write_text(json.dumps(results, indent=1))
    return results


def rollout_study(
    apply_fn,
    params,
    test_w,
    horizons=(1, 2, 3, 4, 5),
    batch_size: int = 4,
    iLow: int = 4,
    iHigh: int = 12,
    out_path: str | Path | None = None,
    device=None,
) -> dict[int, dict[str, float]]:
    """nRMSE (and the other five metrics) at each rollout horizon, from one
    rollout per batch (``rollout_study_fused``)."""
    return rollout_study_fused(
        apply_fn, params, test_w, horizons=horizons, batch_size=batch_size,
        iLow=iLow, iHigh=iHigh, out_path=out_path, device=device,
    )
