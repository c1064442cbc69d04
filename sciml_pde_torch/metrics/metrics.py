"""Training loss (port of ``sciml_pde_tpu/metrics/metrics.py::nrmse_loss``).

The six-metric evaluation suite is not ported yet.
"""

from __future__ import annotations

import torch


def nrmse_loss(output: torch.Tensor, tar: torch.Tensor) -> torch.Tensor:
    """Per-sample nRMSE^2 averaged over the batch: the mean squared residual
    over dims (1, 2, 3), normalised by the target power over the same dims
    plus 1e-7.  Works for (B, X, Y, T, C)."""
    dims = (1, 2, 3)
    residuals = output - tar
    tar_norm = 1e-7 + (tar * tar).mean(dim=dims, keepdim=True)
    raw = (residuals * residuals).mean(dim=dims, keepdim=True) / tar_norm
    return raw.mean()
