"""Shared model building blocks (port of ``sciml_pde_tpu/models/common.py``)."""

from __future__ import annotations

import math

import torch
from torch import nn


def torch_linear(fan_in: int, fan_out: int, generator: torch.Generator | None = None) -> nn.Linear:
    """``nn.Linear`` with PyTorch's default init, U(-k, k), k = 1/sqrt(fan_in),
    for weight and bias, drawn from ``generator``."""
    lin = nn.Linear(fan_in, fan_out)
    k = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        lin.weight.uniform_(-k, k, generator=generator)
        lin.bias.uniform_(-k, k, generator=generator)
    return lin


@torch.no_grad()
def instance_norm_stats(x: torch.Tensor, dims: tuple[int, ...]):
    """Per-sample, per-channel (std, mean), outside the autograd graph:
    unbiased std (ddof=1) over ``dims`` plus 1e-7, as the reference FNO
    normalisation under ``no_grad``."""
    mean = x.mean(dim=dims, keepdim=True)
    std = x.std(dim=dims, keepdim=True, correction=1) + 1e-7
    return std, mean


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, torch ``F.gelu``'s default."""
    return torch.nn.functional.gelu(x, approximate="none")
