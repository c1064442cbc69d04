"""2D Fourier Neural Operators, baseline and two-head (port of
``FNO2d`` and ``FNO2dAux`` in ``sciml_pde_tpu/models/fno.py``).

The plain models: what the production and aux steps train, the reference
the fused step is held against, and the form checkpoints take
(``utils/weights.py`` converts between their ``state_dict``, the flax
parameter tree and the fused step's packed parameters).

Call signature as the JAX package's: ``(x: [B,X,Y,T,C], grid: [B,X,Y,2])
-> [B,X,Y,1,C]``, channels-last throughout.  ``impl`` picks the spectral
conv's form; None means the module default of ``ops/spectral.py`` (``dft2``
unless ``SCIML_SPECTRAL_IMPL`` says otherwise), as in the flax model.  The
dense layers are f32 products.  ``remat`` (rematerialised blocks) is not
ported: ``remat=True`` raises (ROADMAP A4).
"""

from __future__ import annotations

import torch
from torch import nn

from sciml_pde_torch.models.common import gelu, instance_norm_stats, torch_linear
from sciml_pde_torch.ops.spectral import spectral_conv_2d, spectral_weight_init


class SpectralConv2d(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, modes1: int, modes2: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.modes1, self.modes2 = modes1, modes2
        self.w1 = nn.Parameter(spectral_weight_init(in_channels, out_channels, modes1,
                                                    modes2, generator))
        self.w2 = nn.Parameter(spectral_weight_init(in_channels, out_channels, modes1,
                                                    modes2, generator))

    def forward(self, x: torch.Tensor, impl: str | None = None) -> torch.Tensor:
        return spectral_conv_2d(x, self.w1, self.w2, self.modes1, self.modes2, impl)


class FNOBackbone2d(nn.Module):
    """Lift -> pad -> 4 x (spectral + pointwise) -> unpad -> project to 128."""

    def __init__(self, in_features: int, modes1: int, modes2: int, width: int,
                 padding: int = 2, generator: torch.Generator | None = None):
        super().__init__()
        self.padding = padding
        self.fc0 = torch_linear(in_features, width, generator)
        self.convs = nn.ModuleList(
            SpectralConv2d(width, width, modes1, modes2, generator) for _ in range(4)
        )
        self.ws = nn.ModuleList(torch_linear(width, width, generator) for _ in range(4))
        self.fc1 = torch_linear(width, 128, generator)

    def forward(self, x: torch.Tensor, impl: str | None = None) -> torch.Tensor:
        nx, ny = x.shape[1], x.shape[2]
        x = self.fc0(x)
        x = nn.functional.pad(x, (0, 0, 0, self.padding, 0, self.padding))
        for i in range(4):
            x = self.convs[i](x, impl) + self.ws[i](x)
            if i < 3:
                x = gelu(x)
        x = x[:, :nx, :ny]
        return gelu(self.fc1(x))


def _prep_2d(x: torch.Tensor, grid: torch.Tensor):
    """Normalise per sample and channel over (X, Y, T) and build the lift input."""
    std, mean = instance_norm_stats(x, (1, 2, 3))
    xn = (x - mean) / std
    b, nx, ny = xn.shape[:3]
    return torch.cat([xn.reshape(b, nx, ny, -1), grid], dim=-1), std, mean


def _denorm(out: torch.Tensor, std: torch.Tensor, mean: torch.Tensor) -> torch.Tensor:
    """out (B, X, Y, C); std/mean (B, 1, 1, 1, C) -> (B, X, Y, 1, C)."""
    out = out * std.squeeze(-2) + mean.squeeze(-2)
    return out[..., None, :]


class FNO2d(nn.Module):
    """Baseline 2D FNO.  Parameters are initialised on the CPU from
    ``generator`` (or torch's global generator); move the module after."""

    def __init__(self, num_channels: int, modes1: int = 12, modes2: int = 12,
                 width: int = 20, initial_step: int = 10,
                 generator: torch.Generator | None = None, remat: bool = False):
        super().__init__()
        if remat:
            raise NotImplementedError("remat (rematerialised spectral blocks) is not ported "
                                      "yet (ROADMAP A4)")
        self.num_channels, self.modes1, self.modes2 = num_channels, modes1, modes2
        self.width, self.initial_step = width, initial_step
        self.backbone = FNOBackbone2d(initial_step * num_channels + 2, modes1, modes2,
                                      width, generator=generator)
        self.fc2 = torch_linear(128, num_channels, generator)

    def forward(self, x: torch.Tensor, grid: torch.Tensor, impl: str | None = None) -> torch.Tensor:
        inp, std, mean = _prep_2d(x, grid)
        return _denorm(self.fc2(self.backbone(inp, impl)), std, mean)


class FNO2dAux(nn.Module):
    """Two-head 2D FNO of multiphysics joint training: one backbone, the
    heads ``fc2_primary`` and ``fc2_auxiliary``.  The joint ``forward`` runs
    the backbone once over the concatenated batch and splits it; instance
    norm is per sample, so ``primary`` and ``auxiliary`` alone compute the
    same.  Parameter names follow flax's paths (``backbone``,
    ``fc2_primary``, ``fc2_auxiliary``)."""

    def __init__(self, num_channels: int, modes1: int = 12, modes2: int = 12,
                 width: int = 20, initial_step: int = 10,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.num_channels, self.modes1, self.modes2 = num_channels, modes1, modes2
        self.width, self.initial_step = width, initial_step
        self.backbone = FNOBackbone2d(initial_step * num_channels + 2, modes1, modes2,
                                      width, generator=generator)
        self.fc2_primary = torch_linear(128, num_channels, generator)
        self.fc2_auxiliary = torch_linear(128, num_channels, generator)

    def primary(self, x: torch.Tensor, grid: torch.Tensor, impl: str | None = None):
        inp, std, mean = _prep_2d(x, grid)
        return _denorm(self.fc2_primary(self.backbone(inp, impl)), std, mean)

    def auxiliary(self, x_aux: torch.Tensor, grid_aux: torch.Tensor, impl: str | None = None):
        inp, std, mean = _prep_2d(x_aux, grid_aux)
        return _denorm(self.fc2_auxiliary(self.backbone(inp, impl)), std, mean)

    def forward(self, x: torch.Tensor, grid: torch.Tensor, x_aux: torch.Tensor,
                grid_aux: torch.Tensor, impl: str | None = None):
        b = x.shape[0]
        inp_p, std_p, mean_p = _prep_2d(x, grid)
        inp_a, std_a, mean_a = _prep_2d(x_aux, grid_aux)
        feats = self.backbone(torch.cat([inp_p, inp_a], dim=0), impl)
        return (_denorm(self.fc2_primary(feats[:b]), std_p, mean_p),
                _denorm(self.fc2_auxiliary(feats[b:]), std_a, mean_a))
