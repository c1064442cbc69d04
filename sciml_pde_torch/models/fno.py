"""Fourier Neural Operators in 2D and 3D, baseline and two-head (port of
``FNO2d``, ``FNO2dAux``, ``FNO3d`` and ``FNO3dAux`` in
``sciml_pde_tpu/models/fno.py``).

The plain models: what the production and aux steps train, the reference
the fused step is held against, and the form checkpoints take
(``utils/weights.py`` converts between their ``state_dict``, the flax
parameter tree and the fused step's packed parameters).

Call signatures as the JAX package's, channels-last throughout:
``FNO2d(x: [B,X,Y,T,C], grid: [B,X,Y,2]) -> [B,X,Y,1,C]`` and
``FNO3d(x: [B,X,Y,Z,T,C], grid: [B,X,Y,Z,3]) -> [B,X,Y,Z,1,C]``; the aux
models take the aux stream and its grid as well.  ``impl`` picks the
spectral conv's form; None means the module default of ``ops/spectral.py``
(``dft2`` unless ``SCIML_SPECTRAL_IMPL`` says otherwise), as in the flax
model.  The dense layers are f32 products.  ``remat=True`` recomputes each
of the four spectral blocks in the backward pass
(``torch.utils.checkpoint``) instead of keeping its activations; the
parameters and their names do not change.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from sciml_pde_torch.models.common import gelu, instance_norm_stats, torch_linear
from sciml_pde_torch.ops.spectral import (
    spectral_conv_2d,
    spectral_conv_3d,
    spectral_weight_init,
)


class SpectralConv2d(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, modes1: int, modes2: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.modes1, self.modes2 = modes1, modes2
        self.w1 = nn.Parameter(spectral_weight_init(in_channels, out_channels, modes1,
                                                    modes2, generator=generator))
        self.w2 = nn.Parameter(spectral_weight_init(in_channels, out_channels, modes1,
                                                    modes2, generator=generator))

    def forward(self, x: torch.Tensor, impl: str | None = None) -> torch.Tensor:
        return spectral_conv_2d(x, self.w1, self.w2, self.modes1, self.modes2, impl)


class SpectralConv3d(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, modes1: int, modes2: int,
                 modes3: int, generator: torch.Generator | None = None):
        super().__init__()
        self.modes = (modes1, modes2, modes3)
        for i in range(1, 5):
            setattr(self, f"w{i}", nn.Parameter(spectral_weight_init(
                in_channels, out_channels, *self.modes, generator=generator)))

    def forward(self, x: torch.Tensor, impl: str | None = None) -> torch.Tensor:
        return spectral_conv_3d(x, self.w1, self.w2, self.w3, self.w4, *self.modes, impl)


class _Backbone(nn.Module):
    """Lift -> pad -> 4 x (spectral + pointwise) -> unpad -> project to 128,
    in 2D or 3D; ``remat`` recomputes each block in the backward pass."""

    def __init__(self, in_features: int, width: int, make_conv, remat: bool,
                 generator: torch.Generator | None):
        super().__init__()
        self.remat = remat
        self.fc0 = torch_linear(in_features, width, generator)
        self.convs = nn.ModuleList(make_conv() for _ in range(4))
        self.ws = nn.ModuleList(torch_linear(width, width, generator) for _ in range(4))
        self.fc1 = torch_linear(width, 128, generator)

    def _block(self, i: int, x: torch.Tensor, impl: str | None) -> torch.Tensor:
        x = self.convs[i](x, impl) + self.ws[i](x)
        return gelu(x) if i < 3 else x

    def _blocks(self, x: torch.Tensor, impl: str | None) -> torch.Tensor:
        for i in range(4):
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(self._block, i, x, impl, use_reentrant=False)
            else:
                x = self._block(i, x, impl)
        return x


class FNOBackbone2d(_Backbone):
    """Lift -> pad X and Y by ``padding`` -> 4 blocks -> unpad -> 128."""

    def __init__(self, in_features: int, modes1: int, modes2: int, width: int,
                 padding: int = 2, generator: torch.Generator | None = None,
                 remat: bool = False):
        super().__init__(in_features, width,
                         lambda: SpectralConv2d(width, width, modes1, modes2, generator),
                         remat, generator)
        self.padding = padding

    def forward(self, x: torch.Tensor, impl: str | None = None) -> torch.Tensor:
        nx, ny = x.shape[1], x.shape[2]
        x = nn.functional.pad(self.fc0(x), (0, 0, 0, self.padding, 0, self.padding))
        x = self._blocks(x, impl)[:, :nx, :ny]
        return gelu(self.fc1(x))


class FNOBackbone3d(_Backbone):
    """Lift -> pad Z alone by ``padding`` (6, as the reference) -> 4 blocks
    -> unpad -> 128."""

    def __init__(self, in_features: int, modes1: int, modes2: int, modes3: int, width: int,
                 padding: int = 6, generator: torch.Generator | None = None,
                 remat: bool = False):
        super().__init__(in_features, width,
                         lambda: SpectralConv3d(width, width, modes1, modes2, modes3, generator),
                         remat, generator)
        self.padding = padding

    def forward(self, x: torch.Tensor, impl: str | None = None) -> torch.Tensor:
        nz = x.shape[3]
        x = nn.functional.pad(self.fc0(x), (0, 0, 0, self.padding))
        x = self._blocks(x, impl)[:, :, :, :nz]
        return gelu(self.fc1(x))


def _prep(x: torch.Tensor, grid: torch.Tensor):
    """Normalise per sample and channel over the spatial axes and T, and
    build the lift input: (B, *spatial, T, C) -> (B, *spatial, T*C + ndim)."""
    std, mean = instance_norm_stats(x, tuple(range(1, x.ndim - 1)))
    xn = (x - mean) / std
    return torch.cat([xn.reshape(*xn.shape[:-2], -1), grid], dim=-1), std, mean


def _denorm(out: torch.Tensor, std: torch.Tensor, mean: torch.Tensor) -> torch.Tensor:
    """out (B, *spatial, C); std/mean (B, 1, ..., 1, C) -> (B, *spatial, 1, C)."""
    out = out * std.squeeze(-2) + mean.squeeze(-2)
    return out[..., None, :]


class _Baseline(nn.Module):
    """One backbone and the head ``fc2``."""

    def __init__(self, num_channels: int, backbone: _Backbone,
                 generator: torch.Generator | None):
        super().__init__()
        self.backbone = backbone
        self.fc2 = torch_linear(128, num_channels, generator)

    def forward(self, x: torch.Tensor, grid: torch.Tensor, impl: str | None = None) -> torch.Tensor:
        inp, std, mean = _prep(x, grid)
        return _denorm(self.fc2(self.backbone(inp, impl)), std, mean)


class _TwoHead(nn.Module):
    """One backbone and the heads ``fc2_primary`` and ``fc2_auxiliary``.  The
    joint ``forward`` runs the backbone once over the concatenated batch and
    splits it; instance norm is per sample, so ``primary`` and ``auxiliary``
    alone compute the same.  Parameter names follow flax's paths."""

    def __init__(self, num_channels: int, backbone: _Backbone,
                 generator: torch.Generator | None):
        super().__init__()
        self.backbone = backbone
        self.fc2_primary = torch_linear(128, num_channels, generator)
        self.fc2_auxiliary = torch_linear(128, num_channels, generator)

    def primary(self, x: torch.Tensor, grid: torch.Tensor, impl: str | None = None):
        inp, std, mean = _prep(x, grid)
        return _denorm(self.fc2_primary(self.backbone(inp, impl)), std, mean)

    def auxiliary(self, x_aux: torch.Tensor, grid_aux: torch.Tensor, impl: str | None = None):
        inp, std, mean = _prep(x_aux, grid_aux)
        return _denorm(self.fc2_auxiliary(self.backbone(inp, impl)), std, mean)

    def forward(self, x: torch.Tensor, grid: torch.Tensor, x_aux: torch.Tensor,
                grid_aux: torch.Tensor, impl: str | None = None):
        b = x.shape[0]
        inp_p, std_p, mean_p = _prep(x, grid)
        inp_a, std_a, mean_a = _prep(x_aux, grid_aux)
        feats = self.backbone(torch.cat([inp_p, inp_a], dim=0), impl)
        return (_denorm(self.fc2_primary(feats[:b]), std_p, mean_p),
                _denorm(self.fc2_auxiliary(feats[b:]), std_a, mean_a))


def _backbone_2d(num_channels, modes1, modes2, width, initial_step, generator, remat):
    return FNOBackbone2d(initial_step * num_channels + 2, modes1, modes2, width,
                         generator=generator, remat=remat)


def _backbone_3d(num_channels, modes1, modes2, modes3, width, initial_step, generator, remat):
    return FNOBackbone3d(initial_step * num_channels + 3, modes1, modes2, modes3, width,
                         generator=generator, remat=remat)


class FNO2d(_Baseline):
    """Baseline 2D FNO.  Parameters are initialised on the CPU from
    ``generator`` (or torch's global generator); move the module after."""

    def __init__(self, num_channels: int, modes1: int = 12, modes2: int = 12,
                 width: int = 20, initial_step: int = 10,
                 generator: torch.Generator | None = None, remat: bool = False):
        super().__init__(num_channels, _backbone_2d(num_channels, modes1, modes2, width,
                                                    initial_step, generator, remat), generator)


class FNO2dAux(_TwoHead):
    """Two-head 2D FNO of multiphysics joint training."""

    def __init__(self, num_channels: int, modes1: int = 12, modes2: int = 12,
                 width: int = 20, initial_step: int = 10,
                 generator: torch.Generator | None = None, remat: bool = False):
        super().__init__(num_channels, _backbone_2d(num_channels, modes1, modes2, width,
                                                    initial_step, generator, remat), generator)


class FNO3d(_Baseline):
    """Baseline 3D FNO."""

    def __init__(self, num_channels: int, modes1: int = 8, modes2: int = 8, modes3: int = 8,
                 width: int = 20, initial_step: int = 10,
                 generator: torch.Generator | None = None, remat: bool = False):
        super().__init__(num_channels, _backbone_3d(num_channels, modes1, modes2, modes3,
                                                    width, initial_step, generator, remat),
                         generator)


class FNO3dAux(_TwoHead):
    """Two-head 3D FNO."""

    def __init__(self, num_channels: int, modes1: int = 8, modes2: int = 8, modes3: int = 8,
                 width: int = 20, initial_step: int = 10,
                 generator: torch.Generator | None = None, remat: bool = False):
        super().__init__(num_channels, _backbone_3d(num_channels, modes1, modes2, modes3,
                                                    width, initial_step, generator, remat),
                         generator)
