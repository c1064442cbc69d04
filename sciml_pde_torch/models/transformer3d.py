"""3D VideoMAE-style transformer operator on the buoyant plume (port of
``sciml_pde_tpu/models/transformer3d.py``).

x (B, T, X, Y, Z, C), channels last: instance norm per (b, c) over
(T, X, Y, Z), replicate ("edge") padding of X, Y, Z up to multiples of the
patch, voxel tokens with features ordered (tt px py pz c), the encoder and
decoder token stacks of ``models/transformer.py``, a per-token voxel head,
the unpad, de-normalisation and the last frame.  ``Transformer3DBaseline``
and ``Transformer3DAux`` give it the FNO call signature (windows
(B, X, Y, Z, T, C) and a grid, which they ignore) with its parameters under
``vit_core``, so the FNO trainer's steps drive it.

The plume shape (50, 50, 89) with patch (10, 10, 9) and tubelet 5 gives 500
tokens, a count the JAX package's shape rule sends to ``jnp_attention``;
``flash_attention`` routes it the same way.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from sciml_pde_torch.models.common import instance_norm_stats
from sciml_pde_torch.models.transformer import Dense, LayerNorm, TokenStack, sinusoid_table


def _pad_to_multiple(x: torch.Tensor, patch: tuple[int, int, int]):
    """Replicate-pad the spatial axes (2, 3, 4) of (B, T, X, Y, Z, C) up to
    multiples of ``patch``; returns the padded tensor and the pads."""
    pads = tuple(math.ceil(n / p) * p - n for n, p in zip(x.shape[2:5], patch))
    for axis, pad in zip((2, 3, 4), pads):
        if pad:
            n = x.shape[axis]
            idx = torch.clamp(torch.arange(n + pad, device=x.device), max=n - 1)
            x = torch.index_select(x, axis, idx)
    return x, pads


def patchify3d(x: torch.Tensor, tubelet: int, patch: tuple[int, int, int]):
    """(B, T, X, Y, Z, C), padded -> (B, N, tt*px*py*pz*C)."""
    b, t, nx, ny, nz, c = x.shape
    px, py, pz = patch
    x = x.reshape(b, t // tubelet, tubelet, nx // px, px, ny // py, py, nz // pz, pz, c)
    x = x.permute(0, 1, 3, 5, 7, 2, 4, 6, 8, 9)  # b t' x' y' z' tt px py pz c
    return x.reshape(b, -1, tubelet * px * py * pz * c)


def unpatchify3d(tokens, tubelet: int, patch: tuple[int, int, int], t: int, nx: int, ny: int,
                 nz: int, c: int):
    b = tokens.shape[0]
    px, py, pz = patch
    x = tokens.reshape(b, t // tubelet, nx // px, ny // py, nz // pz, tubelet, px, py, pz, c)
    x = x.permute(0, 1, 5, 2, 6, 3, 7, 4, 8, 9)
    return x.reshape(b, t, nx, ny, nz, c)


class VideoMAEOperator3D(nn.Module):
    """Next-frame operator (B, T, X, Y, Z, C) -> (B, X, Y, Z, C)."""

    def __init__(self, img_size=(50, 50, 89), patch_size=(10, 10, 9), tubelet_size: int = 5,
                 in_chans: int = 4, num_frames: int = 10, encoder_dim: int = 768,
                 encoder_depth: int = 12, encoder_heads: int = 12, decoder_dim: int = 512,
                 decoder_depth: int = 8, decoder_heads: int = 8, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop_path_rate: float = 0.0, init_values: float = 0.0,
                 use_checkpoint: bool = False, dtype: torch.dtype = torch.float32,
                 attn_impl: str = "flash", generator: torch.Generator | None = None):
        super().__init__()
        self.patch_size, self.tubelet_size = tuple(patch_size), tubelet_size
        self.encoder_dim = encoder_dim
        common = dict(mlp_ratio=mlp_ratio, qkv_bias=qkv_bias, drop_path_rate=drop_path_rate,
                      init_values=init_values, use_checkpoint=use_checkpoint, dtype=dtype,
                      attn_impl=attn_impl, generator=generator)
        patch_dim = tubelet_size * int(np.prod(self.patch_size)) * in_chans
        self.patch_proj = Dense(patch_dim, encoder_dim, generator=generator)
        self.encoder = TokenStack(encoder_dim, encoder_depth, encoder_heads, **common)
        self.encoder_norm = LayerNorm(encoder_dim)
        self.encoder_to_decoder = Dense(encoder_dim, decoder_dim, use_bias=False,
                                        generator=generator)
        self.decoder = TokenStack(decoder_dim, decoder_depth, decoder_heads, **common)
        self.decoder_norm = LayerNorm(decoder_dim)
        self.head = Dense(decoder_dim, patch_dim, generator=generator)
        self._pos: dict[tuple, torch.Tensor] = {}

    def forward(self, x, deterministic: bool = True, generator=None):
        b, t, nx, ny, nz, c = x.shape
        std, mean = instance_norm_stats(x, (1, 2, 3, 4))  # per (b, c)
        xp, _ = _pad_to_multiple((x - mean) / std, self.patch_size)
        tokens = self.patch_proj(patchify3d(xp, self.tubelet_size, self.patch_size))
        key = (tokens.shape[1], str(tokens.device))
        if key not in self._pos:  # copied to the device once
            self._pos[key] = torch.as_tensor(sinusoid_table(tokens.shape[1], self.encoder_dim),
                                             device=tokens.device)
        tokens = self.encoder(tokens + self._pos[key][None], deterministic, generator)
        tokens = self.encoder_to_decoder(self.encoder_norm(tokens))
        tokens = self.decoder(tokens, deterministic, generator)
        pix = self.head(self.decoder_norm(tokens)).float()
        vol = unpatchify3d(pix, self.tubelet_size, self.patch_size, t, *xp.shape[2:5], c)
        vol = vol[:, -1, :nx, :ny, :nz]  # the last frame, unpadded
        return vol * std[:, 0] + mean[:, 0]


def _to_tf(v):
    """(B, X, Y, Z, T, C) window -> (B, T, X, Y, Z, C)."""
    return torch.movedim(v, -2, 1)


class Transformer3DBaseline(nn.Module):
    """``forward(x (B, X, Y, Z, T, C), grid) -> (B, X, Y, Z, 1, C)``; the grid
    is unused."""

    def __init__(self, **core_kwargs):
        super().__init__()
        self.vit_core = VideoMAEOperator3D(**core_kwargs)

    def forward(self, x, grid):
        del grid
        return self.vit_core(_to_tf(x))[..., None, :]


class Transformer3DAux(nn.Module):
    """``forward(x, grid, x_aux, grid_aux) -> ((B, X, Y, Z, 1, C),
    (B * nA, X, Y, Z, 1, C))``: one core for both streams, run once on the
    concatenated batch when their shapes match; the grids are unused."""

    def __init__(self, **core_kwargs):
        super().__init__()
        self.vit_core = VideoMAEOperator3D(**core_kwargs)

    def forward(self, x, grid, x_aux, grid_aux):
        del grid, grid_aux
        xp, xa = _to_tf(x), _to_tf(x_aux)
        if xp.shape[1:] == xa.shape[1:]:
            out = self.vit_core(torch.cat([xp, xa]))
            out_p, out_a = out[:xp.shape[0]], out[xp.shape[0]:]
        else:
            out_p, out_a = self.vit_core(xp), self.vit_core(xa)
        return out_p[..., None, :], out_a[..., None, :]
