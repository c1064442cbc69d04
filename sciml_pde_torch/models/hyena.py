"""Hyena operator comparison suite (port of ``sciml_pde_tpu/models/hyena.py``).

  - ``fftconv``: length-2L zero-padded FFT long convolution plus the
    per-channel bias ("D") skip, through ``torch.fft.fft``/``ifft`` (JAX
    writes its inverse as ``conj(fft(conj(.)))``, a TPU lowering detail);
  - ``positional_embedding``: [t, Re/Im of complex exponentials], the
    filter's input;
  - ``Sin`` with a trainable frequency, ``ExponentialModulation`` of the
    implicit filter, ``HyenaFilter`` (the sine-activated implicit MLP that
    generates the long kernel);
  - ``HyenaOperator``: the order-2 recurrence with the depthwise short conv
    gating (refuses a sequence longer than ``l_max``);
  - ``Hyena1dBlock``: 8 parallel (norm -> Hyena -> norm -> +x -> FFN)
    branches summed, the bottleneck of ``HyenaOFormer2D`` between the OFormer
    encoder and decoder.

Parameters keep flax's names and layouts (``models/oformer.py``).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
from torch import nn

from sciml_pde_torch.models.common import gelu
from sciml_pde_torch.models.oformer import (
    PointWiseDecoder2D,
    SpatialTemporalEncoder2D,
    _instance_norm,
    dense,
)


def fftconv(u: torch.Tensor, k: torch.Tensor, d_bias: torch.Tensor) -> torch.Tensor:
    """Causal long convolution: u (B, D, L), k (D, L), d_bias (D,) -> (B, D, L)."""
    seqlen = u.shape[-1]
    fft_size = 2 * seqlen
    k_f = torch.fft.fft(k, n=fft_size, dim=-1) / fft_size
    u_f = torch.fft.fft(u.float(), n=fft_size, dim=-1)
    y = torch.fft.ifft(u_f * k_f, dim=-1, norm="forward").real[..., :seqlen]
    return (y + u * d_bias[..., None]).to(u.dtype)


class Sin(nn.Module):
    def __init__(self, dim: int, w: float = 10.0):
        super().__init__()
        self.freq = nn.Parameter(torch.full((1, dim), float(w)))

    def forward(self, x):
        return torch.sin(self.freq * x)


@functools.lru_cache(maxsize=16)
def positional_embedding(emb_dim: int, seq_len: int) -> tuple[np.ndarray, np.ndarray]:
    """z (1, L, emb_dim) = [t, Re z, Im z]; t (1, L, 1)."""
    t = np.linspace(0, 1, seq_len)[None, :, None].astype(np.float32)
    bands = (emb_dim - 1) // 2
    t_rescaled = np.linspace(0, seq_len - 1, seq_len)[None, :, None]
    w = 2 * math.pi * t_rescaled / seq_len
    f = np.linspace(1e-4, bands - 1, bands)[None, None]
    z = np.exp(-1j * f * w)
    z = np.concatenate([t, z.real, z.imag], axis=-1).astype(np.float32)
    return z, t


class ExponentialModulation(nn.Module):
    def __init__(self, d_model: int, fast_decay_pct: float = 0.3, slow_decay_pct: float = 1.5,
                 target: float = 1e-2, shift: float = 0.0):
        super().__init__()
        max_decay = math.log(target) / fast_decay_pct
        min_decay = math.log(target) / slow_decay_pct
        self.deltas = np.linspace(min_decay, max_decay, d_model)[None, None].astype(np.float32)
        self.shift = shift

    def forward(self, t, x):
        decay = torch.exp(-t * torch.as_tensor(np.abs(self.deltas), device=t.device))
        return x * (decay + self.shift)


class HyenaFilter(nn.Module):
    """The implicit filter: ``implicit_0`` ... as flax's list names them
    (Dense and Sin alternating, a bias-free Dense last)."""

    def __init__(self, d_model: int, emb_dim: int = 3, order: int = 64, seq_len: int = 1024,
                 w: float = 1.0, num_inner_mlps: int = 8, generator=None):
        super().__init__()
        self.emb_dim, self.seq_len = emb_dim, seq_len
        self.bias = nn.Parameter(torch.randn(d_model, generator=generator))
        layers = [dense(emb_dim, order, generator=generator), Sin(order, w)]
        for _ in range(num_inner_mlps):
            layers += [dense(order, order, generator=generator), Sin(order, w)]
        layers += [dense(order, d_model, use_bias=False, generator=generator)]
        self.n_layers = len(layers)
        for i, layer in enumerate(layers):
            self.add_module(f"implicit_{i}", layer)
        self.modulation = ExponentialModulation(d_model)

    def filter(self, L: int, device=None) -> torch.Tensor:
        z, t = positional_embedding(self.emb_dim, self.seq_len)
        h = torch.as_tensor(z[:, :L], device=device)
        for i in range(self.n_layers):
            h = getattr(self, f"implicit_{i}")(h)
        return self.modulation(torch.as_tensor(t[:, :L], device=device), h)  # (1, L, d_model)


class HyenaOperator(nn.Module):
    """Order-2 Hyena recurrence: u (B, L, D) -> (B, L, D)."""

    def __init__(self, d_model: int, l_max: int = 4096, order: int = 2, filter_order: int = 64,
                 generator=None):
        super().__init__()
        self.d_model, self.l_max, self.order = d_model, l_max, order
        inner = d_model * (order + 1)
        self.in_proj = dense(d_model, inner, generator=generator)
        self.short_filter = nn.Parameter(torch.randn(inner, 3, generator=generator)
                                         / math.sqrt(3))
        self.short_bias = nn.Parameter(torch.zeros(inner))
        self.filter_fn = HyenaFilter(d_model * (order - 1), order=filter_order, seq_len=l_max,
                                     generator=generator)
        self.out_proj = dense(d_model, d_model, generator=generator)

    def forward(self, u):
        b, l, _ = u.shape
        if l > self.l_max:
            raise ValueError(
                f"sequence length {l} exceeds l_max={self.l_max}; construct "
                "the operator with l_max >= the flattened grid size")
        l_filter = min(l, self.l_max)
        u = self.in_proj(u).transpose(1, 2)  # (B, inner, L)
        # depthwise causal short conv, kernel 3, pad 2, truncate to L
        up = nn.functional.pad(u, (2, 2))
        kern = self.short_filter
        uc = up[..., :-2] * kern[:, 0:1] + up[..., 1:-1] * kern[:, 1:2] + up[..., 2:] * kern[:, 2:3]
        uc = (uc + self.short_bias[:, None])[..., :l_filter]
        *x, v = uc.chunk(self.order + 1, dim=1)
        k = self.filter_fn.filter(l_filter, device=u.device)[0]  # (L, (order-1)*d)
        k = k.transpose(0, 1).reshape(self.order - 1, self.d_model, l_filter)
        bias = self.filter_fn.bias.reshape(self.order - 1, self.d_model)
        for o, x_i in enumerate(reversed(x[1:])):
            v = fftconv(v * x_i, k[o], bias[o])
        return self.out_proj((v * x[0]).transpose(1, 2))


class Hyena1dBlock(nn.Module):
    """``branches`` parallel Hyena branches, summed."""

    def __init__(self, dim: int, branches: int = 8, l_max: int = 4096, generator=None):
        super().__init__()
        self.branches = branches
        for i in range(1, branches + 1):
            self.add_module(f"h{i}", HyenaOperator(dim, l_max, generator=generator))
            self.add_module(f"f{i}a", dense(dim, dim, generator=generator))
            self.add_module(f"f{i}b", dense(dim, dim, generator=generator))

    def forward(self, x):
        total = 0.0
        for i in range(1, self.branches + 1):
            h = _instance_norm(getattr(self, f"h{i}")(_instance_norm(x))) + x
            h = getattr(self, f"f{i}b")(gelu(getattr(self, f"f{i}a")(h)))
            total = total + h
        return total


class HyenaOFormer2D(nn.Module):
    """OFormer encoder -> hyena1d bottleneck -> pointwise decoder."""

    def __init__(self, input_channels: int, out_channels: int, in_emb_dim: int = 96,
                 latent_channels: int = 192, heads: int = 4, depth: int = 2, out_steps: int = 1,
                 branches: int = 8, l_max: int = 4096, remat: bool = False, generator=None):
        super().__init__()
        self.encoder = SpatialTemporalEncoder2D(input_channels, in_emb_dim, latent_channels,
                                                heads, depth, generator=generator)
        self.hyena = Hyena1dBlock(latent_channels, branches=branches, l_max=l_max,
                                  generator=generator)
        self.decoder = PointWiseDecoder2D(latent_channels, out_channels, out_steps,
                                          propagator_depth=1, remat=remat, generator=generator)

    def forward(self, x, pos):
        return self.decoder(self.hyena(self.encoder(x, pos)), pos, pos)[0]

    def rollout(self, x, pos, forward_steps: int):
        """One encode, the hyena bottleneck, then ``forward_steps`` latent
        propagator/decode steps."""
        return self.decoder.rollout(self.hyena(self.encoder(x, pos)), pos, forward_steps, pos)
