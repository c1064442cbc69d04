"""OFormer (operator transformer) comparison suite (port of
``sciml_pde_tpu/models/oformer.py``).

  - ``LinearAttention`` with Galerkin (instance-norm K, V) and Fourier
    (instance-norm Q, K) normalisation and the linear q (k^T v) / n
    contraction, pad-aware (``max(count, 1)`` divisor);
  - rotary and 2D-rotary relative position embeddings;
  - ``CrossLinearAttention`` decoder attention;
  - ``SpatialTemporalEncoder2D``: Linear embed -> Galerkin transformer with
    per-layer rotary scales -> Linear to latent;
  - ``PointWiseDecoder2D``: Gaussian Fourier coordinate features -> cross
    attention -> latent ``propagate`` blocks -> pointwise decode, plus the
    latent ``rollout`` (a Python loop for JAX's ``lax.scan``; ``remat``
    recomputes each step in the backward pass, ``torch.utils.checkpoint``);
  - ``OFormer2D``, ``OFormer1D``, ``OFormerIrreg2D`` (steady point sets with
    pad masks) and ``OFormerIrregST2D`` (time-dependent point sets).

Parameters keep flax's names and layouts, so a flax tree maps onto the
``state_dict`` by joining its keys with dots
(``utils/weights.py::oformer_flax_to_state_dict``): ``Dense`` kernels
``(in, out)``, ``LayerNorm`` ``scale``/``bias`` (epsilon 1e-6), ``Conv``
kernels ``(k, in, out)``, ``Embed`` ``embedding``.  The port initialises
from a ``torch.Generator`` (orthogonal q/k/v, Xavier elsewhere, as flax);
parity with JAX comes from carrying a flax tree across.  The
``GaussianFourierFeatureTransform``'s ``B`` is a parameter read through
``detach`` (JAX's ``stop_gradient``): it takes no gradient but stays in the
optimizer, whose weight decay moves it as optax's does.  Every contraction
is a plain product on library kernels, as in the JAX package (no Pallas).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from sciml_pde_torch.models.common import gelu
from sciml_pde_torch.models.transformer import Dense, LayerNorm


def _orthogonal_(dense: Dense, generator) -> Dense:
    """flax ``orthogonal()`` on the (in, out) kernel, from ``generator``."""
    with torch.no_grad():
        fan_in, fan_out = dense.kernel.shape
        a = torch.randn(max(fan_in, fan_out), min(fan_in, fan_out), generator=generator)
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))
        dense.kernel.copy_(q if fan_in >= fan_out else q.T)
    return dense


def dense(fan_in: int, features: int, use_bias: bool = True, generator=None,
          ortho: bool = False) -> Dense:
    d = Dense(fan_in, features, use_bias=use_bias, generator=generator)
    return _orthogonal_(d, generator) if ortho else d


# --------------------------------------------------------------------------
# rotary embeddings
# --------------------------------------------------------------------------


def rotary_freqs(coords: torch.Tensor, dim: int, min_freq: float = 1 / 64,
                 scale: float = 1.0) -> torch.Tensor:
    """coords (..., n) -> (..., n, dim) rotary phase table."""
    inv = 1.0 / (10000 ** (np.arange(0, dim, 2, dtype=np.float32) / dim))
    t = coords * (scale / min_freq)
    freqs = t[..., None] * torch.as_tensor(inv, device=coords.device)
    return torch.cat([freqs, freqs], dim=-1)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.reshape(*x.shape[:-1], 2, x.shape[-1] // 2).unbind(-2)
    return torch.cat([-x2, x1], dim=-1)


def apply_rotary_pos_emb(t: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    return t * torch.cos(freqs) + _rotate_half(t) * torch.sin(freqs)


def apply_2d_rotary_pos_emb(t: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor) -> torch.Tensor:
    d = t.shape[-1]
    return torch.cat([apply_rotary_pos_emb(t[..., :d // 2], fx),
                      apply_rotary_pos_emb(t[..., d // 2:], fy)], dim=-1)


def _instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Standardise the last (head) dim per token (the reference's affine-free
    InstanceNorm1d)."""
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    return (x - mu) * torch.rsqrt(var + eps)


def _galerkin(q, k, v, mask, n: int, dtype) -> torch.Tensor:
    """q (k^T v) / n, the pad rows of ``mask`` (b, n) left out of k, v and n."""
    if mask is not None:
        m = mask[:, None, :, None]
        k = torch.where(m, k, torch.zeros((), dtype=k.dtype, device=k.device))
        v = torch.where(m, v, torch.zeros((), dtype=v.dtype, device=v.device))
        denom = torch.clamp(mask.sum(dim=1).to(dtype), min=1.0)[:, None, None, None]
    else:
        denom = n
    dots = torch.einsum("bhnd,bhne->bhde", k, v)
    return torch.einsum("bhnd,bhde->bhne", q, dots) / denom


def _heads(t: torch.Tensor, heads: int, dim_head: int) -> torch.Tensor:
    b, n, _ = t.shape
    return t.reshape(b, n, heads, dim_head).transpose(1, 2)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------


class LinearAttention(nn.Module):
    def __init__(self, in_dim: int, dim: int, attn_type: str = "galerkin", heads: int = 8,
                 dim_head: int = 64, relative_emb: bool = True, scale: float = 1.0,
                 relative_emb_dim: int = 2, min_freq: float = 1 / 64, generator=None):
        super().__init__()
        self.attn_type, self.heads, self.dim_head = attn_type, heads, dim_head
        self.relative_emb, self.scale = relative_emb, scale
        self.relative_emb_dim, self.min_freq = relative_emb_dim, min_freq
        inner = heads * dim_head
        self.to_qkv = dense(in_dim, inner * 3, use_bias=False, generator=generator, ortho=True)
        self.to_out = dense(inner, dim, generator=generator)

    def forward(self, x, pos=None, mask=None):
        b, n, _ = x.shape
        q, k, v = (_heads(t, self.heads, self.dim_head)
                   for t in self.to_qkv(x).chunk(3, dim=-1))
        if self.attn_type == "galerkin":
            k, v = _instance_norm(k), _instance_norm(v)
        else:  # fourier
            q, k = _instance_norm(q), _instance_norm(k)
        if self.relative_emb:
            if self.relative_emb_dim == 2:
                fx = rotary_freqs(pos[..., 0], self.dim_head // 2, self.min_freq,
                                  self.scale)[:, None]
                fy = rotary_freqs(pos[..., 1], self.dim_head // 2, self.min_freq,
                                  self.scale)[:, None]
                q, k = apply_2d_rotary_pos_emb(q, fx, fy), apply_2d_rotary_pos_emb(k, fx, fy)
            else:
                f = rotary_freqs(pos[..., 0], self.dim_head, self.min_freq, self.scale)[:, None]
                q, k = apply_rotary_pos_emb(q, f), apply_rotary_pos_emb(k, f)
        out = _galerkin(q, k, v, mask, n, x.dtype)
        return self.to_out(out.transpose(1, 2).reshape(b, n, -1))


class CrossLinearAttention(nn.Module):
    """Queries from x (target points), keys/values from the context z."""

    def __init__(self, in_dim: int, dim: int, attn_type: str = "galerkin", heads: int = 8,
                 dim_head: int = 64, relative_emb: bool = True, scale: float = 16.0,
                 relative_emb_dim: int = 2, min_freq: float = 1 / 64, z_dim: int | None = None,
                 generator=None):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.relative_emb, self.scale, self.min_freq = relative_emb, scale, min_freq
        inner = heads * dim_head
        self.to_q = dense(in_dim, inner, use_bias=False, generator=generator, ortho=True)
        self.to_kv = dense(z_dim or in_dim, inner * 2, use_bias=False, generator=generator,
                           ortho=True)
        self.to_out = dense(inner, dim, generator=generator)

    def forward(self, x, z, x_pos=None, z_pos=None, mask=None):
        b, n, _ = x.shape
        m = z.shape[1]
        q = _heads(self.to_q(x), self.heads, self.dim_head)
        k, v = (_heads(t, self.heads, self.dim_head) for t in self.to_kv(z).chunk(2, dim=-1))
        k, v = _instance_norm(k), _instance_norm(v)
        if self.relative_emb and x_pos is not None:
            half = self.dim_head // 2

            def freqs(p, axis):
                return rotary_freqs(p[..., axis], half, self.min_freq, self.scale)[:, None]
            q = apply_2d_rotary_pos_emb(q, freqs(x_pos, 0), freqs(x_pos, 1))
            k = apply_2d_rotary_pos_emb(k, freqs(z_pos, 0), freqs(z_pos, 1))
        out = _galerkin(q, k, v, mask, m, x.dtype)
        return self.to_out(out.transpose(1, 2).reshape(b, n, -1))


class FeedForward(nn.Module):
    def __init__(self, dim: int, hidden: int, generator=None):
        super().__init__()
        self.fc1 = dense(dim, hidden, generator=generator)
        self.fc2 = dense(hidden, dim, generator=generator)

    def forward(self, x):
        return self.fc2(gelu(self.fc1(x)))


class GalerkinTransformer(nn.Module):
    """depth layers of (LayerNorm -> LinearAttention (+rotary, per-layer
    scale) -> residual, LayerNorm -> FFN -> residual); pad rows zeroed
    after each layer."""

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int, mlp_dim: int,
                 attn_type: str = "galerkin", scales: Sequence[float] = (32, 16, 16, 1),
                 min_freq: float = 1 / 64, relative_emb_dim: int = 2, generator=None):
        super().__init__()
        scales = list(scales)
        assert len(scales) == depth
        self.depth = depth
        for i in range(depth):
            self.add_module(f"ln_attn{i}", LayerNorm(dim))
            self.add_module(f"attn{i}", LinearAttention(
                dim, dim, attn_type, heads, dim_head, relative_emb=True,
                scale=float(scales[i]), min_freq=min_freq,
                relative_emb_dim=relative_emb_dim, generator=generator))
            self.add_module(f"ln_ffn{i}", LayerNorm(dim))
            self.add_module(f"ffn{i}", FeedForward(dim, mlp_dim, generator=generator))

    def forward(self, x, pos, mask=None):
        for i in range(self.depth):
            x = x + getattr(self, f"attn{i}")(getattr(self, f"ln_attn{i}")(x), pos, mask=mask)
            x = x + getattr(self, f"ffn{i}")(getattr(self, f"ln_ffn{i}")(x))
            if mask is not None:
                x = torch.where(mask[..., None], x, torch.zeros((), dtype=x.dtype,
                                                                device=x.device))
        return x


def _encoder_scales(depth: int) -> list:
    scales = [32] + [16] * (depth - 2) + [1] if depth <= 4 else (
        [32, 16, 8, 8] + [1] * (depth - 4))
    return scales[:depth] if depth > 1 else [1]


class SpatialTemporalEncoder2D(nn.Module):
    def __init__(self, input_channels: int, in_emb_dim: int = 128, out_seq_emb_dim: int = 128,
                 heads: int = 4, depth: int = 4, generator=None):
        super().__init__()
        self.to_embedding = dense(input_channels, in_emb_dim, use_bias=False,
                                  generator=generator)
        self.s_transformer = GalerkinTransformer(
            in_emb_dim, depth, heads, in_emb_dim, in_emb_dim,
            scales=tuple(_encoder_scales(depth)), generator=generator)
        self.project_to_latent = dense(in_emb_dim, out_seq_emb_dim, use_bias=False,
                                       generator=generator)

    def forward(self, x, input_pos):
        return self.project_to_latent(self.s_transformer(self.to_embedding(x), input_pos))


class GaussianFourierFeatureTransform(nn.Module):
    """Random Fourier features of coordinates; ``B`` takes no gradient."""

    def __init__(self, in_dim: int, mapping_size: int, scale: float = 8.0, generator=None):
        super().__init__()
        self.B = nn.Parameter(torch.randn(in_dim, mapping_size, generator=generator) * scale)

    def forward(self, pos):
        # the K = 2 product as products and one sum (no fused multiply-add),
        # as XLA sums it: phases reach ~50 rad, where one rounding shows
        proj = ((2 * math.pi * pos)[..., None] * self.B.detach()).sum(dim=-2)
        return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


class PointWiseDecoder2D(nn.Module):
    def __init__(self, latent_channels: int = 128, out_channels: int = 2, out_steps: int = 1,
                 propagator_depth: int = 2, scale: float = 8.0, remat: bool = False,
                 generator=None):
        super().__init__()
        lc = latent_channels
        self.out_steps, self.propagator_depth, self.remat = out_steps, propagator_depth, remat
        self.coord_ff = GaussianFourierFeatureTransform(2, lc // 2, scale, generator)
        self.coord_fc1 = dense(lc, lc, use_bias=False, generator=generator)
        self.coord_fc2 = dense(lc, lc // 2, use_bias=False, generator=generator)
        self.decoding_transformer = CrossLinearAttention(
            lc // 2, lc // 2, "galerkin", heads=4, dim_head=lc // 2, scale=16.0, z_dim=lc,
            generator=generator)
        self.expand_feat = dense(lc // 2, lc, generator=generator)
        for i in range(propagator_depth):
            self.add_module(f"prop_ln_{i}", LayerNorm(lc))
            for j in range(3):
                self.add_module(f"prop_mlp_{i}_{j}", dense(lc + 2 if j == 0 else lc, lc,
                                                           use_bias=False, generator=generator))
        self.out_ln = LayerNorm(lc)
        self.out_fc1 = dense(lc, lc // 2, use_bias=False, generator=generator)
        self.out_fc2 = dense(lc // 2, lc // 2, use_bias=False, generator=generator)
        self.out_fc3 = dense(lc // 2, out_channels * out_steps, generator=generator)

    def get_embedding(self, z, propagate_pos, input_pos):
        x = self.coord_fc2(gelu(self.coord_fc1(self.coord_ff(propagate_pos))))
        z = self.decoding_transformer(x, z, propagate_pos, input_pos)
        return self.expand_feat(z)

    def propagate(self, z, pos):
        for i in range(self.propagator_depth):
            h = torch.cat([getattr(self, f"prop_ln_{i}")(z), pos], dim=-1)
            h = gelu(getattr(self, f"prop_mlp_{i}_0")(h))
            h = gelu(getattr(self, f"prop_mlp_{i}_1")(h))
            z = getattr(self, f"prop_mlp_{i}_2")(h) + z
        return z

    def decode(self, z):
        h = self.out_ln(z)
        h = gelu(self.out_fc1(h))
        h = gelu(self.out_fc2(h))
        return self.out_fc3(h)

    def forward(self, z, propagate_pos, input_pos):
        """One decode step: latent z (b, m, c) -> (u (b, n, out_steps*C), z)."""
        z = self.get_embedding(z, propagate_pos, input_pos)
        z = self.propagate(z, propagate_pos)
        return self.decode(z), z

    def _body(self, z, pos):
        z = self.propagate(z, pos)
        return z, self.decode(z)

    def rollout(self, z, propagate_pos, forward_steps: int, input_pos):
        """Latent rollout: propagate ``forward_steps // out_steps`` times,
        decoding each step -> (b, n, steps * out_steps * C).  ``remat``
        recomputes each step's activations in the backward pass."""
        z = self.get_embedding(z, propagate_pos, input_pos)
        frames = []
        for _ in range(forward_steps // self.out_steps):
            if self.remat and torch.is_grad_enabled():
                z, u = checkpoint(self._body, z, propagate_pos, use_reentrant=False)
            else:
                z, u = self._body(z, propagate_pos)
            frames.append(u)
        out = torch.stack(frames, dim=2)  # (b, n, steps, out_steps*C)
        return out.reshape(out.shape[0], out.shape[1], -1)


class OFormer2D(nn.Module):
    """Encoder + pointwise decoder: x (B, N, C_in), pos (B, N, 2) ->
    (B, N, out_channels*out_steps)."""

    def __init__(self, input_channels: int, out_channels: int, in_emb_dim: int = 128,
                 latent_channels: int = 128, heads: int = 4, depth: int = 4,
                 out_steps: int = 1, propagator_depth: int = 2, remat: bool = False,
                 generator=None):
        super().__init__()
        self.encoder = SpatialTemporalEncoder2D(input_channels, in_emb_dim, latent_channels,
                                                heads, depth, generator=generator)
        self.decoder = PointWiseDecoder2D(latent_channels, out_channels, out_steps,
                                          propagator_depth, remat=remat, generator=generator)

    def forward(self, x, pos):
        return self.decoder(self.encoder(x, pos), pos, pos)[0]

    def rollout(self, x, pos, forward_steps: int):
        return self.decoder.rollout(self.encoder(x, pos), pos, forward_steps, pos)


class OFormer1D(nn.Module):
    """1D variant (Burgers / Darcy-style): x (B, N, C_in), pos (B, N, 1) ->
    (B, N, out_channels*out_steps)."""

    def __init__(self, input_channels: int, out_channels: int, in_emb_dim: int = 96,
                 latent_channels: int = 96, heads: int = 4, depth: int = 4, out_steps: int = 1,
                 generator=None):
        super().__init__()
        g = generator
        self.to_embedding = dense(input_channels, in_emb_dim, use_bias=False, generator=g)
        self.s_transformer = GalerkinTransformer(
            in_emb_dim, depth, heads, in_emb_dim, in_emb_dim,
            scales=tuple([32] + [16] * (depth - 2) + [1]), relative_emb_dim=1, generator=g)
        self.project_to_latent = dense(in_emb_dim, latent_channels, use_bias=False, generator=g)
        self.out_ln = LayerNorm(latent_channels)
        self.out_fc1 = dense(latent_channels, latent_channels, use_bias=False, generator=g)
        self.out_fc2 = dense(latent_channels, out_channels * out_steps, generator=g)

    def forward(self, x, pos):
        h = self.s_transformer(self.to_embedding(x), pos)
        z = self.out_ln(self.project_to_latent(h))
        return self.out_fc2(gelu(self.out_fc1(z)))


def _masked(t, mask_f):
    return torch.where(mask_f, t, torch.zeros((), dtype=t.dtype, device=t.device))


class OFormerIrreg2D(nn.Module):
    """Steady-state operator on zero-padded irregular point clouds:
    (x (B,N,C), pos (B,N,2), pad_mask (B,N) bool, bound_mask (B,N) bool) ->
    (scalar (B,N,1), field (B,N,2))."""

    def __init__(self, input_channels: int, latent_channels: int = 64, heads: int = 1,
                 depth: int = 2, res: int = 50, generator=None):
        super().__init__()
        lc, g = latent_channels, generator
        self.emb_fc1 = dense(input_channels, lc, use_bias=False, generator=g)
        self.emb_fc2 = dense(lc, lc, use_bias=False, generator=g)
        scales = [res, res // 4] + [1] * max(depth - 2, 0)
        self.s_transformer = GalerkinTransformer(
            lc, depth, heads, lc, lc, scales=tuple(scales[:depth]), min_freq=1 / res,
            generator=g)
        self.enc_out_fc1 = dense(lc, lc, use_bias=False, generator=g)
        self.enc_out_fc2 = dense(lc, lc, use_bias=False, generator=g)
        self.coord_fc1 = dense(3, lc, use_bias=False, generator=g)
        self.coord_fc2 = dense(lc, lc, use_bias=False, generator=g)
        self.coord_fc3 = dense(lc, lc, use_bias=False, generator=g)
        self.decoding_xattn = CrossLinearAttention(lc, lc, "galerkin", heads=4, dim_head=lc,
                                                   scale=1.0, min_freq=1 / res, generator=g)
        self.mix_attn = LinearAttention(lc, lc, "galerkin", heads=1, dim_head=lc, scale=4.0,
                                        min_freq=1 / res, generator=g)
        self.dec_out_fc1 = dense(lc + 1, lc, use_bias=False, generator=g)
        self.dec_out_fc2 = dense(lc, lc, use_bias=False, generator=g)
        for name, width in (("scalar_head", 1), ("field_head", 2)):
            self.add_module(f"{name}_fc1", dense(lc, lc, use_bias=False, generator=g))
            self.add_module(f"{name}_fc2", dense(lc, width, generator=g))

    def forward(self, x, pos, pad_mask, bound_mask):
        relu = torch.relu
        mask_f = pad_mask[..., None]
        bound = bound_mask[..., None].to(x.dtype)
        h = _masked(self.emb_fc2(relu(self.emb_fc1(x))), mask_f)
        h = self.s_transformer(h, pos, mask=pad_mask)
        z = _masked(self.enc_out_fc2(relu(self.enc_out_fc1(h))), mask_f)

        c = gelu(self.coord_fc1(torch.cat([pos, bound], dim=-1)))
        c = self.coord_fc3(gelu(self.coord_fc2(c)))
        d = c + self.decoding_xattn(c, z, pos, pos, mask=pad_mask)
        d = d + self.mix_attn(d, pos, mask=pad_mask)
        d = self.dec_out_fc2(relu(self.dec_out_fc1(torch.cat([d, bound], dim=-1))))

        def head(name):
            t = getattr(self, f"{name}_fc2")(relu(getattr(self, f"{name}_fc1")(d)))
            return _masked(t, mask_f)
        return head("scalar_head"), head("field_head")


class Conv1d(nn.Module):
    """flax ``nn.Conv`` over (batch, length, features), no bias: kernel
    (k, in, out), cross-correlation as flax's."""

    def __init__(self, in_features: int, features: int, k: int, stride: int = 1,
                 padding: int = 0, generator=None):
        super().__init__()
        fan_in, fan_out = k * in_features, k * features
        bound = math.sqrt(6.0 / (fan_in + fan_out))  # flax's is lecun_normal
        self.kernel = nn.Parameter(torch.empty(k, in_features, features).uniform_(
            -bound, bound, generator=generator))
        self.stride, self.padding = stride, padding

    def forward(self, x):
        y = nn.functional.conv1d(x.transpose(1, 2), self.kernel.permute(2, 1, 0),
                                 stride=self.stride, padding=self.padding)
        return y.transpose(1, 2)


class Embed(nn.Module):
    """flax ``nn.Embed``: ``embedding`` (num, features)."""

    def __init__(self, num: int, features: int, generator=None):
        super().__init__()
        self.embedding = nn.Parameter(torch.randn(num, features, generator=generator)
                                      / math.sqrt(features))

    def forward(self, idx):
        return self.embedding[idx]


class OFormerIrregST2D(nn.Module):
    """Time-dependent operator on irregular point clouds (airfoil class):
    (x (B,T,N,C), node_type (B,N) int, pos (B,N,2), forward_steps,
    pad_mask=None) -> (B, forward_steps, N, out)."""

    def __init__(self, input_channels: int, out_channels: int, time_window: int = 4,
                 max_node_type: int = 3, emb_dim: int = 64, latent_channels: int = 64,
                 heads: int = 1, depth: int = 2, res: int = 200, ff_scale: float = 8.0,
                 generator=None):
        super().__init__()
        g, lc, e = generator, latent_channels, emb_dim
        half = max(time_window // 2, 1)
        self.emb_dim = e
        self.t_conv1 = Conv1d(input_channels, e, 3, stride=2, padding=1, generator=g)
        self.t_conv2 = Conv1d(e, e, half, stride=half, generator=g)
        self.t_conv3 = Conv1d(e, e, 1, generator=g)
        self.node_emb = Embed(max_node_type, e, generator=g)
        self.combine = dense(e, e, use_bias=False, generator=g)
        scales = ([32, 16, 8, 8] + [1] * (depth - 4)) if depth > 4 else (
            [32] + [16] * max(depth - 2, 0) + [1])
        self.s_transformer = GalerkinTransformer(e, depth, heads, e, e,
                                                 scales=tuple(scales[:depth]),
                                                 min_freq=1 / res, generator=g)
        self.enc_ln = LayerNorm(e)
        self.enc_out = dense(e, lc, use_bias=False, generator=g)
        self.dec_node_emb = Embed(max_node_type, lc, generator=g)
        self.coord_ff = GaussianFourierFeatureTransform(2, lc // 2, ff_scale, g)
        self.coord_fc1 = dense(lc, lc, use_bias=False, generator=g)
        self.coord_fc2 = dense(lc, lc, use_bias=False, generator=g)
        self.dec_combine = dense(2 * lc, lc, use_bias=False, generator=g)
        self.decoding_xattn = CrossLinearAttention(lc, lc, "galerkin", heads=4, dim_head=lc,
                                                   scale=32.0, min_freq=1 / res, generator=g)
        self.mix_attn = LinearAttention(lc, lc, "galerkin", heads=1, dim_head=lc, scale=32.0,
                                        min_freq=1 / res, generator=g)
        self.expand = dense(lc, 2 * lc, use_bias=False, generator=g)
        self.prop_ln = LayerNorm(2 * lc)
        for i in range(4):
            self.add_module(f"prop_fc{i}", dense(3 * lc + 2 if i == 0 else 2 * lc, 2 * lc,
                                                 use_bias=False, generator=g))
        self.out_ln = LayerNorm(2 * lc)
        self.out_fc1 = dense(3 * lc, 2 * lc, use_bias=False, generator=g)
        self.out_fc2 = dense(2 * lc, lc, use_bias=False, generator=g)
        self.out_fc3 = dense(lc, out_channels, generator=g)

    def forward(self, x, node_type, pos, forward_steps: int, pad_mask=None):
        b, t, n, c = x.shape
        h = x.permute(0, 2, 1, 3).reshape(b * n, t, c)
        h = gelu(self.t_conv1(h))
        h = gelu(self.t_conv2(h))
        h = self.t_conv3(h)
        h = h.reshape(b, n, -1, self.emb_dim)[:, :, 0]
        h = self.combine(h + self.node_emb(node_type))
        h = self.enc_ln(self.s_transformer(h, pos, mask=pad_mask) + h)
        z = self.enc_out(h)

        z_node = self.dec_node_emb(node_type)
        cf = self.coord_fc2(gelu(self.coord_fc1(self.coord_ff(pos))))
        cf = self.dec_combine(torch.cat([cf, z_node], dim=-1))
        d = self.decoding_xattn(cf, z, pos, pos, mask=pad_mask)
        d = d + self.mix_attn(d, pos, mask=pad_mask)
        d = self.expand(d)

        frames = []
        for _ in range(forward_steps):
            hc = torch.cat([self.prop_ln(d), z_node, pos], dim=-1)
            for i in range(4):
                hc = getattr(self, f"prop_fc{i}")(hc)
                hc = gelu(hc) if i < 3 else hc
            d = hc + d
            u = torch.cat([self.out_ln(d), z_node], dim=-1)
            u = torch.relu(self.out_fc1(u))
            u = torch.relu(self.out_fc2(u))
            frames.append(self.out_fc3(u))
        out = torch.stack(frames, dim=1)
        if pad_mask is not None:
            out = _masked(out, pad_mask[:, None, :, None])
        return out
