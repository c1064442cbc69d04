"""VideoMAE-style spatio-temporal transformer operators, baseline and aux
(port of ``sciml_pde_tpu/models/transformer.py``).

Parameters keep the flax layout and names, so a flax tree maps onto the
``state_dict`` by joining its keys with dots
(``encoder.block0.attn.qkv_kernel``): ``Dense`` kernels are ``(in, out)``,
``LayerNorm`` holds ``scale`` and ``bias``, and the qkv projection is one
``(dim, 3 * dim)`` kernel with biases on q and v only.

Mixed precision follows flax's ``dtype`` field with explicit casts: a
``Dense`` built with a ``dtype`` (qkv, ``proj``, ``fc1``, ``fc2``) casts its
input, kernel and bias to it and returns that type, so GELU runs on the
bf16 result; ``LayerNorm`` computes in f32; ``patch_proj``,
``encoder_to_decoder`` and ``head`` compute in f32; the residual sums
promote to f32.  Attention runs through ``ops.attention.flash_attention``.

``VideoMAEOperatorAux`` runs the shared trunk on a primary and an aux
stream, each instance-normalised on its own: as one concatenated batch when
the two have the same shape, else twice; then per-pixel ``head_primary`` /
``head_auxiliary`` (``shared_head=False``) or the trunk's frame for both.
``ssl=True`` adds ``head_ssl`` and ``mask_token`` and the masked-SSL branch
(``mask``); ``use_checkpoint`` recomputes each block in the backward pass.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from sciml_pde_torch.models.common import instance_norm_stats
from sciml_pde_torch.ops.attention import flash_attention, jnp_attention


@functools.lru_cache(maxsize=32)
def sinusoid_table(n_position: int, d_hid: int) -> np.ndarray:
    """Fixed sine-cosine table (reference transformer.py:234-244)."""
    pos = np.arange(n_position)[:, None]
    dim = np.arange(d_hid)[None, :]
    angle = pos / np.power(10000.0, 2 * (dim // 2) / d_hid)
    table = np.zeros((n_position, d_hid), dtype=np.float32)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table


def drop_path(x, rate: float, deterministic: bool, generator: torch.Generator | None):
    """Stochastic depth on the residual branch (per sample)."""
    if deterministic or rate == 0.0:
        return x
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    dev = x.device if generator is None else generator.device
    u = torch.rand(shape, generator=generator, device=dev).to(x.device)
    return torch.where(u < keep, x / keep, torch.zeros_like(x))


def _xavier(shape, generator) -> nn.Parameter:
    """flax ``xavier_uniform`` on an (in, out) kernel."""
    limit = math.sqrt(6.0 / (shape[0] + shape[1]))
    return nn.Parameter(torch.empty(shape).uniform_(-limit, limit, generator=generator))


class Dense(nn.Module):
    """flax ``nn.Dense``: kernel (in, out), zero bias; with ``dtype`` the
    input, kernel and bias are cast to it first."""

    def __init__(self, fan_in: int, features: int, use_bias: bool = True,
                 dtype: torch.dtype | None = None, generator=None):
        super().__init__()
        self.kernel = _xavier((fan_in, features), generator)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.dtype = dtype

    def forward(self, x):
        dt = self.dtype or torch.promote_types(x.dtype, self.kernel.dtype)
        y = torch.matmul(x.to(dt), self.kernel.to(dt))
        return y if self.bias is None else y + self.bias.to(dt)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(epsilon=1e-6, dtype=f32)``."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.eps = eps

    def forward(self, x):
        return nn.functional.layer_norm(x.float(), self.scale.shape, self.scale, self.bias,
                                        self.eps)


class Attention(nn.Module):
    """qkv projection with q and v biases (none on k), fused attention,
    output projection.  ``attn_impl``: ``flash`` (the kernels, with the JAX
    shape rule), ``jnp`` (``jnp_attention``) or ``plain`` (the fused path
    through the kernels' plain versions on any device)."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 dtype: torch.dtype = torch.float32, attn_impl: str = "flash", generator=None):
        super().__init__()
        if attn_impl not in ("flash", "jnp", "plain"):
            raise ValueError(f"unknown attn_impl {attn_impl!r}")
        self.dim, self.num_heads, self.dtype, self.attn_impl = dim, num_heads, dtype, attn_impl
        self.qkv_kernel = _xavier((dim, 3 * dim), generator)
        if qkv_bias:
            self.q_bias = nn.Parameter(torch.zeros(dim))
            self.v_bias = nn.Parameter(torch.zeros(dim))
        else:
            self.q_bias = self.v_bias = None
        self.proj = Dense(dim, dim, dtype=dtype, generator=generator)

    def forward(self, x):
        b, n, _ = x.shape
        hd = self.dim // self.num_heads
        scale = hd ** -0.5
        qkv = torch.matmul(x.to(self.dtype), self.qkv_kernel.to(self.dtype))
        if self.q_bias is not None:
            bias = torch.cat([self.q_bias, torch.zeros_like(self.q_bias), self.v_bias])
            qkv = qkv + bias.to(self.dtype)
        # (3, b, h, n, hd), one copy; q, k and v are contiguous slices of it
        qkv = qkv.reshape(b, n, 3, self.num_heads, hd).permute(2, 0, 3, 1, 4).contiguous()
        q, k, v = qkv[0], qkv[1], qkv[2]
        if self.attn_impl == "jnp":
            out = jnp_attention(q, k, v, scale)
        else:
            out = flash_attention(q, k, v, scale, plain=self.attn_impl == "plain")
        return self.proj(out.transpose(1, 2).reshape(b, n, self.dim))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype: torch.dtype, generator=None):
        super().__init__()
        self.fc1 = Dense(dim, hidden, dtype=dtype, generator=generator)
        self.fc2 = Dense(hidden, dim, dtype=dtype, generator=generator)

    def forward(self, x):
        return self.fc2(nn.functional.gelu(self.fc1(x), approximate="none"))


class Block(nn.Module):
    """Pre-norm block with drop-path and optional layer scale."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 drop_path_rate: float = 0.0, init_values: float = 0.0,
                 dtype: torch.dtype = torch.float32, attn_impl: str = "flash", generator=None):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, num_heads, qkv_bias, dtype, attn_impl, generator)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype, generator)
        self.drop_path_rate = drop_path_rate
        if init_values > 0:
            self.gamma_1 = nn.Parameter(torch.full((dim,), float(init_values)))
            self.gamma_2 = nn.Parameter(torch.full((dim,), float(init_values)))
        else:
            self.gamma_1 = self.gamma_2 = None

    def forward(self, x, deterministic: bool = True, generator=None):
        h = self.attn(self.norm1(x))
        if self.gamma_1 is not None:
            h = self.gamma_1 * h
        x = x + drop_path(h, self.drop_path_rate, deterministic, generator)
        h = self.mlp(self.norm2(x))
        if self.gamma_2 is not None:
            h = self.gamma_2 * h
        return x + drop_path(h, self.drop_path_rate, deterministic, generator)


class TokenStack(nn.Module):
    """``depth`` blocks ``block0 ..`` with drop-path rates rising linearly.

    ``use_checkpoint`` (flax ``nn.remat(Block)``) runs each block under
    ``torch.utils.checkpoint`` (non-reentrant): the backward pass recomputes
    the block's forward, attention kernels included, from its input.  As
    JAX's remat replays the block's dropout key, the recompute replays the
    drop-path draws: the generator's state before the block is restored for
    it, and the state the forward left is put back after it."""

    def __init__(self, dim: int, depth: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop_path_rate: float = 0.0, init_values: float = 0.0,
                 use_checkpoint: bool = False, dtype: torch.dtype = torch.float32,
                 attn_impl: str = "flash", generator=None):
        super().__init__()
        self.depth, self.use_checkpoint = depth, use_checkpoint
        dpr = np.linspace(0, drop_path_rate, depth)
        for i in range(depth):
            self.add_module(f"block{i}", Block(dim, num_heads, mlp_ratio, qkv_bias, float(dpr[i]),
                                               init_values, dtype, attn_impl, generator))

    def forward(self, x, deterministic: bool = True, generator=None):
        for i in range(self.depth):
            block = getattr(self, f"block{i}")
            if self.use_checkpoint and torch.is_grad_enabled():
                x = _checkpointed(block, x, deterministic, generator)
            else:
                x = block(x, deterministic, generator)
        return x


def _checkpointed(block, x, deterministic: bool, generator):
    """``block(x, deterministic, generator)`` under a non-reentrant
    checkpoint that replays the generator's draws in the recompute."""
    if deterministic or block.drop_path_rate == 0.0 or generator is None:
        return checkpoint(block, x, deterministic, None, use_reentrant=False)
    before = generator.get_state()
    calls = [0]

    def run(x):
        calls[0] += 1
        if calls[0] == 1:  # the forward: the generator advances as without remat
            return block(x, deterministic, generator)
        after = generator.get_state()
        generator.set_state(before)
        try:
            return block(x, deterministic, generator)
        finally:
            generator.set_state(after)

    return checkpoint(run, x, use_reentrant=False)


def patchify(x, tubelet: int, patch: int):
    """(B, T, H, W, C) -> tokens (B, T/tu * H/p * W/p, tu*p*p*C), features
    ordered (tubelet, py, px, channel)."""
    b, t, h, w, c = x.shape
    x = x.reshape(b, t // tubelet, tubelet, h // patch, patch, w // patch, patch, c)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(b, -1, tubelet * patch * patch * c)


def unpatchify(tokens, tubelet: int, patch: int, t: int, h: int, w: int, c: int):
    b = tokens.shape[0]
    x = tokens.reshape(b, t // tubelet, h // patch, w // patch, tubelet, patch, patch, c)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(b, t, h, w, c)


# flax ``truncated_normal``: a standard normal truncated to [-2, 2] has this
# std, so its draws are scaled by stddev / it
_TRUNC_STD = 0.87962566103423978


class VideoMAEOperator(nn.Module):
    """Baseline next-frame operator: x (B, T, H, W, C) -> (B, H, W, C).

    ``dtype`` is the compute type of the blocks' dense layers and attention
    (bf16 for mixed precision); parameters are f32.  ``generator`` draws the
    initial weights (flax's initialisers: xavier-uniform kernels, zero
    biases, unit norms, the mask token truncated-normal with std 0.02).

    With ``ssl=True`` and a ``mask`` (B, N) bool (True = masked, the same
    count ``n_masked`` in every row), ``forward`` is the masked-SSL branch:
    the visible tokens go through the encoder, the decoder sees them with a
    mask token at every masked position, and ``head_ssl`` returns the
    masked tokens' pixels (B, n_masked, tu*p*p*C) in normalised space."""

    def __init__(self, img_size: int = 256, patch_size: int = 16, tubelet_size: int = 2,
                 in_chans: int = 3, num_frames: int = 10, encoder_dim: int = 768,
                 encoder_depth: int = 12, encoder_heads: int = 12, decoder_dim: int = 512,
                 decoder_depth: int = 8, decoder_heads: int = 8, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop_path_rate: float = 0.0, init_values: float = 0.0,
                 use_checkpoint: bool = False, ssl: bool = False,
                 dtype: torch.dtype = torch.float32, attn_impl: str = "flash",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.img_size, self.num_frames = img_size, num_frames
        self.patch_size, self.tubelet_size, self.in_chans = patch_size, tubelet_size, in_chans
        self.encoder_dim, self.decoder_dim, self.ssl = encoder_dim, decoder_dim, ssl
        common = dict(mlp_ratio=mlp_ratio, qkv_bias=qkv_bias, drop_path_rate=drop_path_rate,
                      init_values=init_values, use_checkpoint=use_checkpoint, dtype=dtype,
                      attn_impl=attn_impl, generator=generator)
        self.encoder = TokenStack(encoder_dim, encoder_depth, encoder_heads, **common)
        self.decoder = TokenStack(decoder_dim, decoder_depth, decoder_heads, **common)
        patch_dim = tubelet_size * patch_size**2 * in_chans
        self.patch_proj = Dense(patch_dim, encoder_dim, generator=generator)
        self.encoder_norm = LayerNorm(encoder_dim)
        self.decoder_norm = LayerNorm(decoder_dim)
        self.encoder_to_decoder = Dense(encoder_dim, decoder_dim, use_bias=False,
                                        generator=generator)
        self.head = Dense(decoder_dim, patch_dim, generator=generator)
        if ssl:
            self.head_ssl = Dense(decoder_dim, patch_dim, generator=generator)
            token = torch.empty(1, 1, decoder_dim)
            nn.init.trunc_normal_(token, generator=generator)
            self.mask_token = nn.Parameter(token * (0.02 / _TRUNC_STD))
        self._pos: dict[tuple, torch.Tensor] = {}

    def _pos_table(self, n: int, dim: int, device) -> torch.Tensor:
        """The position table on ``device``, copied there once: a copy from
        host memory on every forward would wait for the card's queue to
        drain."""
        key = (n, dim, str(device))
        if key not in self._pos:
            self._pos[key] = torch.as_tensor(sinusoid_table(n, dim), device=device)
        return self._pos[key]

    def _tokens(self, xn):
        """normalised (B, T, H, W, C) -> encoder tokens with positions."""
        tokens = self.patch_proj(patchify(xn, self.tubelet_size, self.patch_size))
        return tokens + self._pos_table(tokens.shape[1], self.encoder_dim, tokens.device)[None]

    def _trunk_last_frame(self, xn, deterministic: bool, generator):
        """normalised (B, T, H, W, C) -> the trunk's last frame, normalised."""
        b, t, h, w, c = xn.shape
        tokens = self.encoder(self._tokens(xn), deterministic, generator)
        tokens = self.encoder_to_decoder(self.encoder_norm(tokens))
        tokens = self.decoder(tokens, deterministic, generator)
        pix = self.head(self.decoder_norm(tokens)).float()
        return unpatchify(pix, self.tubelet_size, self.patch_size, t, h, w, c)[:, -1]

    def forward(self, x, mask=None, deterministic: bool = True, generator=None,
                n_masked: int | None = None):
        std, mean = instance_norm_stats(x, (1, 2, 3))  # per (b, c) over T, H, W
        xn = (x - mean) / std
        if mask is not None:
            return self._masked(xn, mask, deterministic, generator, n_masked)
        return self._trunk_last_frame(xn, deterministic, generator) * std[:, 0] + mean[:, 0]

    def _masked(self, xn, mask, deterministic: bool, generator, n_masked: int | None):
        if not self.ssl:
            raise ValueError("the masked-SSL branch needs a model built with ssl=True")
        tokens = self._tokens(xn)
        b, n, _ = tokens.shape
        if n_masked is None:
            n_masked = int(mask.sum()) // b
        n_vis = n - n_masked
        # jnp.argsort(mask, stable=True): the visible tokens, then the masked
        # ones, each in token order
        order = torch.argsort(mask.to(torch.int8), dim=1, stable=True)
        vis_idx, mask_idx = order[:, :n_vis, None], order[:, n_vis:, None]
        vis = torch.gather(tokens, 1, vis_idx.expand(-1, -1, tokens.shape[2]))
        vis = self.encoder_to_decoder(self.encoder_norm(self.encoder(vis, deterministic,
                                                                     generator)))
        pos = self._pos_table(n, self.decoder_dim, tokens.device)[None].expand(b, -1, -1)
        pos_vis = torch.gather(pos, 1, vis_idx.expand(-1, -1, self.decoder_dim))
        pos_msk = torch.gather(pos, 1, mask_idx.expand(-1, -1, self.decoder_dim))
        full = torch.cat([vis + pos_vis, self.mask_token + pos_msk], dim=1)
        dec = self.decoder(full, deterministic, generator)
        return self.head_ssl(self.decoder_norm(dec[:, n_vis:])).float()


class VideoMAEOperatorAux(VideoMAEOperator):
    """Aux variant: ``forward(x, x_aux) -> (out_primary (B, H, W, C),
    out_aux (B2, H, W, C))``.

    ``shared_head=False`` (NS): per-pixel ``Dense(in_chans)``
    ``head_primary`` / ``head_auxiliary`` in f32 on the trunk's normalised
    last frame.  ``shared_head=True`` (DR): no heads, the trunk's frame
    serves both streams.  Each stream is de-normalised by its own
    statistics after its head."""

    def __init__(self, *args, shared_head: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        self.shared_head = shared_head
        if not shared_head:
            gen = kwargs.get("generator")
            self.head_primary = Dense(self.in_chans, self.in_chans, generator=gen)
            self.head_auxiliary = Dense(self.in_chans, self.in_chans, generator=gen)

    def _head(self, name: str, last):
        return last if self.shared_head else getattr(self, name)(last)

    def forward(self, x, x_aux, deterministic: bool = True, generator=None):
        std_p, mean_p = instance_norm_stats(x, (1, 2, 3))
        std_a, mean_a = instance_norm_stats(x_aux, (1, 2, 3))
        xn, xan = (x - mean_p) / std_p, (x_aux - mean_a) / std_a
        if xn.shape[1:] == xan.shape[1:]:
            # one trunk pass over the concatenated batch
            b = xn.shape[0]
            last = self._trunk_last_frame(torch.cat([xn, xan]), deterministic, generator)
            last_p, last_a = last[:b], last[b:]
        else:
            last_p = self._trunk_last_frame(xn, deterministic, generator)
            last_a = self._trunk_last_frame(xan, deterministic, generator)
        out_p = self._head("head_primary", last_p) * std_p[:, 0] + mean_p[:, 0]
        out_a = self._head("head_auxiliary", last_a) * std_a[:, 0] + mean_a[:, 0]
        return out_p, out_a

    def primary(self, x, deterministic: bool = True, generator=None):
        """``forward(x, x)[0]`` with the primary stream alone through the
        trunk: out_primary does not depend on the aux stream (instance norm
        and the trunk act per sample)."""
        std, mean = instance_norm_stats(x, (1, 2, 3))
        last = self._trunk_last_frame((x - mean) / std, deterministic, generator)
        return self._head("head_primary", last) * std[:, 0] + mean[:, 0]
