"""The DR VideoMAE that the study drivers share (``dr_transformer``,
``dr_convention_eval``, ``dr_vchannel_diag``, ``dr_early_window_finetune``):
the reference's shape (128^2, patch 16, tubelet 1, 2 channels, 10 frames:
640 tokens, which the attention's shape rule sends to the plain path), its
width flags, the DR test split and the autoregressive loop."""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch


def add_width_args(p: argparse.ArgumentParser, encoder=(1024, 16, 16),
                   decoder=(512, 8, 8)) -> None:
    """``--encoder-dim/-depth/-heads`` and ``--decoder-dim/-depth/-heads``
    with the given defaults (the diagnostics' are the reference's full
    width, ``dr_transformer``'s a mid-size one)."""
    for part, (dim, depth, heads) in (("encoder", encoder), ("decoder", decoder)):
        p.add_argument(f"--{part}-dim", type=int, default=dim)
        p.add_argument(f"--{part}-depth", type=int, default=depth)
        p.add_argument(f"--{part}-heads", type=int, default=heads)


def build(a, dtype: torch.dtype, params, device=None, aux: bool = False):
    """The DR ``VideoMAEOperator`` (``aux``: ``VideoMAEOperatorAux`` with the
    shared head) at the widths of ``a``, computing in ``dtype``, holding the
    flax-layout ``params``, on ``device``, in eval mode.  It is built on the
    meta device and takes ``params`` as its tensors: an initialisation that
    they would overwrite costs seconds at the reference's width."""
    from sciml_pde_torch.models.transformer import VideoMAEOperator, VideoMAEOperatorAux
    from sciml_pde_torch.utils.weights import transformer_flax_to_state_dict

    mk = dict(img_size=128, patch_size=16, tubelet_size=1, in_chans=2, num_frames=10,
              encoder_dim=a.encoder_dim, encoder_depth=a.encoder_depth,
              encoder_heads=a.encoder_heads, decoder_dim=a.decoder_dim,
              decoder_depth=a.decoder_depth, decoder_heads=a.decoder_heads, dtype=dtype)
    with torch.device("meta"):
        model = VideoMAEOperatorAux(**mk, shared_head=True) if aux else VideoMAEOperator(**mk)
    model.load_state_dict(transformer_flax_to_state_dict(params), assign=True)
    return model.to(device).eval()


def dtype_of(precision: str) -> torch.dtype:
    return torch.bfloat16 if precision == "bf16" else torch.float32


def load_test(data: str) -> np.ndarray:
    """The DR test split (the primary file's 10% tail), (N, T, H, W, C)."""
    from sciml_pde_torch.data.dr import PRIMARY_FILE, _load_train_pool

    return np.asarray(_load_train_pool(Path(data), PRIMARY_FILE, 1, None)[1])


@torch.no_grad()
def roll(model, x0: torch.Tensor, steps: int) -> list[torch.Tensor]:
    """``steps`` predictions (B, H, W, C) from the window x0 (B, 10, H, W, C),
    each slid into the window for the next."""
    xx, preds = x0, []
    for _ in range(steps):
        pred = model(xx)
        xx = torch.cat([xx[:, 1:], pred[:, None]], dim=1)
        preds.append(pred)
    return preds


def per_channel_nrmse(pred: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """Reference metrics.py:40-45: per-(sample, channel) RMSE over space over
    the target's RMS, averaged over samples; (C,)."""
    axes = tuple(range(1, pred.ndim - 1))
    rmse = torch.sqrt(torch.mean((pred - tgt) ** 2, dim=axes))
    nrm = torch.sqrt(torch.mean(tgt**2, dim=axes)) + 1e-7
    return torch.mean(rmse / nrm, dim=0)
