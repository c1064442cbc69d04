"""Masked-SSL (VideoMAE-style) pretraining of the transformer operator (port
of ``sciml_pde_tpu/train/ssl_pretrain.py``).

Each step masks a fixed share of every window's tokens at random, encodes
the visible ones, decodes them with a mask token at every masked position
and takes the MSE of ``head_ssl``'s pixels against the masked tokens of the
normalised window.  The optimizer is optax ``adamw`` on a cosine decay over
all steps (``train/optim.py::AdamW``).  The checkpoint
``{run_dir}/{model_name}_ckpt`` holds the parameters the masked branch
uses (the flax tree of an SSL init: no ``head``), which the operator
trainers overlay through ``pretrained_path``.

On the NS recipe (1280 tokens, mask ratio 0.75) the encoder sees 320
tokens, a count the JAX package's shape rule sends to ``jnp_attention``;
the decoder's 1280 take the flash-attention kernels.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from sciml_pde_torch._device import resolve_device
from sciml_pde_torch.data.windows import WindowedTrajectories, epoch_batches, gather_windows
from sciml_pde_torch.models.common import instance_norm_stats
from sciml_pde_torch.models.transformer import VideoMAEOperator, patchify
from sciml_pde_torch.train.optim import AdamW, make_lr_schedule
from sciml_pde_torch.utils.checkpoint import save_checkpoint
from sciml_pde_torch.utils.logging import MetricLogger
from sciml_pde_torch.utils.weights import (
    transformer_flax_to_state_dict,
    transformer_state_dict_to_flax,
)


def make_tube_mask(generator: torch.Generator, b: int, n_tokens: int, mask_ratio: float,
                   device=None) -> torch.Tensor:
    """(b, n_tokens) bool, True = masked: in each row the
    ``round(n_tokens * mask_ratio)`` tokens of the largest uniform scores
    drawn from ``generator``."""
    n_masked = int(round(n_tokens * mask_ratio))
    scores = torch.rand((b, n_tokens), generator=generator, device=generator.device).to(device)
    if n_masked == 0:
        return torch.zeros_like(scores, dtype=torch.bool)
    thresh = torch.sort(scores, dim=1).values[:, n_tokens - n_masked, None]
    return scores >= thresh


def ssl_loss(model: VideoMAEOperator, x: torch.Tensor, mask: torch.Tensor, n_masked: int):
    """MSE of the masked branch's pixels (B, n_masked, patch) against the
    masked tokens of the instance-normalised window x (B, T, H, W, C)."""
    pred = model(x, mask, True, None, n_masked)
    std, mean = instance_norm_stats(x, (1, 2, 3))
    tokens = patchify((x - mean) / std, model.tubelet_size, model.patch_size)
    n = tokens.shape[1]
    idx = torch.argsort(mask.to(torch.int8), dim=1, stable=True)[:, n - n_masked:, None]
    target = torch.gather(tokens, 1, idx.expand(-1, -1, tokens.shape[2]))
    return torch.mean((pred - target) ** 2)


def ssl_parameters(model: VideoMAEOperator) -> dict[str, torch.Tensor]:
    """The parameters the masked branch reaches: all but ``head``."""
    return {n: p for n, p in model.named_parameters() if not n.startswith("head.")}


def run_ssl_pretraining(
    train_w: WindowedTrajectories,
    *,
    model_kwargs: dict,
    mask_ratio: float = 0.75,
    initial_step: int = 10,
    batch_size: int = 4,
    epochs: int = 10,
    learning_rate: float = 1.5e-4,
    run_dir: str = "runs/ssl",
    model_name: str = "vmae_ssl",
    seed: int = 16,
    log_every: int = 100,
    init_params: dict | None = None,
    device=None,
):
    """Pretrain ``VideoMAEOperator(**model_kwargs, ssl=True)`` on the windows
    of ``train_w``; returns (the flax-layout tree, the per-epoch history).

    Batches come from ``numpy.random.default_rng(seed)`` as in JAX; masks
    from a ``torch.Generator`` on the device seeded with ``seed``.
    ``init_params`` (an SSL flax tree) replaces the seeded
    initialisation."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    logger = MetricLogger(run_dir, name=model_name)
    model = VideoMAEOperator(**model_kwargs, ssl=True,
                             generator=torch.Generator().manual_seed(seed))
    if init_params is not None:
        sd = model.state_dict()
        sd.update(transformer_flax_to_state_dict(init_params))
        model.load_state_dict(sd)
    model.to(dev)
    params = ssl_parameters(model)
    tubelet, patch = model.tubelet_size, model.patch_size
    h, w = train_w.data.shape[2:4]
    n_tokens = (initial_step // tubelet) * (h // patch) * (w // patch)
    n_masked = int(round(n_tokens * mask_ratio))
    idx = train_w.window_index()
    total = max(epochs * (len(idx) // batch_size), 1)
    opt = AdamW(params, make_lr_schedule("cosine", learning_rate, total), weight_decay=1e-4)
    masks = torch.Generator(device=dev).manual_seed(seed)

    gstep, history, loss = 0, [], None
    for ep in range(epochs):
        batches = torch.as_tensor(np.stack(list(epoch_batches(idx, batch_size, rng))),
                                  dtype=torch.long, device=dev)
        for bidx in batches:
            x, _ = gather_windows(train_w.data, bidx, initial_step, 0)
            x = torch.movedim(x.float(), -2, 1)
            mask = make_tube_mask(masks, x.shape[0], n_tokens, mask_ratio, dev)
            loss = ssl_loss(model, x, mask, n_masked)
            grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
            opt.step(params, grads)
            loss = loss.detach()
            gstep += 1
            if log_every and gstep % log_every == 0:
                logger.log(gstep, ssl_loss=float(loss), epoch=ep)
        history.append({"epoch": ep, "ssl_loss": float(loss)})
    tree = transformer_state_dict_to_flax(params)
    save_checkpoint(Path(run_dir) / f"{model_name}_ckpt", tree,
                    opt.optax_tree(opt.state_dict(), transformer_state_dict_to_flax), epochs,
                    float(loss))
    return tree, history
