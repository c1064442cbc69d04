"""2D diffusion-reaction loaders, primary and aux (port of
``sciml_pde_tpu/data/dr.py``).

Single HDF5 files keyed by zero-padded seed groups; 90/10 train/test split
by sorted key order; ``train_subsample`` keeps the first N train keys (a
float < 1 keeps that fraction; a float >= 1 is a count, as an int is) and
raises when the pool holds fewer.  ``extra_train_files`` continue the train
pool past the primary file's seeds while its split, and so the test set,
stays the same; ``leaky_clip`` reproduces the reference's unguarded
``sorted(keys)[:N]`` train list, test tail included (for measuring that
leak only).  The aux loader pairs primary trajectory ``p`` with aux rows
``p * num_aux + j`` (the train step does the pairing) and upsamples an aux
file of another resolution trilinearly to the primary's.  The selected
trajectories become device tensors.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from sciml_pde_torch.data.windows import WindowedTrajectories
from sciml_pde_torch.io.h5 import list_seed_groups, read_seed_data, read_seed_grid

PRIMARY_FILE = "2D_diff-react_test_all.h5"
AUX_FILE = "2D_diff-react_test_diff.h5"
AUX_FILE_DOWNSAMPLED = "2D_diff-react_downsample_t50_96.h5"


@dataclasses.dataclass
class DRBaselineDataset:
    train: WindowedTrajectories
    test: WindowedTrajectories


@dataclasses.dataclass
class DRAuxDataset:
    """The two streams of aux joint training.  DR pairs by the default
    ``p * num_aux + j`` rule, so there is no row map."""
    primary_train: WindowedTrajectories
    primary_test: WindowedTrajectories
    aux_train: WindowedTrajectories


def _read_keys(path: Path, keys) -> np.ndarray:
    return np.stack([read_seed_data(path, k) for k in keys])


def _read_grid(path: Path, key: str) -> np.ndarray:
    g = read_seed_grid(path, key)
    gx, gy = np.meshgrid(g["x"], g["y"])  # (H, W) each; data is (H=Ny, W=Nx)
    return np.stack([gx, gy], axis=-1)


def _split_keys(keys: list[str]) -> tuple[list[str], list[str]]:
    """90/10 train/test by sorted key order."""
    n_train = int(0.9 * len(keys))
    return keys[:n_train], keys[n_train:]


def _resolve_count(n_keys: int, subsample) -> int:
    """Trajectories asked for: a float below 1 is a fraction of ``n_keys``
    (at least one), anything else a count (a float >= 1 truncated)."""
    if isinstance(subsample, float) and subsample < 1:
        return max(int(subsample * n_keys), 1)
    return int(subsample)


def load_dr_test(base_path: str, *, initial_step: int = 10, rollout_test: int = 1,
                 primary_file: str = PRIMARY_FILE, device=None) -> WindowedTrajectories:
    """The test split alone (the 10% tail, one window at t0 = 0 each), for
    evaluation, which reads nothing of the train pool."""
    path = Path(base_path) / primary_file
    train_keys, test_keys = _split_keys(list_seed_groups(path))
    grid = _read_grid(path, train_keys[0] if train_keys else test_keys[0])
    return WindowedTrajectories(_read_keys(path, test_keys), grid, initial_step=initial_step,
                                rollout=rollout_test, train=False, device=device)


def _load_train_pool(base: Path, primary_file: str, want, extra_train_files,
                     leaky_clip: bool = False) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Train pool (continued through ``extra_train_files``), test split and
    grid.  A fraction is resolved before any clip, so 0.5 means half the
    train split with and without ``leaky_clip``."""
    ppath = base / primary_file
    all_keys = list_seed_groups(ppath)
    train_keys, test_keys = _split_keys(all_keys)
    if leaky_clip:
        train_keys = all_keys
    grid = _read_grid(ppath, train_keys[0] if train_keys else test_keys[0])
    want = _resolve_count(len(train_keys), want)
    if leaky_clip:  # the reference clips silently where N exceeds the file
        want = min(want, len(all_keys))

    chunks = [_read_keys(ppath, train_keys[:min(want, len(train_keys))])]
    got = chunks[0].shape[0]
    for name in extra_train_files or []:
        if got >= want:
            break
        epath = base / name
        chunk = _read_keys(epath, list_seed_groups(epath)[:want - got])
        chunks.append(chunk)
        got += chunk.shape[0]
    if got < want:
        raise ValueError(
            f"requested {want} train trajectories but only {got} available in "
            f"{primary_file} (+{len(extra_train_files or [])} extension files)"
        )
    train = np.concatenate(chunks) if len(chunks) > 1 else chunks[0]
    return train, _read_keys(ppath, test_keys), grid


def load_dr_baseline(
    base_path: str,
    *,
    train_subsample=900,
    initial_step: int = 10,
    rollout_test: int = 1,
    extra_train_files: list[str] | None = None,
    primary_file: str = PRIMARY_FILE,
    leaky_clip: bool = False,
    device=None,
    to_device: bool = True,
) -> DRBaselineDataset:
    """Train = the first ``train_subsample`` trajectories of the pool, test =
    the 10% tail with one window at t0 = 0 per trajectory.  ``to_device=False``
    keeps the train store in host RAM (host streaming, pool rotation); the
    test store goes to ``device``."""
    train, test, grid = _load_train_pool(Path(base_path), primary_file, train_subsample,
                                         extra_train_files, leaky_clip=leaky_clip)
    return DRBaselineDataset(
        train=WindowedTrajectories(train, grid, initial_step=initial_step,
                                   rollout=rollout_test, train=True, device=device,
                                   to_device=to_device),
        test=WindowedTrajectories(test, grid, initial_step=initial_step,
                                  rollout=rollout_test, train=False, device=device),
    )


def _linear_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) weights of ``jax.image.resize(..., "linear")`` along one
    axis, in f64: a triangle kernel at the output samples, widened by the
    scale where the axis shrinks (JAX antialiases), columns normalised to
    sum to 1, and zero where a sample falls outside the input."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(n_out) + 0.5) * inv_scale - 0.5
    w = np.maximum(0.0, 1.0 - np.abs(sample[None, :] - np.arange(n_in)[:, None]) / kernel_scale)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1.0), 0.0)
    return np.where(((sample >= -0.5) & (sample <= n_in - 0.5))[None, :], w, 0.0)


def resize_linear(x: torch.Tensor, sizes: dict[int, int]) -> torch.Tensor:
    """JAX's linear ``jax.image.resize`` of ``x`` along each ``axis: n_out``
    of ``sizes``: one product per axis that changes, with weights built in
    f64 and applied in f32 on ``x``'s device.  It equals ``F.interpolate``'s
    linear modes (``align_corners=False``) where every axis grows; where one
    shrinks, JAX's kernel, and so this one, antialiases."""
    x = x.float()
    for axis, n_out in sizes.items():
        n_in = x.shape[axis]
        if n_in == n_out:
            continue
        w = torch.as_tensor(_linear_weights(n_in, n_out), dtype=torch.float32,
                            device=x.device)
        x = torch.movedim(torch.tensordot(x, w, dims=([axis], [0])), -1, axis)
    return x.contiguous()


def _resize_trilinear(data, target_thw: tuple[int, int, int], device=None) -> torch.Tensor:
    """(N, T', H', W', C) -> (N, T, H, W, C) on ``device`` (``resize_linear``
    over axes 1-3)."""
    x = torch.as_tensor(data, device=device)
    return resize_linear(x, dict(zip((1, 2, 3), target_thw)))


def load_dr_aux(
    base_path: str,
    aux_path: str | None = None,
    *,
    train_subsample=(900, 900, 900),
    num_aux_samples: int = 3,
    initial_step: int = 10,
    rollout_test: int = 1,
    if_downsample: bool = False,
    extra_train_files: list[str] | None = None,
    primary_file: str = PRIMARY_FILE,
    aux_file: str | None = None,
    device=None,
    to_device: bool = True,
) -> DRAuxDataset:
    """Two-stream DR dataset for aux joint training: ``train_subsample[1]``
    primary and ``train_subsample[2]`` aux trajectories.  The aux pool must
    hold ``n_primary * num_aux_samples`` rows; an aux file of another
    resolution (``if_downsample`` picks the downsampled one) is upsampled to
    the primary's T x H x W on ``device`` (with ``to_device=False`` on the
    CPU, and both train stores stay in host RAM; the test store goes to
    ``device``)."""
    base = Path(base_path)
    apath = Path(aux_path) if aux_path else base
    primary_train, primary_test, grid = _load_train_pool(base, primary_file,
                                                         train_subsample[1], extra_train_files)
    aux_name = aux_file or (AUX_FILE_DOWNSAMPLED if if_downsample else AUX_FILE)
    aux_keys = list_seed_groups(apath / aux_name)
    aux = _read_keys(apath / aux_name, aux_keys[:_resolve_count(len(aux_keys),
                                                                  train_subsample[2])])
    need = primary_train.shape[0] * num_aux_samples
    if aux.shape[0] < need:
        raise ValueError(f"aux pool has {aux.shape[0]} trajectories < "
                         f"{primary_train.shape[0]} primary x {num_aux_samples} aux samples")
    if if_downsample or aux.shape[1:4] != primary_train.shape[1:4]:
        aux = _resize_trilinear(aux, primary_train.shape[1:4],
                                device=device if to_device else "cpu")

    def windows(data, train):
        return WindowedTrajectories(data, grid, initial_step=initial_step,
                                    rollout=rollout_test, train=train, device=device,
                                    to_device=to_device or not train)

    return DRAuxDataset(primary_train=windows(primary_train, True),
                        primary_test=windows(primary_test, False),
                        aux_train=windows(aux, True))
