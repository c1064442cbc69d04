"""Rollout trajectory export for visualization (port of
``sciml_pde_tpu/eval/prediction.py``; reference
``pdebench/models/fno_aux/prediction_2d_ns.py:121-170`` and its _2d_dr/_3d_ns
twins): unroll the model over each test trajectory, feeding predictions
back, and write one HDF5 file of the predicted fields per sample.  The
unroll runs on the device with ``eval/rollout.py::rollout_predict``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from sciml_pde_torch._device import resolve_device
from sciml_pde_torch.data.windows import WindowedTrajectories, gather_windows
from sciml_pde_torch.eval.rollout import rollout_predict
from sciml_pde_torch.io import h5 as h5io


@torch.no_grad()
def export_rollout_trajectories(
    apply_fn,
    params,
    test: WindowedTrajectories,
    steps: int,
    out_dir: str | Path,
    prefix: str = "2D_NS_pred_trj",
    batch_size: int = 4,
    device=None,
) -> list[Path]:
    """Write ``{prefix}_sample{i}.h5`` with dataset 'data' (steps, *spatial,
    C) per test trajectory; ``apply_fn(params, x, grid)`` is the one-step
    operator.  Runs on ``device`` (the card unless ``"cpu"``)."""
    dev = resolve_device(device)
    h5py = h5io.h5py_module()
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    data, grid = test.data.to(dev), test.grid.to(dev)
    idx = torch.as_tensor(test.window_index(), dtype=torch.long, device=dev)
    paths = []
    for b in range(0, len(idx), batch_size):
        chunk = idx[b : b + batch_size]
        x, _ = gather_windows(data, chunk, test.initial_step, 0)
        gb = grid.expand(chunk.shape[0], *grid.shape)
        preds = rollout_predict(lambda a, g: apply_fn(params, a, g), x.float(), gb, steps)
        preds = preds.cpu().numpy()  # (B, *spatial, steps, C)
        for j in range(preds.shape[0]):
            path = out_dir / f"{prefix}_sample{b + j}.h5"
            traj = np.moveaxis(preds[j], -2, 0)  # (steps, *spatial, C)
            with h5py.File(path, "w") as f:
                f.create_dataset("data", data=traj, compression="lzf")
            paths.append(path)
    return paths
