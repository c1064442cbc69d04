"""A tiny DR primary file for the comparison trainers' CPU tests, written
through the JAX package's seed-group writer (h5py): 10 seeds (the 90/10
split's 9 train and 1 test) of (7, 16, 16, 2) frames."""

import numpy as np


def write_dr(folder) -> str:
    from sciml_pde_tpu.io.h5 import write_seed_group

    rng = np.random.default_rng(0)
    lin = np.linspace(0, 1, 16, dtype=np.float32)
    for s in range(10):
        base = rng.normal(size=(1, 16, 16, 2)).astype(np.float32)
        frames = base + 0.1 * np.cumsum(rng.normal(size=(7, 16, 16, 2)), 0).astype(np.float32)
        write_seed_group(folder / "2D_diff-react_test_all.h5", s, frames, lin, lin,
                         np.linspace(0, 1, 7, dtype=np.float32))
    return str(folder) + "/"


def write_dr128(folder, frames: int = 33) -> str:
    """The DR files the study drivers read, at the shape they hard-code
    (128^2, 2 channels): 10 primary seeds (9 train, 1 test) of ``frames``
    frames, enough for the diagnostics' t0 = 20 window and 3 rollout steps,
    and 4 seeds of the diff form (basic_ds2's aux pool takes 3)."""
    from sciml_pde_tpu.io.h5 import write_seed_group

    rng = np.random.default_rng(1)
    lin = np.linspace(0, 1, 128, dtype=np.float32)
    t = np.linspace(0, 1, frames, dtype=np.float32)
    for name, n in (("2D_diff-react_test_all.h5", 10), ("2D_diff-react_test_diff.h5", 4)):
        for s in range(n):
            base = rng.normal(size=(1, 128, 128, 2)).astype(np.float32)
            steps = rng.normal(size=(frames, 128, 128, 2)).astype(np.float32)
            write_seed_group(folder / name, s, base + 0.1 * np.cumsum(steps, 0), lin, lin, t)
    return str(folder) + "/"
