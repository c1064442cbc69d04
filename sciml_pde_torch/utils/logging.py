"""Scalar logging: JSONL file + stdout (port of ``sciml_pde_tpu/utils/logging.py``).

Each record is one JSON line in ``{run_dir}/{name}.jsonl`` with ``step``,
``sim_hours`` (wall-clock hours since the logger was made) and the logged
scalars as floats, echoed to stdout.  The trainers log the training scalars
when ``log_every`` crosses and ``val_loss`` on every validated epoch.
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path


def print_line(text: str) -> None:
    """``text`` and its newline to stdout in one write, flushed.  Under
    ``torchrun`` every rank writes to the launcher's one stdout; ``print``
    writes a line's text and its newline apart, so another rank's line can
    land between them and tear both (a write of one line is whole)."""
    sys.stdout.write(text + "\n")
    sys.stdout.flush()


class MetricLogger:
    """JSONL + stdout, with optional wandb / TensorBoard side-sinks.

    A side-sink runs only when it is asked for AND importable, so the
    package needs neither:
      - wandb: ``wandb=True`` (or env ``SCIML_WANDB=1``), ``sim_hours`` as a
        custom step metric;
      - TensorBoard: ``tensorboard=True`` (or ``SCIML_TENSORBOARD=1``),
        through torch's ``SummaryWriter`` under ``{run_dir}/tb/{name}``.
    """

    def __init__(self, run_dir: str | Path, name: str = "train", echo_every: int = 1,
                 wandb: bool | None = None, tensorboard: bool | None = None):
        self.dir = Path(run_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.path = self.dir / f"{name}.jsonl"
        self.t0 = time.time()
        self.echo_every = echo_every
        self._n = 0
        self.name = name

        if wandb is None:
            wandb = os.environ.get("SCIML_WANDB", "") == "1"
        if tensorboard is None:
            tensorboard = os.environ.get("SCIML_TENSORBOARD", "") == "1"

        self._wandb = None
        if wandb:
            try:
                import wandb as _wandb

                self._wandb = _wandb
                self._wandb.init(
                    project=os.environ.get("SCIML_WANDB_PROJECT", "sciml-pde-torch"),
                    name=name, dir=str(self.dir), resume="allow",
                )
                self._wandb.define_metric("sim_hours")
            except Exception:
                self._wandb = None

        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=str(self.dir / "tb" / name))
            except Exception:
                self._tb = None

    def log(self, step: int, **scalars) -> None:
        rec = {"step": step, "sim_hours": (time.time() - self.t0) / 3600.0}
        rec.update({k: float(v) for k, v in scalars.items()})
        with self.path.open("a") as f:
            f.write(json.dumps(rec) + "\n")
        if self._wandb is not None:
            self._wandb.log(rec, step=step)
        if self._tb is not None:
            for k, v in rec.items():
                if k != "step":
                    self._tb.add_scalar(k, v, global_step=step)
        self._n += 1
        if self._n % self.echo_every == 0:
            print_line(" ".join(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                                for k, v in rec.items()))

    def close(self) -> None:
        if self._wandb is not None:
            self._wandb.finish()
        if self._tb is not None:
            self._tb.close()
