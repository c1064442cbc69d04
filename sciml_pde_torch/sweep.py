"""Sweep runner: dataset-size presets x seeds (port of ``sciml_pde_tpu/sweep.py``).

Replaces the reference's shell-level sweeps
(``pdebench/models/run_forward_rd.sh``, ``run_forward_ns.sh``: per-GPU Hydra
launches over ``basic_ds{2..128}`` and seeds {16, 99, 17}, with aux /
spatiotemporal-downsample (ts_down) / decomposed-downsample (tsdecomp_down)
/ Lie-augmented (fno_lie) variants) by an in-process loop over the port's
``run_training``, each run on ``device`` (the card unless ``cpu``).

Example:
  python -m sciml_pde_torch.sweep --config config_dr --variant aux \\
      --presets basic_ds2 basic_ds8 --seeds 16 99 17 -- epochs=50
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from sciml_pde_torch.utils.config import load_config

VARIANTS = {
    "baseline": {"if_aux": False},
    "aux": {"if_aux": True},
    # spatiotemporal-downsampled full-physics aux (reference
    # fno_aux/utils_2d_rd.py:41) vs decomposed+downsampled aux (the
    # transformer Downsampled/ dirs' downsample_filename)
    "ts_down": {"if_aux": True, "if_downsample": True,
                "aux_file": "2D_diff-react_downsample_t50_96.h5"},
    "tsdecomp_down": {"if_aux": True, "if_downsample": True,
                      "aux_file": "2D_diff-react_decomp_downsample.h5"},
    "fno_lie": {"if_aux": False, "lie_augment": True},
}
DEFAULT_SEEDS = (16, 99, 17)


def run_sweep(
    config: str,
    presets: list[str],
    seeds=DEFAULT_SEEDS,
    variant: str = "aux",
    overrides: list[str] | None = None,
    out_path: str = "sweep_results.json",
    device=None,
):
    """One ``run_training`` per (preset, seed) under ``variant``; the
    results (preset, seed, variant, best_val, history) go to ``out_path``
    after each run.  An option the trainer does not take raises its own
    ``NotImplementedError``."""
    from sciml_pde_torch.train.cli import _call_with_supported
    from sciml_pde_torch.train.fno_train import run_training

    results = []
    for preset in presets:
        for seed in seeds:
            cfg = load_config(config, preset, overrides)
            cfg.update(VARIANTS[variant])
            cfg["seed"] = int(seed)
            cfg["model_name"] = f"{Path(config).stem}_{preset}_s{seed}_{variant}"
            cfg["device"] = device
            res = _call_with_supported(run_training, cfg)
            results.append(
                {
                    "preset": preset,
                    "seed": int(seed),
                    "variant": variant,
                    "best_val": float(res.best_val),
                    "history": res.history,
                }
            )
            Path(out_path).write_text(json.dumps(results, indent=1))
            print(f"{preset} seed={seed}: best_val={res.best_val:.6f}", flush=True)
    return results


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default="config_dr")
    p.add_argument("--variant", choices=sorted(VARIANTS), default="aux")
    p.add_argument("--presets", nargs="+", default=["basic_ds2", "basic_ds4", "basic_ds8"])
    p.add_argument("--seeds", nargs="+", type=int, default=list(DEFAULT_SEEDS))
    p.add_argument("--out", default="sweep_results.json")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("overrides", nargs="*")
    a = p.parse_args(argv)
    run_sweep(a.config, a.presets, a.seeds, a.variant, a.overrides, a.out, device=a.device)


if __name__ == "__main__":
    main()
