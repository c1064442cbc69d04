"""Aggregate the DR seed sweep into the data-efficiency figure (port of the
JAX package's ``experiments/dr_seed_figure.py``).

The reference's headline data-efficiency figure is mean +/- std of the
rollout-1 nRMSE over training seeds {16, 99, 17} across ``basic_dsN``
presets (``Plot Generator/random_seed_ns.py:30-39``).  The sweep
(``experiments/dr_parity.py --seed``) lands per-(preset, seed) rollout
tables in ``runs/dr_parity_ds{N}/summary.json`` under keys ``{variant}``
(the default-seed run, seed 16) and ``{variant}_s{seed}``; this driver
collects whatever subset exists and draws the figure (PIL, through
``plots/figures.py``) and a JSON aggregate, so it can be re-run as sweep
items land.  It reads and draws on the host alone.

  python -m sciml_pde_torch.experiments.dr_seed_figure [--presets 8 32 128] \\
      [--variants baseline aux] [--horizon 1] [--out docs/figures]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np


def collect(run_root: Path, presets, variants, seeds=(16, 99, 17)):
    """-> {variant: {preset: {seed: [r1..r5]}}} from the landed summaries."""
    table: dict = {}
    for n in presets:
        summary = run_root / f"dr_parity_ds{n}" / "summary.json"
        if not summary.exists():
            continue
        data = json.loads(summary.read_text())
        for variant in variants:
            for seed in seeds:
                # seed 16 is the default-seed run key (no suffix)
                key = variant if seed == 16 else f"{variant}_s{seed}"
                row = data.get(key)
                if row is None and seed == 16 and f"{variant}_s16" in data:
                    row = data[f"{variant}_s16"]
                if row and "rollout_nrmse" in row:
                    table.setdefault(variant, {}).setdefault(n, {})[seed] = row["rollout_nrmse"]
    return table


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--run-root", default="runs")
    p.add_argument("--presets", type=int, nargs="+", default=[2, 4, 8, 16, 32, 64, 128, 256])
    p.add_argument("--variants", nargs="+", default=["baseline", "aux"])
    p.add_argument("--horizon", type=int, default=1,
                   help="rollout horizon for the y-axis (1..5)")
    p.add_argument("--out", default="docs/figures")
    a = p.parse_args(argv)

    table = collect(Path(a.run_root), a.presets, a.variants)
    if not table:
        print("no landed dr_parity summaries found")
        return None

    # the figure's input: curve -> per-preset list of per-seed horizon-h
    # values; all variants share one x axis (the union of landed presets)
    h = a.horizon - 1
    all_presets = sorted({n for v in table.values() for n in v})
    curves, agg = {}, {}
    for variant, by_preset in table.items():
        curves[f"DR FNO {variant}"] = [
            [by_preset[n][s][h] for s in sorted(by_preset[n])]
            if n in by_preset else [float("nan")]  # a gap: the point is skipped
            for n in all_presets
        ]
        agg[variant] = {
            str(n): {
                "seeds": sorted(by_preset[n]),
                "nrmse_r1": [by_preset[n][s][h] for s in sorted(by_preset[n])],
                "mean": float(np.mean([by_preset[n][s][h] for s in by_preset[n]])),
                "std": float(np.std([by_preset[n][s][h] for s in by_preset[n]])),
            }
            for n in all_presets if n in by_preset
        }

    from sciml_pde_torch.plots.figures import data_efficiency_figure

    out = Path(a.out)
    out.mkdir(parents=True, exist_ok=True)
    fig_path = data_efficiency_figure(out / "dr_seed_data_efficiency.png", curves,
                                      x=all_presets,
                                      xlabel="training trajectories (basic_dsN preset)")
    (out / "dr_seed_data_efficiency.json").write_text(json.dumps(agg, indent=1))
    print(f"figure -> {fig_path}")
    print(json.dumps(agg, indent=1))
    return agg


if __name__ == "__main__":
    main()
