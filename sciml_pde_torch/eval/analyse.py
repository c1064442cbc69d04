"""Result aggregation (port of ``sciml_pde_tpu/eval/analyse.py``): metric
pickles -> ``Results.csv``.

    python -m sciml_pde_torch.eval.analyse --results-dir runs/ --out Results.csv

Each ``*.pickle`` under the directory holds the six rollout metrics (RMSE,
nRMSE, CSV, Max, BD, F) as the trainers of either package write them; the
file name ``{pde}_{param}_{model}`` gives the index columns.  ``pandas`` is
imported inside the functions, so the package imports on a host without it.
"""

from __future__ import annotations

import argparse
import pickle
from pathlib import Path

import numpy as np

METRIC_COLS = ["RMSE", "nRMSE", "CSV", "Max", "BD", "F"]


def parse_name(stem: str) -> dict:
    """'{pde}_{param}_{model}'; missing parts fall back to ''."""
    parts = stem.split("_")
    return {
        "pde": parts[0] if parts else stem,
        "param": "_".join(parts[1:-1]) if len(parts) > 2 else "",
        "model": parts[-1] if len(parts) > 1 else "",
    }


def collect(results_dir: str | Path):
    """One row per metric pickle, indexed by (pde, param, model)."""
    import pandas as pd

    rows = []
    for p in sorted(Path(results_dir).glob("**/*.pickle")):
        with p.open("rb") as f:
            errs = pickle.load(f)
        row = parse_name(p.stem)
        row.update(dict(zip(METRIC_COLS, (float(np.asarray(v).mean()) for v in errs))))
        row["file"] = str(p)
        rows.append(row)
    return pd.DataFrame(rows).set_index(["pde", "param", "model"]) if rows else pd.DataFrame()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--results-dir", default=".")
    p.add_argument("--out", default="Results.csv")
    a = p.parse_args(argv)
    df = collect(a.results_dir)
    df.to_csv(a.out)
    print(f"{len(df)} results -> {a.out}")


if __name__ == "__main__":
    main()
