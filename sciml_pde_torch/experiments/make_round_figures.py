"""Round figures: the port's rollout curves over the published tables (port
of the JAX package's ``experiments/make_round_figures.py``).

One panel per benchmark (2D DR FNO, 2D NS FNO, 2D DR Transformer, and 3D
NS FNO / 2D NS Transformer where their run summaries exist), each read
from the live run summary under ``runs/`` with the tracked
``experiments/results`` snapshot as the fallback.  The colour follows the
model variant (baseline blue, aux orange); the published rows are drawn
thin with hollow markers, this framework's thick and filled.  Drawn with
PIL through ``plots/figures.line_figure``, on the host alone: the card's
machine has no matplotlib.

Re-runnable: panels whose result files are missing are skipped.

  python -m sciml_pde_torch.experiments.make_round_figures
"""

from __future__ import annotations

import json
from pathlib import Path

from sciml_pde_torch.plots.paper_tables import ROLLOUT_NRMSE


def _load(path, *keys, fallback=None):
    """Read nested keys from ``path``, else from ``fallback``: the live run
    summary wins, the tracked experiments/results snapshot backs it up."""
    p = Path(path)
    if not p.exists():
        if fallback is not None:
            return _load(fallback, *keys)
        return None
    d = json.loads(p.read_text())
    for k in keys:
        if d is None or k not in d:
            if fallback is not None:
                return _load(fallback, *keys)
            return None
        d = d[k]
    return d


def _load_best(path, variants, *keys, fallback=None):
    """Try each variant key in order (strongest result first) against the
    live summary, then against the snapshot fallback."""
    for v in variants:
        got = _load(path, v, *keys)
        if got is not None:
            return got
    if fallback is not None:
        return _load_best(fallback, variants, *keys)
    return None


def rollout_panel(out_path, pub, ours_base, ours_aux, title, note=""):
    """The published baseline and aux rows and ours over rollout steps 1..5,
    coloured by variant (slot 0 baseline, 1 aux), the published thin."""
    from sciml_pde_torch.plots.figures import line_figure

    steps = list(range(1, 6))
    curves = {"baseline (published)": (steps, pub["baseline"]),
              "aux (published)": (steps, pub["aux"])}
    if ours_base:
        curves["baseline (ours)"] = (steps[: len(ours_base)], ours_base)
    if ours_aux:
        curves["aux (ours)"] = (steps[: len(ours_aux)], ours_aux)
    colour_of = {k: 0 if k.startswith("baseline") else 1 for k in curves}
    return line_figure(out_path, curves, f"{title}: nRMSE vs rollout step"
                       + (f"\n{note}" if note else ""), colour_of=colour_of,
                       thin=("baseline (published)", "aux (published)"))


PANELS = [
    dict(
        key=("2D_DR", "FNO"),
        title="2D diffusion-reaction, FNO (ds128)",
        base=lambda: _load("experiments/results/dr_parity_ds128.json",
                           "baseline", "rollout_nrmse"),
        aux=lambda: _load("experiments/results/dr_parity_ds128.json",
                          "aux", "rollout_nrmse"),
        note="ours: self-generated data, largest preset run so far",
    ),
    dict(
        key=("2D_NS", "FNO"),
        title="2D incompressible NS, FNO (256²)",
        base=lambda: (_load_best("runs/ns_production/summary.json",
                                 ["baseline_ds32", "baseline_refbatch"],
                                 "rollout_nrmse",
                                 fallback="experiments/results/ns_production_summary_r2d.json")
                      or _load("experiments/results/ns_production_summary_r2.json",
                               "baseline", "rollout_nrmse")),
        aux=lambda: (_load_best("runs/ns_production/summary.json",
                                ["aux_ds32", "aux_p2", "aux_refbatch"],
                                "rollout_nrmse",
                                fallback="experiments/results/ns_production_summary_r2c.json")
                     or _load("experiments/results/ns_production_summary_r2.json",
                              "aux", "rollout_nrmse")),
        note="ours: reference batch sizes; strongest landed preset per variant",
    ),
    dict(
        key=("2D_DR", "Transformer"),
        title="2D diffusion-reaction, Transformer (ds8)",
        base=lambda: _load("runs/dr_transformer_r2/convention_eval.json",
                           "baseline", "joint_all",
                           fallback="experiments/results/dr_convention_eval_r2.json"),
        aux=lambda: _load("runs/dr_transformer_r2/convention_eval.json",
                          "aux", "joint_all",
                          fallback="experiments/results/dr_convention_eval_r2.json"),
        note="published joint/all-steps nRMSE convention",
    ),
    dict(
        key=("3D_NS", "FNO"),
        title="3D incompressible NS plume, FNO",
        base=lambda: _load("runs/plume3d_parity/summary.json",
                           "baseline", "rollout_nrmse",
                           fallback="experiments/results/plume3d_parity_summary_r2.json"),
        aux=lambda: _load("runs/plume3d_parity/summary.json",
                          "aux", "rollout_nrmse",
                          fallback="experiments/results/plume3d_parity_summary_r2.json"),
    ),
    dict(
        key=("2D_NS", "Transformer"),
        title="2D incompressible NS, Transformer",
        base=lambda: _load("runs/ns_transformer/summary.json",
                           "ns_baseline", "rollout_nrmse_allsteps",
                           fallback="experiments/results/ns_transformer_summary_r2.json"),
        aux=lambda: _load_best("runs/ns_transformer/summary.json",
                               ["ns_aux_ext", "ns_aux"], "rollout_nrmse_allsteps",
                               fallback="experiments/results/ns_transformer_summary_r2b.json"),
    ),
]


def main(out_dir="runs/figures"):
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    made = []
    for p in PANELS:
        task, model = p["key"]
        pub = ROLLOUT_NRMSE.get(task, {}).get(model)
        if pub is None:
            continue
        ours_b, ours_a = p["base"](), p["aux"]()
        if ours_b is None and ours_a is None:
            continue
        f = out / f"rollout_{task}_{model}.png".lower()
        rollout_panel(f, pub, ours_b, ours_a, p["title"], p.get("note", ""))
        made.append(str(f))
    print(json.dumps(made, indent=1))
    return made


if __name__ == "__main__":
    main()
