"""Published result tables from the reference paper's figure scripts (the
port's own copy of ``sciml_pde_tpu/plots/paper_tables.py``).

These are the hard-coded numbers in ``Plot Generator/rollout.py`` /
``motivation.py`` / ``random_seed_ns.py`` (also tabulated in BASELINE.md);
they serve as accuracy targets for parity checks and as the "baseline"
curves in regenerated figures.
"""

ROLLOUT_NRMSE = {
    # task -> model -> {"baseline": [...roll 1..5], "aux": [...]}
    "2D_DR": {
        "FNO": {
            "baseline": [0.028906, 0.033876, 0.045756, 0.059498, 0.073865],
            "aux": [0.023155, 0.02904, 0.040126, 0.053151, 0.066781],
        },
        "Transformer": {
            "baseline": [0.105883, 0.109151, 0.115661, 0.12328, 0.131266],
            "aux": [0.0602556, 0.0709661, 0.0863324, 0.102376, 0.11813],
        },
    },
    "2D_NS": {
        "FNO": {
            "baseline": [0.048733, 0.050056, 0.067323, 0.087734, 0.10882],
            "aux": [0.017452, 0.025317, 0.042931, 0.060069, 0.075963],
        },
        "Transformer": {
            "baseline": [0.047947858, 0.06525512, 0.0901043, 0.11828722, 0.14963889],
            "aux": [0.026561534, 0.046707958, 0.07475659, 0.106752895, 0.142262],
        },
    },
    "3D_NS": {
        "FNO": {
            "baseline": [0.067505, 0.109714, 0.150054, 0.185311, 0.218163],
            "aux": [0.048125, 0.086153, 0.120555, 0.149356, 0.174979],
        },
    },
}

# foundation models on full vs decomposed-convection 2D NS (motivation.py:6-11)
MOTIVATION_NRMSE = {
    "models": ["MPP-L", "MPP-b", "MPP-S", "MPP-Ti", "DPOT-L", "DPOT-M", "DPOT-S", "DPOT-Ti", "Hyena"],
    "full": [0.008147, 0.013481, 0.019232, 0.020492, 0.0347, 0.0319, 0.0349, 0.0426, 0.05562],
    "decomposed_convection": [0.132741, 0.135356, 0.145712, 0.143235, 0.2081, 0.199, 0.215, 0.2116, 0.30776],
}

# simulation cost (seconds) per subsample preset ds2..ds64 (random_seed_ns.py:39)
SIM_COST_SECONDS = [5550, 11100, 22200, 44400, 88800, 133200, 177600]
