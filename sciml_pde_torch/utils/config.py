"""YAML configs with dataset-size presets (port of
``sciml_pde_tpu/utils/config.py``): a base ``args`` mapping plus ``basic_dsN``
presets, and dotted ``key=value`` overrides.  The port keeps its own copy
of ``config_dr.yaml``, ``config_ns.yaml`` and ``config_ns_3d.yaml`` under
``sciml_pde_torch/configs``.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Any

CONFIG_DIR = Path(__file__).resolve().parent.parent / "configs"


def _parse_value(v: str) -> Any:
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return v


def load_config(name_or_path: str, dataset: str | None = None,
                overrides: list[str] | None = None) -> dict[str, Any]:
    """Load a config; ``dataset`` picks a preset block merged over ``args``."""
    import yaml

    path = Path(name_or_path)
    if not path.exists():
        path = CONFIG_DIR / f"{name_or_path}.yaml"
    with path.open() as f:
        tree = yaml.safe_load(f)
    args = dict(tree.get("args", {}))
    if dataset is not None:
        if dataset not in tree:
            raise KeyError(f"unknown dataset preset {dataset!r} in {path}")
        args.update(tree[dataset] or {})
    for ov in overrides or []:
        k, _, v = ov.partition("=")
        args[k.removeprefix("args.")] = _parse_value(v)
    return args
