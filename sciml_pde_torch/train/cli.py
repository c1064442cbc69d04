"""Training CLI (port of ``sciml_pde_tpu/train/cli.py``):

  python -m sciml_pde_torch.train.cli train --config config_dr --dataset basic_ds8 \\
      base_path=data/ [key=value ...]
  python -m sciml_pde_torch.train.cli aux --config config_dr --dataset basic_ds8 \\
      base_path=data/ aux_path=data/ [key=value ...]
  python -m sciml_pde_torch.train.cli transformer --config config_ns \\
      --dataset basic_ds4 base_path=data/ns_256/ if_aux=False [key=value ...]
  python -m sciml_pde_torch.train.cli aux --config config_ns --dataset basic_ds8 \\
      base_path=data/ns_256/ aux_path=data/basic_eq/ [key=value ...]
  python -m sciml_pde_torch.train.cli train --config config_ns_3d --dataset basic_ds4 \\
      base_path=data/3D_NS/ [key=value ...]

``train`` is the FNO baseline and ``aux`` the two-head joint training
whatever the config's ``if_aux`` says, as in the JAX CLI, on the config's
``dataset_family`` (DR, NS-2D, or the 3D plume with the 3D FNO).  ``train`` runs
the production step unless ``fast_step=True`` (or ``SCIML_FAST_STEP=1``)
asks for the fused one; every key of ``run_training`` (``scheduler``,
``training_type``, ``rollout_test``, ``continue_training``,
``auxiliary_weight``, ``sim_name``, ``test_range``, ``lie_augment``,
``aux_chunks`` ...) passes through from the config or an override,
and ``if_training=False`` evaluates the run's checkpoint (the six-metric
pickle and ``mse_time.npz``; ``python -m sciml_pde_torch.eval.analyse``
gathers the pickles into ``Results.csv``).  Runs on ``cuda``;
``device=cpu`` runs the plain PyTorch versions on the CPU.

Under ``torchrun`` (``WORLD_SIZE`` above 1) each process joins the process
group first (``parallel.distributed_init``: NCCL, or gloo with
``device=cpu``) and the run is data parallel over the ranks:

  torchrun --nproc-per-node 4 -m sciml_pde_torch.train.cli train \
      --config config_ns base_path=data/ns_256/ shard_store=True
"""

from __future__ import annotations

import argparse
import inspect
import os
import sys

from sciml_pde_torch.utils.config import load_config
from sciml_pde_torch.utils.logging import print_line


def _call_with_supported(fn, args: dict, override_keys=(), **extra):
    sig = inspect.signature(fn)
    # config keys the trainer does not take are dropped (the presets carry
    # keys of other trainers), but an explicit override that lands nowhere
    # is a user error; ``extra`` keys take precedence over ``args``
    unknown = [k for k in override_keys if k not in sig.parameters]
    if unknown:
        raise SystemExit(f"unknown override(s) for {fn.__name__}: {', '.join(unknown)}")
    return fn(**{k: v for k, v in {**args, **extra}.items() if k in sig.parameters})


def _parse(argv):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", default="config_dr")
    p.add_argument("--dataset", default=None, help="preset, e.g. basic_ds8")
    p.add_argument("overrides", nargs="*", help="key=value overrides")
    a = p.parse_args(argv)
    keys = [kv.split("=", 1)[0] for kv in a.overrides if "=" in kv]
    return load_config(a.config, a.dataset, a.overrides), keys


def _fno(argv, if_aux: bool):
    from sciml_pde_torch.train.fno_train import run_training

    cfg, keys = _parse(argv)
    # the subcommand picks the branch whatever the config says, as in the JAX CLI
    res = _call_with_supported(run_training, {**cfg, "if_aux": if_aux}, keys)
    print_line(f"best_val={res.best_val:.6g}")
    return res


def main(argv=None):
    return _fno(argv, if_aux=False)


def main_aux(argv=None):
    return _fno(argv, if_aux=True)


# FNO-config keys that name the same knob differently in the transformer
# trainer
_TRANSFORMER_ALIASES = {"num_channels": "in_chans"}


def main_transformer(argv=None):
    from sciml_pde_torch.train.transformer_train import run_transformer_training

    cfg, keys = _parse(argv)
    for src, dst in _TRANSFORMER_ALIASES.items():
        if src in cfg and dst not in cfg:
            cfg[dst] = cfg.pop(src)
    keys = [_TRANSFORMER_ALIASES.get(k, k) for k in keys]
    res = _call_with_supported(run_transformer_training, cfg, keys)
    print_line(f"best_val={res.best_val:.6g}")
    return res


_SUBCOMMANDS = {"train": main, "aux": main_aux, "transformer": main_transformer}


def join_torchrun_group(argv) -> None:
    """Join the process group ``torchrun`` set up (``WORLD_SIZE`` above 1),
    on the device a ``device=...`` override names."""
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        from sciml_pde_torch.parallel import distributed_init

        dev = next((kv.split("=", 1)[1] for kv in argv if kv.startswith("device=")), None)
        distributed_init(device=dev)


if __name__ == "__main__":
    cmd = sys.argv[1] if len(sys.argv) > 1 else "train"
    if cmd not in _SUBCOMMANDS:
        raise SystemExit(f"unknown subcommand {cmd!r}; the port has: {', '.join(_SUBCOMMANDS)}")
    join_torchrun_group(sys.argv[2:])
    _SUBCOMMANDS[cmd](sys.argv[2:])
