"""Build the Hopper kernels from the package's CUDA sources at first use.

Each ``csrc/*.cu`` source becomes one shared library with a plain C
interface, compiled by ``nvcc`` for ``sm_90a`` into ``ops/_build/`` (listed
in ``.gitignore``) and bound with ``ctypes``.  ``build_all`` compiles every
missing source in parallel, one ``nvcc`` process each; ``load`` builds only
the library it is asked for.  A library's file name carries a
hash of its sources and flags, so an edited source is rebuilt and a stale
library is never loaded.  A failed build raises with the compiler's output;
a good one keeps it beside the library (``ptxas -v``: registers and spills
of each kernel, read by ``ptxas_report``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("fno_fwd", "fno_bwd", "attention", "spectral_fused", "probe")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (
        os.environ.get("CUDA_HOME", "") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> float:
    """Compile every missing library of ``names``, all at once.  Returns the
    seconds spent (0 when everything was built already)."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    procs = []
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The built library ``name`` (building it first if needed)."""
    lib = _loaded.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib


def _kernel_name(mangled: str) -> str:
    """``name<args>`` of a kernel template's mangled name (a length-prefixed
    identifier ending in ``_kernel``, integer template arguments), else the
    mangled name."""
    for m in re.finditer(r"\d+", mangled):
        for i in range(len(m.group())):  # the length may be any tail of the digits
            start = m.end() + int(m.group()[i:])
            ident = mangled[m.end():start]
            args = re.match(r"I((?:Li\d+E)+)", mangled[start:])
            if ident.endswith("_kernel") and args:
                return f"{ident}<{', '.join(re.findall(r'Li(\d+)E', args.group(1)))}>"
    return mangled


def ptxas_report(name: str) -> list[tuple[str, int, int, int]]:
    """(kernel, registers, spill store bytes, spill load bytes) of each kernel
    of the built library ``name``, from the ``ptxas -v`` output of its build."""
    rows, fn, spill = [], None, (0, 0)
    for line in library_path(name).with_suffix(".log").read_text().splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            fn, spill = _kernel_name(m.group(1)), (0, 0)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spill = (int(m.group(1)), int(m.group(2)))
        elif (m := re.search(r"Used (\d+) registers", line)) and fn is not None:
            rows.append((fn, int(m.group(1)), *spill))
            fn = None
    return rows
