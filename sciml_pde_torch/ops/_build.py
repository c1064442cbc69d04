"""Build the Hopper kernels from the package's CUDA sources at first use.

Each ``csrc/*.cu`` source becomes one shared library with a plain C
interface, compiled by ``nvcc`` for ``sm_90a`` into ``ops/_build/`` (listed
in ``.gitignore``) and bound with ``ctypes``.  ``build_all`` compiles every
missing source in parallel, one ``nvcc`` process each; ``load`` builds only
the library it is asked for; ``build_copies`` compiles edited copies of a
source's text side by side, for the experiments that time them.  A
library's file name carries a
hash of its sources and flags, so an edited source is rebuilt and a stale
library is never loaded.  A failed build raises with the compiler's output;
a good one keeps it beside the library (``ptxas -v``: registers, spills and
stack frame of each kernel, read by ``ptxas_report``).  ``sass`` reads a
built library's machine code back (``cuobjdump -sass``) and
``memory_order`` the order of each kernel's global loads, stores and f32
arithmetic in it.

``load_host`` is the route for host C code (the LZF codec of
``io/csrc/lzf.c``): the system's C compiler (``$CC``, else ``cc``, the
compiler ``nvcc`` itself calls on the card's machine) with
``HOST_CFLAGS``, into the same directory under a hashed name, written
under a temporary name and renamed into place, so processes that build it
at once each load a whole library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("fno_fwd", "fno_bwd", "attention", "spectral_fused", "probe")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

HOST_CFLAGS = ("-O2", "-shared", "-fPIC")

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


def host_cc() -> str:
    for cand in (os.environ.get("CC", ""), "cc", "gcc"):
        if cand and (path := shutil.which(cand)):
            return path
    raise RuntimeError("no C compiler found (cc, gcc; set CC): the host C code cannot be built")


def host_library_path(src: Path) -> Path:
    h = hashlib.sha256(" ".join(HOST_CFLAGS).encode())
    h.update(Path(src).read_bytes())
    return BUILD_DIR / f"lib{Path(src).stem}-{h.hexdigest()[:16]}.so"


def load_host(src: Path) -> ctypes.CDLL:
    """The library of the host C source ``src``, compiled first if it is not
    built.  A failed build raises with the compiler's output."""
    out = host_library_path(src)
    lib = _loaded.get(str(out))
    if lib is None:
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
            proc = subprocess.run([host_cc(), *HOST_CFLAGS, "-o", str(tmp), str(src)],
                                  capture_output=True, text=True)
            if proc.returncode:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"host C build of {Path(src).name} failed (exit "
                                   f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
        lib = _loaded[str(out)] = ctypes.CDLL(str(out))
    return lib


def build_copies(texts: dict[str, str], out: Path) -> dict[str, ctypes.CDLL]:
    """Compile each of ``texts`` (name: the text of one CUDA source, which
    includes nothing from ``csrc/``) in ``out`` with the package's flags,
    all at once, and load them: {name: library}.  A failed build raises
    with the compiler's output; a good one keeps it beside the library
    (``copy_ptxas``).  For timing copies of a source side by side (the
    experiments); the package's own kernels go through ``load``."""
    procs = {}
    for i, (name, text) in enumerate(texts.items()):
        cu, so = out / f"copy{i}.cu", out / f"libcopy{i}.so"
        cu.write_text(text)
        procs[name] = (subprocess.Popen([nvcc_path(), *NVCC_FLAGS, "-o", str(so), str(cu)],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the {name!r} copy:\n{log[-4000:]}")
        so.with_suffix(".log").write_text(log)
        libs[name] = ctypes.CDLL(str(so))
    return libs


def copy_ptxas(lib: ctypes.CDLL) -> list[tuple[str, int, int, int, int]]:
    """``ptxas_report`` of a library that ``build_copies`` built."""
    return parse_ptxas(Path(lib._name).with_suffix(".log").read_text())


def _template_args(s: str):
    """The template arguments of a mangled ``I...E`` list (``s`` starts
    after the ``I``): integers, booleans, ``float`` and named types; None
    for any other form."""
    args, i = [], 0
    while i < len(s) and s[i] != "E":
        if m := re.match(r"L([ib])(\d+)E", s[i:]):
            args.append(m.group(2) if m.group(1) == "i" else ("false", "true")[m.group(2) == "1"])
            i += m.end()
        elif s[i] == "f":
            args.append("float")
            i += 1
        elif m := re.match(r"\d+", s[i:]):
            n = int(m.group())
            args.append(s[i + m.end():i + m.end() + n])
            i += m.end() + n
        else:
            return None
    return args if i < len(s) else None


def _kernel_name(mangled: str) -> str:
    """``name`` or ``name<args>`` of a kernel's mangled name (a
    length-prefixed identifier ending in ``_kernel``), else the mangled
    name."""
    for m in re.finditer(r"\d+", mangled):
        for i in range(len(m.group())):  # the length may be any tail of the digits
            start = m.end() + int(m.group()[i:])
            ident = mangled[m.end():start]
            if not ident.endswith("_kernel"):
                continue
            if not mangled[start:].startswith("I"):
                return ident
            args = _template_args(mangled[start + 1:])
            if args:
                return f"{ident}<{', '.join(args)}>"
    return mangled


def ptxas_report(name: str) -> list[tuple[str, int, int, int, int]]:
    """(kernel, registers, spill store bytes, spill load bytes, stack frame
    bytes) of each kernel of the built library ``name``, from the ``ptxas
    -v`` output of its build."""
    return parse_ptxas(library_path(name).with_suffix(".log").read_text())


def parse_ptxas(log: str) -> list[tuple[str, int, int, int, int]]:
    """(kernel, registers, spill store bytes, spill load bytes, stack frame
    bytes) of each kernel in the ``ptxas -v`` output ``log``."""
    rows, fn, usage = [], None, (0, 0, 0)
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            fn, usage = _kernel_name(m.group(1)), (0, 0, 0)
        elif m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                            r"(\d+) bytes spill loads", line):
            usage = (int(m.group(2)), int(m.group(3)), int(m.group(1)))
        elif (m := re.search(r"Used (\d+) registers", line)) and fn is not None:
            rows.append((fn, int(m.group(1)), *usage))
            fn = None
    return rows


def sass(lib: Path) -> dict[str, list[str]]:
    """The SASS instructions of each kernel of the built library ``lib``
    (``cuobjdump -sass``), by kernel name."""
    out = subprocess.run([str(Path(nvcc_path()).with_name("cuobjdump")), "-sass", str(lib)],
                         capture_output=True, text=True, timeout=300, check=True).stdout
    return parse_sass(out)


def parse_sass(text: str) -> dict[str, list[str]]:
    """``cuobjdump -sass`` output -> {kernel name: its instructions, in order}."""
    kernels, cur = {}, None
    for line in text.splitlines():
        if m := re.search(r"Function : (\S+)", line):
            cur = kernels.setdefault(_kernel_name(m.group(1)), [])
        elif cur is not None and (m := re.search(r"/\*[0-9a-f]{4,}\*/\s+(.+?)\s*;", line)):
            cur.append(m.group(1))
    return kernels


def memory_order(instrs: list[str]) -> str:
    """The order of a kernel's global loads (L), global stores (S) and f32
    adds, multiplies and FMAs (F) in its SASS, each run of one kind as its
    count: ``"L24 F64 S8"``."""
    runs: list[list] = []
    for ins in instrs:
        op = re.sub(r"^@!?U?P\w+\s+", "", ins).split()[0]
        kind = ("L" if op.startswith("LDG") else "S" if op.startswith("STG")
                else "F" if op.split(".")[0] in ("FFMA", "FMUL", "FADD") else None)
        if kind is None:
            continue
        if runs and runs[-1][0] == kind:
            runs[-1][1] += 1
        else:
            runs.append([kind, 1])
    return " ".join(f"{k}{n}" for k, n in runs)
