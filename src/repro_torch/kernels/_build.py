"""Build the CUDA sources in ``csrc/`` at first use and bind them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with nvcc for
``sm_90a`` into its own shared library under ``build/`` (listed in
``.gitignore``). The library's file name carries a hash of the source, so
an edited kernel is rebuilt and a built one is reused. All sources compile
at once, one nvcc process each.

A missing nvcc, a failed compile or a missing symbol raises
``KernelFailureError``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from repro_torch.core.guards import KernelFailureError

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("seed_prologue", "kmeans_distance", "lloyd_assign")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise KernelFailureError("nvcc not found (PATH, $CUDA_HOME/bin, "
                             "/usr/local/cuda/bin)")


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every source whose library is missing, all nvcc processes
    started together. Returns {name: compiler output} for the sources that
    were compiled (ptxas register/shared-memory report included)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT,
                                             text=True))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, library_path(name))
        else:
            tmp.unlink(missing_ok=True)
            failed.append(name)
    if failed:
        raise KernelFailureError(
            "nvcc failed for " + ", ".join(failed) + ":\n"
            + "\n".join(logs[n] for n in failed))
    return logs


@functools.cache
def function(name: str, symbol: str, argtypes: tuple):
    """The C function ``symbol`` of library ``name``, built on first use,
    with its ctypes signature set (int return: a cudaError_t)."""
    build_all((name,))
    try:
        fn = getattr(ctypes.CDLL(str(library_path(name))), symbol)
    except (OSError, AttributeError) as e:
        raise KernelFailureError(f"cannot load {symbol} from {name}: {e}")
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn
