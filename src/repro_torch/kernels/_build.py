"""Build the CUDA sources in ``csrc/`` at first use and bind them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with nvcc for
``sm_90a`` into its own shared library under ``build/`` (listed in
``.gitignore``). The library's file name carries a hash of the source, so
an edited kernel is rebuilt and a built one is reused. The compiler's
output (the ptxas report) is kept beside the library, so a reused build
reports as a fresh one; a library without it is rebuilt. All sources
compile at once, one nvcc process each.

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
SOURCES = ("seed_prologue", "kmeans_distance", "lloyd_assign",
           "rejection", "ivf_scan", "pq_decode", "flash_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def toolkit_bin(name: str = "nvcc") -> str:
    """Path of a CUDA toolkit program (``nvcc``, ``cuobjdump``): on PATH,
    else under $CUDA_HOME/bin or /usr/local/cuda/bin."""
    found = shutil.which(name)
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / name
    if cand.exists():
        return str(cand)
    raise KernelFailureError(f"{name} not found (PATH, $CUDA_HOME/bin, "
                             "/usr/local/cuda/bin)")


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def log_path(name: str) -> Path:
    """The compiler output of the build at :func:`library_path`."""
    return library_path(name).with_suffix(".log")


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every source whose library or log is missing, all nvcc
    processes started together. Returns {name: compiler output} for every
    source in ``names`` (ptxas register/shared-memory report included),
    read back from the log of an earlier build where there is one."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names
            if not (library_path(n).exists() and log_path(n).exists())]
    logs = {n: log_path(n).read_text() for n in names if n not in todo}
    if not todo:
        return logs
    nvcc = toolkit_bin()
    procs = {}
    for name in todo:
        tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT,
                                             text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode == 0:
            tmp_log = log_path(name).with_suffix(f".{os.getpid()}.logtmp")
            tmp_log.write_text(logs[name])
            os.replace(tmp_log, log_path(name))
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
