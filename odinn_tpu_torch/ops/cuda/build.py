"""Build the CUDA sources under ``odinn_tpu_torch/csrc`` at first use and
load them with ctypes.

Each ``csrc/<name>.cu`` becomes ``build/odinn_tpu_torch/lib<name>.so`` in the
checkout, compiled by ``nvcc`` for ``sm_90a`` with a plain C interface (no
PyTorch headers, so a build takes seconds). A library is rebuilt when any
source in ``csrc`` is newer than it. :func:`build_all` starts one ``nvcc``
per source, all at once.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Tuple

__all__ = ["SRC_DIR", "BUILD_DIR", "nvcc_command", "build_all", "load_library"]

SRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "odinn_tpu_torch"

_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# rkc_interval rounds each product and sum as its plain version does (no
# fused multiply-add): the Chebyshev recursion carries every stage's
# rounding into the next, and contracted roundings took the float32 RKC
# gradient's d(creep) error from 1.1e-3 to 2.9e-3 of max|d(creep)| (PERF.md).
# sia2d_rhs_jvp's stage mode carries the RKC tangent through the same
# recursion, so its stage combination rounds as rkc_interval's does (its RHS
# arithmetic is reordered and differs from the plain version by a few ulps).
# si_step.cu's many kernel instances make the slowest build by far: nvcc
# splits its optimisation over every core (PERF.md §5).
_SOURCE_FLAGS = {"rkc_interval": ("-fmad=false",), "sia2d_rhs_jvp": ("-fmad=false",),
                 "si_step": ("-split-compile=0",)}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                           "with the CUDA toolkit")
    return path


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def nvcc_command(name: str, out: Path) -> list:
    return [_nvcc(), *_NVCC_FLAGS, *_SOURCE_FLAGS.get(name, ()), "-I", str(SRC_DIR), "-o",
            str(out), str(SRC_DIR / f"{name}.cu")]


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in SRC_DIR.iterdir() if p.suffix in (".cu", ".cuh"))
    return lib.stat().st_mtime < newest


def build_all(names=None) -> Dict[str, Tuple[float, str]]:
    """Build the stale libraries among ``names`` (default: every source), one
    ``nvcc`` process per source, all started together. Returns
    ``{name: (seconds, compiler output)}`` for each library built, the
    seconds to that build's own end; raises with the compiler's output if
    any build fails."""
    if names is None:
        names = sorted(p.stem for p in SRC_DIR.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, t0 = {}, time.perf_counter()
    for name in names:
        if not _stale(name):
            continue
        tmp = BUILD_DIR / f"lib{name}.so.{os.getpid()}.tmp"
        # the output goes to a file: a full pipe would stall its build
        log = open(BUILD_DIR / f"lib{name}.{os.getpid()}.log", "w+")
        procs[name] = (tmp, log, subprocess.Popen(nvcc_command(name, tmp), stdout=log,
                                                  stderr=subprocess.STDOUT))
    ended = {}
    while len(ended) < len(procs):
        for name, (_, _, proc) in procs.items():
            if name not in ended and proc.poll() is not None:
                ended[name] = time.perf_counter() - t0
        time.sleep(0.05)
    done, failed = {}, []
    for name, (tmp, log, proc) in procs.items():
        log.seek(0)
        text = log.read()
        log.close()
        os.remove(log.name)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{text}")
            continue
        os.replace(tmp, _lib_path(name))
        done[name] = (ended[name], text)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return done


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """The built library ``lib<name>.so``, building it first if stale."""
    build_all([name])
    return ctypes.CDLL(str(_lib_path(name)))
