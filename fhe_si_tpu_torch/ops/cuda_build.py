"""The build of the Hopper kernels of fhe_si_tpu_torch/csrc/: each source
csrc/<name>.cu (CUDA C++ for sm_90a, a plain C interface) becomes one
library, compiled by nvcc into fhe_si_tpu_torch/_build/ the first time
it is needed and loaded with ctypes.  ops/ntt_ct_cuda.py, ops/crt_cuda.py,
ops/modular_cuda.py and ops/digits_cuda.py load their libraries through
`library`, whose first call compiles every source at once, as `build`
does.  Nothing is compiled or loaded at import, so this module imports
on a machine without nvcc.
`on_cuda` is the wrappers' dispatch: a CPU tensor takes the plain
version, a CUDA tensor the kernel.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
# csrc/<name>.cu, one library each
SOURCES = ("ct_ntt", "crt", "modular", "digits")
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def on_cuda(x) -> bool:
    """Whether a wrapper launches its kernel for tensor x (on a CUDA
    device) or takes its plain version (on the CPU); any other device
    raises."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    return True


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _so_path(name: str) -> Path:
    """The library of csrc/<name>.cu, tagged by the source and the flags."""
    tag = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()
                         + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{tag.hexdigest()[:12]}.so"


def compile_sources(names=SOURCES):
    """Build the library of each source in `names` that is not built yet
    (once per source version): one nvcc per source, all started at once.
    nvcc's output (ptxas -v: registers, shared memory, spills per kernel)
    goes beside each library as .log."""
    runs = []
    for name in names:
        so = _so_path(name)
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        runs.append((name, so, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, so, tmp, proc in runs:
        log, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{log}")
            continue
        so.with_suffix(".log").write_text(log)
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu.  The first library a process
    needs builds every source not built yet, all at once: a first run
    waits for the slowest nvcc (csrc/ct_ntt.cu, 28 s alone on an H100
    machine's host), not for their sum (64 s)."""
    compile_sources(SOURCES)
    return ctypes.CDLL(str(_so_path(name)))


def build() -> str:
    """Compile every source of csrc/ now, in parallel (otherwise each
    library's first launch builds it), and load them; returns nvcc's
    reports of registers, shared memory and spills."""
    compile_sources(SOURCES)
    logs = []
    for name in SOURCES:
        library(name)
        log = _so_path(name).with_suffix(".log")
        logs.append(log.read_text() if log.exists() else "")
    return "".join(logs)
