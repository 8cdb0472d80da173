"""The build of the Hopper kernels of fhe_si_tpu_torch/csrc/ and the one
seam through which the wrappers (ops/ntt_ct_cuda.py, ops/crt_cuda.py,
ops/modular_cuda.py, ops/digits_cuda.py, ops/route_cuda.py) reach them.
Each source csrc/<name>.cu (CUDA C++ for sm_90a, a plain C interface)
becomes one library, compiled by nvcc into fhe_si_tpu_torch/_build/ the
first time it is needed and loaded with ctypes by `library`, whose first call
compiles every source at once, as `build` does, and which declares the
library's entry points from ENTRIES.  Nothing is compiled or loaded at
import, so this module imports on a machine without nvcc.
`on_cuda` is the wrappers' dispatch: a CPU tensor takes the plain
version, a CUDA tensor the kernel.  `launch` checks a kernel's operands,
launches it on the current stream and counts it in LAUNCHES (and a
transform's schedule in SCHEDULES); the plain versions count nothing.
The limits below are what the kernels' exactness rests on; every
wrapper refuses an input past them.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_CT = [_P] * 6 + [_LL] + [_I] * 5 + [_P]
# csrc/<name>.cu, one library each: the argument types of each entry point
# of its extern "C" block (a launch's last argument is the stream).  Each
# returns an int, a launch its CUDA error code, except as RESTYPES says.
ENTRIES = {
    "ct_ntt": {"fsi_ct_fwd": _CT, "fsi_ct_fwd_digits": _CT, "fsi_ct_inv": _CT,
               "fsi_ct_sync": [_I] + [_P] * 6 + [_LL] + [_I] * 3 + [_P],
               "fsi_ct_schedule": [_I, _I],
               "fsi_ct_mma_smem": [_I] * 3, "fsi_smem_optin": [],
               "fsi_ct_tiles": [_I, _LL] + [_I] * 5,
               "fsi_ct_slots": [_I] * 5},
    "crt": {"fsi_crt_partials": [_P] * 5 + [_LL] + [_I] * 3 + [_P],
            "fsi_crt_finish": [_P] * 5 + [_LL] + [_I] * 5 + [_P],
            "fsi_crt_to_limbs": [_P] * 3 + [_LL] + [_I] * 6 + [_P],
            "fsi_limbs_to_residues": [_P] * 6 + [_I] * 6 + [_P]},
    "modular": {"fsi_tensor_product": [_P] * 4 + [_LL] * 2 + [_I] * 5 + [_P],
                "fsi_keyswitch_dot": [_P] * 4 + [_I] * 4 + [_P]},
    "digits": {"fsi_byte_decomp": [_P] * 3 + [_I] * 7 + [_P]},
    "route": {"fsi_route_enter": [_P] * 4 + [_I] * 4 + [_P],
              "fsi_route_leave": [_P] * 4 + [_I] * 4 + [_P]},
}
RESTYPES = {"fsi_ct_mma_smem": _LL, "fsi_ct_tiles": _LL, "fsi_ct_slots": _LL}
SOURCES = tuple(ENTRIES)
_SOURCE_OF = {entry: name for name, entries in ENTRIES.items()
              for entry in entries}

# What the kernels' exactness rests on, each beside the csrc constant or
# header note it mirrors
Q_LIMIT = 1 << 23       # primes in [2, 2^23), crt.cu's m_r too: the
                        # exactness notes of ct_ntt.cu, crt.cu, modular.cu
MAX_LIMBS = 48          # crt.cu, digits.cu kMaxLimbs
MAX_ROWS = 64           # residue rows: crt.cu kMaxRows, digits.cu kMaxPrimes
MAX_COEFFS = 1 << 31    # coefficients a launch: crt.cu, digits.cu's 32-bit
                        # tile indices
MAX_DIGIT_BITS = 24     # digits below 2^24: ct_ntt.cu's byte planes,
                        # digits.cu's check

# launches of each wrapper, and of the transforms by the kernel's schedule
LAUNCHES = dict.fromkeys(("ct_fwd", "ct_fwd_digits", "ct_inv", "crt_to_limbs",
                          "limbs_to_residues", "tensor_product",
                          "keyswitch_dot", "byte_decomp", "route_enter",
                          "route_leave"), 0)
SCHEDULES = {"pingpong": 0, "sync": 0, "rowsplit": 0}


def reset_launches():
    for counts in (LAUNCHES, SCHEDULES):
        for k in counts:
            counts[k] = 0


def check_primes(name: str, shape, primes):
    """Raise ValueError, with the input's shape, unless every prime of a
    basis (a numpy array) lies in [2, Q_LIMIT)."""
    lo, hi = int(np.min(primes)), int(np.max(primes))
    if not (2 <= lo and hi < Q_LIMIT):
        raise ValueError(f"{name}: input {tuple(shape)}: the kernel takes "
                         f"primes in [2, 2^23) only, not {lo} ... {hi}")


def check_coeffs(name: str, shape, coeffs: int):
    if coeffs >= MAX_COEFFS:
        raise ValueError(f"{name}: input {tuple(shape)} has {coeffs} "
                         f"coefficients; a launch takes fewer than 2^31")


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
    lib = ctypes.CDLL(str(_so_path(name)))
    for entry, args in ENTRIES[name].items():
        fn = getattr(lib, entry)
        fn.argtypes, fn.restype = args, RESTYPES.get(entry, _I)
    return lib


def launch(name: str, entry: str, tensors, ints, int32=(), contiguous=(),
           schedule: str | None = None):
    """Launch the entry point `entry` for the wrapper `name` on the
    current stream of its operands' device, after checking that every
    operand is on that one CUDA device and that those the caller marks
    are int32 (`int32`) or contiguous (`contiguous`): True marks every
    operand, a tuple the operands at those indices.  The entry takes the
    operands' pointers (None: a null pointer), then `ints`, then the
    stream; a nonzero return raises.  Counts the launch under `name`, and
    under `schedule` where given."""
    dev = next(t.device for t in tensors if t is not None)
    for i, t in enumerate(tensors):
        if t is None:
            continue
        want_i32 = int32 is True or i in int32
        want_layout = contiguous is True or i in contiguous
        if (t.device != dev or dev.type != "cuda"
                or (want_i32 and t.dtype != torch.int32)
                or (want_layout and not t.is_contiguous())):
            raise ValueError(
                f"{name}: operand {i} {tuple(t.shape)} {t.dtype} on "
                f"{t.device}: the kernel takes {'contiguous ' * want_layout}"
                f"{'int32 ' * want_i32}tensors on one CUDA device")
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = getattr(library(_SOURCE_OF[entry]), entry)(
        *(None if t is None else t.data_ptr() for t in tensors), *ints, stream)
    if err:
        raise RuntimeError(f"{name}: CUDA error {err} at launch ({entry})")
    LAUNCHES[name] += 1
    if schedule is not None:
        SCHEDULES[schedule] += 1


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
