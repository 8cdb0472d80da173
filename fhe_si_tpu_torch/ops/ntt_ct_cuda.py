"""Hopper kernels for the three Cooley-Tukey transforms, and their
wrappers.

Stands in for fhe_si_tpu/ops/ntt_ct_pallas.py.  The kernels live in
fhe_si_tpu_torch/csrc/ct_ntt.cu (CUDA C++ for sm_90a, a plain C
interface); the first launch compiles them with nvcc into
fhe_si_tpu_torch/_build/ and loads the library with ctypes.  Nothing is
compiled or loaded at import, so this module imports on a machine
without nvcc.

Dispatch: a tensor on the CPU takes the plain version of ops/ntt_ct.py;
a tensor on a CUDA device launches the kernel, or raises.  There is no
fallback from a failed launch.  LAUNCHES counts the kernel launches of
each wrapper (the plain path does not count).

The wrappers check what the kernels' exactness rests on (ct_ntt.cu
header): every prime below 2^23, either residue lane, and keyswitch
digits of at most 24 bits.  The prime check reads the table's q once
and marks the tensor, so later launches on the same tables add no
device-to-host copy.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from . import ntt_ct
from .ntt_ct import CtMeta

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "ct_ntt.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

LAUNCHES = {"ct_fwd": 0, "ct_fwd_digits": 0, "ct_inv": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


@functools.cache
def _lib() -> ctypes.CDLL:
    """Build (once per source version) and load the kernel library."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    so = BUILD_DIR / f"libct_ntt_{tag}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True)
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name in ("fsi_ct_fwd", "fsi_ct_fwd_digits", "fsi_ct_inv"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * 6 + [i64, i32, i32, i32, ptr]
        fn.restype = ctypes.c_int
    return lib


def build() -> None:
    """Compile and load the kernels now (otherwise the first launch does)."""
    _lib()


def _on_cuda(x) -> bool:
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    return True


def _launch(name: str, fn, inp, tabs, q, out, rows, L, meta: CtMeta):
    """Check the operands, launch on the current stream, count."""
    for t in (inp, *tabs, q, out):
        if t.device != inp.device or t.dtype != torch.int32 \
                or not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous int32 "
                             f"tensors on {inp.device}")
    if rows == 0:
        return out
    with torch.cuda.device(inp.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(inp.data_ptr(), *(t.data_ptr() for t in tabs), q.data_ptr(),
                 out.data_ptr(), rows, L, meta.N1, meta.N2, stream)
    if err:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    LAUNCHES[name] += 1
    return out


def _check(name, x, tail: tuple, T: dict, meta: CtMeta):
    if meta.q_odd != 1:
        raise NotImplementedError("mixed-radix m is not ported")
    if tuple(x.shape[-len(tail):]) != tail:
        raise ValueError(f"{name}: expected [..., {', '.join(map(str, tail))}]"
                         f", got {tuple(x.shape)}")
    q = T['q']
    if not getattr(q, "_fsi_q_checked", False):
        if not 2 <= int(q.min()) <= int(q.max()) <= ntt_ct.Q_MAX:
            raise ValueError(f"{name}: the kernels take primes below "
                             f"2^{ntt_ct.Q_MAX.bit_length()} only")
        q._fsi_q_checked = True


def ct_fwd(T: dict, x, meta: CtMeta):
    """Forward transform of residues int32 [..., L, N] in [0, q)."""
    if not _on_cuda(x):
        return ntt_ct.ct_fwd(T, x, meta)
    L = T['q'].shape[0]
    _check("ct_fwd", x, (L, meta.N), T, meta)
    x = x.contiguous()
    out = torch.empty_like(x)
    return _launch("ct_fwd", _lib().fsi_ct_fwd, x,
                   (T['t2'], T['t1'], T['tw']), T['q'], out,
                   x.numel() // (L * meta.N), L, meta)


def ct_fwd_digits(T: dict, digits, meta: CtMeta, digit_bits: int):
    """Forward transform of prime-independent digits int32 [..., N] in
    [0, 2^digit_bits) -> [..., L, N]."""
    if not _on_cuda(digits):
        return ntt_ct.ct_fwd_digits(T, digits, meta, digit_bits)
    if digit_bits > ntt_ct.MAX_DIGIT_BITS:
        raise NotImplementedError(
            f"digit radix above 2^{ntt_ct.MAX_DIGIT_BITS}")
    L = T['q'].shape[0]
    _check("ct_fwd_digits", digits, (meta.N,), T, meta)
    digits = digits.contiguous()
    out = torch.empty(digits.shape[:-1] + (L, meta.N), dtype=torch.int32,
                      device=digits.device)
    return _launch("ct_fwd_digits", _lib().fsi_ct_fwd_digits, digits,
                   (T['t2'], T['t1'], T['tw']), T['q'], out,
                   digits.numel() // meta.N, L, meta)


def ct_inv(T: dict, evals, meta: CtMeta, t2i_key: str = 't2i'):
    """Inverse transform [..., L, N] -> coefficients; t2i_key='t2i_crt'
    folds in the CRT premultiplier."""
    if not _on_cuda(evals):
        return ntt_ct.ct_inv(T, evals, meta, t2i_key)
    L = T['q'].shape[0]
    _check("ct_inv", evals, (L, meta.N), T, meta)
    evals = evals.contiguous()
    out = torch.empty_like(evals)
    return _launch("ct_inv", _lib().fsi_ct_inv, evals,
                   (T['t1i'], T[t2i_key], T['twi']), T['q'], out,
                   evals.numel() // (L * meta.N), L, meta)
