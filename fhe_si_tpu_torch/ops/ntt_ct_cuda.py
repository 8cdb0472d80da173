"""Hopper kernels for the three Cooley-Tukey transforms, and their
wrappers.

Stands in for fhe_si_tpu/ops/ntt_ct_pallas.py.  The kernels live in
fhe_si_tpu_torch/csrc/ct_ntt.cu (CUDA C++ for sm_90a, a plain C
interface); the first launch compiles them with nvcc into
fhe_si_tpu_torch/_build/ and loads the library with ctypes.  Nothing is
compiled or loaded at import, so this module imports on a machine
without nvcc.  All three transforms run one tensor-core kernel (int8
byte planes, mma.sync) on the N-point transform of every ring
m = 2^a * q^b whose split N1 x N2 it takes (check_kernel_shape: both
sides at least 2 and the layout inside shared memory; every power of two
from m = 8 to 2^15, m = 20480 = 128 x 80, m = 13122 = 81 x 81).  Around
the launch the wrappers run the plain phim <-> N helpers of ops/ntt_ct.py
(pad and drop forward, insert and fold inverse), no-ops on m = 2^k.  The
kernel reads the byte planes and Shoup reciprocals that kernel_tables
prepares here on the host and DeviceContext keeps beside the tables
(T['ct']); tables without them raise on a CUDA tensor.

Dispatch: a tensor on the CPU takes the plain version of ops/ntt_ct.py;
a tensor on a CUDA device launches the kernel, or raises.  There is no
fallback from a failed launch or a split the kernel cannot take.
LAUNCHES counts the kernel launches of each wrapper (the plain path does
not count).

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

import numpy as np
import torch

from . import ntt_ct
from .ntt_ct import CtMeta

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "ct_ntt.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES = {"ct_fwd": 0, "ct_fwd_digits": 0, "ct_inv": 0}


# ---------------------------------------------- tensor-core kernel tables
KERNEL_CONSTS = 10   # per prime: q, floor(2^32/q), 2^(8d) mod q, reciprocals


def _pad(x: int, a: int) -> int:
    return -(-x // a) * a


def _reciprocal(w, q):
    """Shoup's floor(w 2^32 / q) for 0 <= w < q < 2^23, int64."""
    return (np.asarray(w, np.int64) << 32) // q


def byte_planes(tab) -> np.ndarray:
    """Square tables [L, M, M] with entries below 2^24 as the kernel's
    A operand: uint8 [L, 3, pad16(M), pad32(M) + 16], plane p holding
    byte p of each entry, zero in the padding."""
    tab = np.asarray(tab, np.int64)
    L, M, _ = tab.shape
    out = np.zeros((L, 3, _pad(M, 16), _pad(M, 32) + 16), np.uint8)
    for p in range(3):
        out[:, p, :M, :M] = (tab >> (8 * p)) & 255
    return out


def tw_stride(R: int) -> int:
    """Words per twiddle row (ct_ntt.cu Geo::tws): the R (w, w') pairs
    and at least 16 words of zero padding, rounded up to a multiple of 4
    so that every 16-byte twiddle load, and every prime's base, is
    aligned whatever the parity of R."""
    return _pad(2 * R + 16, 4)


def twiddle_pairs(tw, q) -> np.ndarray:
    """Twiddle [L, S, R] (rows as the kernel's stage-1 output) as int32
    bit patterns of uint32 [L, S, tw_stride(R)]: (w, floor(w 2^32 / q))
    pairs, zero in the padding."""
    tw = np.asarray(tw, np.int64)
    L, S, R = tw.shape
    out = np.zeros((L, S, tw_stride(R)), np.int64)
    out[..., 0:2 * R:2] = tw
    out[..., 1:2 * R:2] = _reciprocal(tw, np.asarray(q, np.int64)[:, None, None])
    return out.astype(np.uint32).view(np.int32)


def prime_consts(q) -> np.ndarray:
    """Per prime: q, floor(2^32/q), c_d = 2^(8d) mod q for d = 1..4 and
    their reciprocals floor(c_d 2^32 / q); int32 bit patterns of uint32
    [L, KERNEL_CONSTS]."""
    q = np.asarray(q, np.int64)[:, None]
    c = (1 << (8 * np.arange(1, 5, dtype=np.int64))) % q
    out = np.concatenate([q, (1 << 32) // q, c, _reciprocal(c, q)], axis=1)
    return out.astype(np.uint32).view(np.int32)


def kernel_tables(ct: dict) -> dict:
    """What the tensor-core kernel reads, from the numpy tables of
    ntt_ct.ct_tables (and t2i_crt where present): k_<table> byte planes
    of t1, t2, t1i, t2i, t2i_crt; k_tw the forward twiddle transposed to
    the forward transforms' [N2, N1] stage-1 layout, k_twi the inverse one
    [N1, N2], both with reciprocals; k_consts per prime."""
    q = np.asarray(ct['q'], np.int64).reshape(-1)
    out = {'k_consts': prime_consts(q),
           'k_tw': twiddle_pairs(np.swapaxes(ct['tw'], 1, 2), q),
           'k_twi': twiddle_pairs(ct['twi'], q)}
    for name in ('t1', 't2', 't1i', 't2i', 't2i_crt'):
        if name in ct:
            out['k_' + name] = byte_planes(ct[name])
    return out


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _so_path() -> Path:
    """The library's path, tagged by the source and the flags."""
    tag = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libct_ntt_{tag.hexdigest()[:12]}.so"


@functools.cache
def _lib() -> ctypes.CDLL:
    """Build (once per source version) and load the kernel library; nvcc's
    output (ptxas -v: registers, shared memory, spills per kernel) goes
    beside it as .log."""
    so = _so_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        run = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                             capture_output=True, text=True)
        if run.returncode:
            raise RuntimeError(f"nvcc failed ({run.returncode}):\n"
                               f"{run.stdout}{run.stderr}")
        so.with_suffix(".log").write_text(run.stdout + run.stderr)
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name in ("fsi_ct_fwd", "fsi_ct_fwd_digits", "fsi_ct_inv"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * 6 + [i64, i32, i32, i32, ptr]
        fn.restype = ctypes.c_int
    lib.fsi_ct_mma_smem.argtypes = [i32, i32]
    lib.fsi_ct_mma_smem.restype = i64
    lib.fsi_smem_optin.argtypes = []
    lib.fsi_smem_optin.restype = i32
    return lib


def build() -> str:
    """Compile and load the kernels now (otherwise the first launch does);
    returns nvcc's report of registers, shared memory and spills."""
    _lib()
    log = _so_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def _on_cuda(x) -> bool:
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    return True


SMEM_MAX = 232448       # ct_ntt.cu kSmemMax: an H100 block's opt-in bytes


def kernel_smem(S: int, R: int) -> int:
    """Dynamic shared memory of ct_mma_kernel for a row [S][R]: Geo's
    formula in ct_ntt.cu (fsi_ct_mma_smem returns the same number on the
    card).  The four byte-plane blocks, and the twiddle pairs where the
    whole layout fits in SMEM_MAX."""
    ks1, ks2 = _pad(S, 32) + 16, _pad(R, 32) + 16
    planes = 3 * (_pad(S, 16) * ks1 + _pad(R, 16) * ks2
                  + _pad(R, 16) * ks1 + _pad(S, 16) * ks2)
    tw = S * tw_stride(R) * 4
    return planes + tw if planes + tw <= SMEM_MAX else planes


def check_kernel_shape(name: str, shape, S: int, R: int,
                       limit: int = SMEM_MAX):
    """Raise ValueError, with the input's shape, unless ct_mma_kernel
    takes a row [S][R] (S = N2, R = N1 forward; S = N1, R = N2 inverse):
    both sides at least 2 and the layout inside `limit` bytes of shared
    memory per block.  Every such split also keeps the kernel's launch
    limits (sides up to 224 of its 1024, at most 16 input tiles per warp).
    The wrappers call it before every launch; the plain versions take
    every split."""
    split = f"input {tuple(shape)} (N1 x N2 = {max(S, R)} x {min(S, R)})"
    if min(S, R) < 2:
        raise ValueError(f"{name}: {split}: the tensor-core kernel needs "
                         "N1, N2 >= 2")
    need = kernel_smem(S, R)
    if need > limit:
        raise ValueError(f"{name}: {split} needs {need} bytes of shared "
                         f"memory per block; the card allows {limit}")


def _launch(name: str, fn, inp, tabs, out, rows, L, meta: CtMeta):
    """Check the operands, launch on the current stream, count."""
    for t in (inp, *tabs, out):
        if t.device != inp.device or not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous tensors "
                             f"on {inp.device}")
    if inp.dtype != torch.int32 or out.dtype != torch.int32:
        raise ValueError(f"{name}: input and output must be int32")
    if rows == 0:
        return out
    with torch.cuda.device(inp.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(inp.data_ptr(), *(t.data_ptr() for t in tabs),
                 out.data_ptr(), rows, L, meta.N1, meta.N2, stream)
    if err:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    LAUNCHES[name] += 1
    return out


def _check(name, x, tail: tuple, T: dict):
    if tuple(x.shape[-len(tail):]) != tail:
        raise ValueError(f"{name}: expected [..., {', '.join(map(str, tail))}]"
                         f", got {tuple(x.shape)}")
    q = T['q']
    if not getattr(q, "_fsi_q_checked", False):
        if not 2 <= int(q.min()) <= int(q.max()) <= ntt_ct.Q_MAX:
            raise ValueError(f"{name}: the kernels take primes below "
                             f"2^{ntt_ct.Q_MAX.bit_length()} only")
        q._fsi_q_checked = True


@functools.cache
def _smem_limit(device: torch.device) -> int:
    with torch.cuda.device(device):
        return _lib().fsi_smem_optin()


def _mma_tables(name, x, T: dict, keys, S: int, R: int):
    """The tensor-core kernel's tables, after checking that it takes the
    split (check_kernel_shape, against the card's shared memory)."""
    missing = [k for k in keys if k not in T]
    if missing:
        raise ValueError(f"{name}: the tables lack {missing}; build them "
                         "with ntt_ct_cuda.kernel_tables (DeviceContext does)")
    check_kernel_shape(name, x.shape, S, R, _smem_limit(x.device))
    return tuple(T[k] for k in keys)


def ct_fwd(T: dict, x, meta: CtMeta):
    """Forward transform of residues int32 [..., L, phim] in [0, q)."""
    if not _on_cuda(x):
        return ntt_ct.ct_fwd(T, x, meta)
    L = T['q'].shape[0]
    _check("ct_fwd", x, (L, meta.phim), T)
    tabs = _mma_tables("ct_fwd", x, T, ('k_t2', 'k_t1', 'k_tw', 'k_consts'),
                       meta.N2, meta.N1)
    x = ntt_ct.pad_to_N(x, meta).contiguous()
    out = _launch("ct_fwd", _lib().fsi_ct_fwd, x, tabs, torch.empty_like(x),
                  x.numel() // (L * meta.N), L, meta)
    return ntt_ct.drop_excluded(out, meta)


def ct_fwd_digits(T: dict, digits, meta: CtMeta, digit_bits: int):
    """Forward transform of prime-independent digits int32 [..., phim] in
    [0, 2^digit_bits) -> [..., L, phim]."""
    if not _on_cuda(digits):
        return ntt_ct.ct_fwd_digits(T, digits, meta, digit_bits)
    if digit_bits > ntt_ct.MAX_DIGIT_BITS:
        raise NotImplementedError(
            f"digit radix above 2^{ntt_ct.MAX_DIGIT_BITS}")
    L = T['q'].shape[0]
    _check("ct_fwd_digits", digits, (meta.phim,), T)
    tabs = _mma_tables("ct_fwd_digits", digits, T,
                       ('k_t2', 'k_t1', 'k_tw', 'k_consts'), meta.N2, meta.N1)
    digits = ntt_ct.pad_to_N(digits, meta).contiguous()
    out = torch.empty(digits.shape[:-1] + (L, meta.N), dtype=torch.int32,
                      device=digits.device)
    out = _launch("ct_fwd_digits", _lib().fsi_ct_fwd_digits, digits, tabs,
                  out, digits.numel() // meta.N, L, meta)
    return ntt_ct.drop_excluded(out, meta)


def ct_inv(T: dict, evals, meta: CtMeta, t2i_key: str = 't2i'):
    """Inverse transform [..., L, phim] -> coefficients; t2i_key='t2i_crt'
    folds in the CRT premultiplier."""
    if not _on_cuda(evals):
        return ntt_ct.ct_inv(T, evals, meta, t2i_key)
    L = T['q'].shape[0]
    _check("ct_inv", evals, (L, meta.phim), T)
    tabs = _mma_tables("ct_inv", evals, T,
                       ('k_t1i', 'k_' + t2i_key, 'k_twi', 'k_consts'),
                       meta.N1, meta.N2)
    evals = ntt_ct.insert_excluded(evals, meta).contiguous()
    out = _launch("ct_inv", _lib().fsi_ct_inv, evals, tabs,
                  torch.empty_like(evals), evals.numel() // (L * meta.N), L,
                  meta)
    return ntt_ct.fold_mod_phim(out, T['q'], meta)
