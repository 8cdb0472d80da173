"""Hopper kernels for the limb <-> residue conversions of the device
pipelines, and their wrappers.

The JAX package has no Pallas kernel here: its single-pass CRT
reconstruction (fhe_si_tpu/ops/crt.py crt_partials, crt_finish,
residues_to_limbs_fast), the limb tails that follow it (the ScaleDown
rounding of fhe_si_tpu/device.py _scale_down and the signed reduction
of _keyswitch_digits, ops/limbs.py normalize / reduce_mod_q) and the
lift ops/crt.py limbs_to_residues are jnp code that XLA fuses on the
TPU.  Run eagerly, the plain versions (ops/crt.py, ops/limbs.py) are
hundreds of launches per mul+relin step with [..., L, phim, n] planes in
device memory.  Two kernels of fhe_si_tpu_torch/csrc/crt.cu take their
place, built and loaded like csrc/ct_ntt.cu (cuda_build.library):

  crt_to_limbs       one kernel, three modes: crt_partials (the 'limb'
                     shards all-reduce its partials), crt_finish (after
                     that all-reduce) and crt_to_limbs (both in
                     registers), the last two with an optional Tail:
                     ScaleDown's rounding or the signed reduction,
                     written at the ciphertext width;
  limbs_to_residues  limbs -> canonical residues of every prime, from one
                     limb tensor or from two (the operands of
                     DeviceContext._tensor_mul, without joining them).

Dispatch: a tensor on the CPU takes the plain version (the *_plain
functions here, made of ops/crt.py and ops/limbs.py as DeviceContext
composed them; for the lift, crt.limbs_to_residues itself); a tensor on
a CUDA device launches the kernel (cuda_build.launch), or raises.  There
is no fallback.  The host checks dtypes, contiguity, shapes and what the
kernels' exactness rests on (crt.cu header; the limits of cuda_build):
at most MAX_ROWS residue rows, at most MAX_LIMBS limbs, primes below
2^23, fewer than 2^31 coefficients a launch.  DeviceContext checks
its bases' shapes and primes (check_shape, on the host tables) when it
is built on a CUDA device, so a basis the kernels cannot take raises
before any path reaches them; kernel_table checks m_r.
cuda_build.LAUNCHES counts the launches of each kernel under its
wrapper's name, crt_to_limbs whatever its mode.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..context import int_to_limbs
from ..profiling import annotate
from . import crt, limbs as lb
from .cuda_build import (MAX_LIMBS, MAX_ROWS, Q_LIMIT, check_coeffs,
                         check_primes, launch, on_cuda)

HEADER, ROW_WORDS = 8, 4
PASS_ROW = 28          # crt.cu kPassRow: words a row of the one-pass section
TAIL_CODES = {None: 0, "round_down": 1, "reduce_signed": 2}


class Tail(NamedTuple):
    """A limb tail on the reconstruction, mod 2^log_q, written at `width`
    limbs: 'round_down' is ScaleDown's floor((2x + 2^logQ) / 2^(logQ+1))
    followed by the signed reduction; 'reduce_signed' is Reduce's centred
    representative in [-2^(logQ-1), 2^(logQ-1)) alone."""
    kind: str
    log_q: int
    width: int


def split_words(rows: int, n: int) -> int:
    """Words of kernel_table's first section (the split form's tables,
    crt_kernel's) for a basis of `rows` rows and n limbs."""
    return HEADER + ROW_WORDS * rows + 2 * rows * n + 2 * n


def pass_offset(rows: int, n: int) -> int:
    """Where the one-pass section (crt_pass_kernel's) starts: the first
    16-byte boundary after the split form's words."""
    return -(-split_words(rows, n) // 4) * 4


def table_words(rows: int, n: int) -> int:
    """Words of kernel_table for a basis of `rows` rows and n limbs: no
    one-pass section past MAX_LIMBS (check_shape refuses such a basis
    before any launch)."""
    if n > MAX_LIMBS:
        return split_words(rows, n)
    return pass_offset(rows, n) + HEADER + PASS_ROW * (rows + 1)


def words32(limbs) -> np.ndarray:
    """16-bit limbs [..., n] -> the 32-bit words [..., ceil(n/2)] of the
    same integer (limbs 2j and 2j + 1), int64."""
    limbs = np.asarray(limbs, np.int64)
    n = limbs.shape[-1]
    x = np.zeros(limbs.shape[:-1] + (n + n % 2,), np.int64)
    x[..., :n] = limbs
    return x[..., 0::2] | (x[..., 1::2] << 16)


def _shoup(w, q):
    """floor(w 2^32 / q) for 0 <= w < q < 2^23, int64."""
    return (np.asarray(w, np.int64) << 32) // q


def kernel_table(fc: dict) -> np.ndarray:
    """The basis table crt.cu reads, from the numpy single-pass CRT
    tables (FheContext._fast_crt_for, sliced to a shard's rows where
    DeviceContext has rows), as int32 words (the bit patterns of uint32).
    The split form's section (split_words): [rows, n, m_r, P^-1 mod m_r,
    its Shoup w', 0, 0, 0], per row (Bmodr, its w', er_mask, 0), then B
    [rows, n], Bh [rows, n], P_limbs [n] and P_limbs_sh10 [n]; w' =
    floor(w 2^32 / m_r).  Zeros to pass_offset, then the one-pass
    section: [ceil(n/2), 2^32 mod m_r, its w', floor(2^32 / m_r), 0, 0,
    0, 0], per row PASS_ROW words (Bmodr, er_mask, B's 32-bit words
    (words32), zeros) and a last row with P's words in B's columns; the
    latter only up to MAX_LIMBS limbs (table_words)."""
    B = np.asarray(fc['B'], np.int64)
    rows, n = B.shape
    mr, pinv = int(fc['mr']), int(fc['Pinv_r'])
    if not 2 <= mr < Q_LIMIT:
        raise ValueError(f"the CRT kernel takes a redundant modulus below "
                         f"2^23, not {mr}")
    bmodr = np.asarray(fc['Bmodr'], np.int64)
    per_row = np.zeros((rows, ROW_WORDS), np.int64)
    per_row[:, 0], per_row[:, 1] = bmodr, _shoup(bmodr, mr)
    per_row[:, 2] = fc['er_mask']
    words = np.concatenate([
        np.array([rows, n, mr, pinv, _shoup(pinv, mr), 0, 0, 0], np.int64),
        per_row.ravel(), B.ravel(), np.asarray(fc['Bh'], np.int64).ravel(),
        np.asarray(fc['P_limbs'], np.int64),
        np.asarray(fc['P_limbs_sh10'], np.int64)])
    if n > MAX_LIMBS:
        return words.astype(np.uint32).view(np.int32)
    nw = (n + 1) // 2
    c32 = (1 << 32) % mr
    rows_w = np.zeros((rows + 1, PASS_ROW), np.int64)
    rows_w[:rows, 0], rows_w[:rows, 1] = bmodr, fc['er_mask']
    rows_w[:rows, 2:2 + nw] = words32(B)
    rows_w[rows, 2:2 + nw] = words32(fc['P_limbs'])
    words = np.concatenate([
        words, np.zeros(pass_offset(rows, n) - words.size, np.int64),
        np.array([nw, c32, _shoup(c32, mr), (1 << 32) // mr, 0, 0, 0, 0],
                 np.int64), rows_w.ravel()])
    assert words.size == table_words(rows, n)
    return words.astype(np.uint32).view(np.int32)


def check_shape(name: str, shape, rows: int, n: int, primes=None):
    """Raise ValueError, with the input's shape, unless the kernels take
    `rows` residue rows and n limbs, and, where the basis' primes (a
    numpy array) are given, every one of them."""
    if not (1 <= rows <= MAX_ROWS and 1 <= n <= MAX_LIMBS):
        raise ValueError(f"{name}: input {tuple(shape)} has {rows} residue "
                         f"rows and {n} limbs; the kernel takes at most "
                         f"{MAX_ROWS} rows and {MAX_LIMBS} limbs")
    if primes is not None:
        check_primes(name, shape, primes)


def _check_tail(name: str, tail, n: int):
    if tail is None:
        return
    if tail.kind not in TAIL_CODES or not (
            16 * n > tail.log_q and 16 * tail.width > tail.log_q
            and tail.width <= MAX_LIMBS):
        raise ValueError(f"{name}: tail {tail} on {n} limbs")


# ------------------------------------------------------- plain versions
def tail_plain(x, tail: Tail | None):
    """The tail on the limbs x [..., n] with the ops of ops/limbs.py:
    shift_left 1, + 2^logQ, arith_shift_right logQ + 1 (round_down), then
    reduce_mod_q signed at tail.width."""
    if tail is None:
        return x
    q_limbs = torch.as_tensor(int_to_limbs(1 << tail.log_q,
                                           max(x.shape[-1], tail.width)),
                              device=x.device)
    if tail.kind == "round_down":
        y = lb.shift_left(x, 1)
        y = lb.add(y, q_limbs[:x.shape[-1]].expand(y.shape))
        x = lb.arith_shift_right(y, tail.log_q + 1)
    return lb.reduce_mod_q(x, tail.log_q, False, q_limbs, out_width=tail.width)


def crt_partials_plain(res, t, wide: bool = False):
    return crt.crt_partials(res, t, None, None, prescaled=True, wide=wide)


def crt_finish_plain(acc, sig_raw, er, t, wide: bool = False,
                     tail: Tail | None = None):
    return tail_plain(crt.crt_finish(acc, sig_raw, er, t, t['B'].shape[-1],
                                     wide), tail)


def crt_to_limbs_plain(res, t, wide: bool = False, tail: Tail | None = None):
    return tail_plain(crt.residues_to_limbs_fast(res, t, None, None,
                                                 prescaled=True, wide=wide),
                      tail)


# ------------------------------------------------------------- launches
def _basis(name: str, t: dict, shape):
    """(rows, n, table) of the basis t, after checking that the kernel
    takes it and that its table was built."""
    rows, n = t['B'].shape
    check_shape(name, shape, rows, n)
    tab = t.get('k_crt')
    if tab is None or tab.numel() != table_words(rows, n):
        raise ValueError(f"{name}: the tables lack k_crt for {rows} x {n}; "
                         "build it with crt_cuda.kernel_table (DeviceContext "
                         "does)")
    return rows, n, tab


def _residues(name: str, res, rows: int):
    if res.dim() < 2 or res.shape[-2] != rows:
        raise ValueError(f"{name}: expected [..., {rows}, phim] residues, "
                         f"got {tuple(res.shape)}")
    return res.contiguous()


def crt_partials(res, t: dict, wide: bool = False):
    """The per-row half of the reconstruction of prescaled residues
    [..., rows, phim] (the redundant row last where the basis has it):
    (acc [..., phim, n], sig_raw [..., phim], er [..., phim]), element
    for element crt.crt_partials(prescaled=True)."""
    if not on_cuda(res):
        return crt_partials_plain(res, t, wide)
    rows, n, tab = _basis("crt_partials", t, res.shape)
    res = _residues("crt_partials", res, rows)
    lead, phim = res.shape[:-2], res.shape[-1]
    opts = dict(dtype=torch.int32, device=res.device)
    acc = torch.empty(lead + (phim, n), **opts)
    sig, er = (torch.empty(lead + (phim,), **opts) for _ in range(2))
    if acc.numel():
        launch("crt_to_limbs", "fsi_crt_partials", (res, tab, acc, sig, er),
               (sig.numel(), phim, rows, n), int32=True, contiguous=True)
    return acc, sig, er


def crt_finish(acc, sig_raw, er, t: dict, wide: bool = False,
               tail: Tail | None = None):
    """crt.crt_finish of (all-reduced) partials -> limbs [..., phim, n],
    then `tail` (limbs [..., phim, tail.width])."""
    if not on_cuda(acc):
        return crt_finish_plain(acc, sig_raw, er, t, wide, tail)
    rows, n, tab = _basis("crt_finish", t, acc.shape)
    _check_tail("crt_finish", tail, n)
    if acc.shape[-1] != n or sig_raw.shape != acc.shape[:-1] \
            or er.shape != sig_raw.shape:
        raise ValueError(f"crt_finish: partials {tuple(acc.shape)}, "
                         f"{tuple(sig_raw.shape)}, {tuple(er.shape)} for "
                         f"{n} limbs")
    width = n if tail is None else tail.width
    out = torch.empty(sig_raw.shape + (width,), dtype=torch.int32,
                      device=acc.device)
    if out.numel():
        launch("crt_to_limbs", "fsi_crt_finish",
               (acc.contiguous(), sig_raw.contiguous(), er.contiguous(), tab,
                out),
               (sig_raw.numel(), rows, n, TAIL_CODES[tail and tail.kind],
                tail.log_q if tail else 0, width), int32=True, contiguous=True)
    return out


def crt_to_limbs(res, t: dict, wide: bool = False, tail: Tail | None = None):
    """Prescaled residues [..., rows, phim] -> the centred value as limbs
    [..., phim, n] (crt.residues_to_limbs_fast(prescaled=True)), then
    `tail` (limbs [..., phim, tail.width]).  Nothing of size
    [..., rows, phim, n] reaches device memory."""
    with annotate("fhe.crt_to_limbs"):
        if not on_cuda(res):
            return crt_to_limbs_plain(res, t, wide, tail)
        rows, n, tab = _basis("crt_to_limbs", t, res.shape)
        _check_tail("crt_to_limbs", tail, n)
        res = _residues("crt_to_limbs", res, rows)
        lead, phim = res.shape[:-2], res.shape[-1]
        width = n if tail is None else tail.width
        check_coeffs("crt_to_limbs", res.shape, res.numel() // rows)
        out = torch.empty(lead + (phim, width), dtype=torch.int32,
                          device=res.device)
        if out.numel():
            launch("crt_to_limbs", "fsi_crt_to_limbs", (res, tab, out),
                   (out.numel() // width, phim, rows, n,
                    TAIL_CODES[tail and tail.kind], tail.log_q if tail else 0,
                    width), int32=True, contiguous=True)
        return out


def limbs_to_residues(poly, chunk_tbl, wrap, q, qinv_f, wide: bool = False,
                      second=None):
    """Limbs [..., phim, n] -> canonical residues [..., L, phim], equal to
    crt.limbs_to_residues.  With `second`, poly [..., ka, phim, n] and
    second [..., kb, phim, n] (the same lead and width) -> [..., ka + kb,
    L, phim], equal to crt.limbs_to_residues of their join along the
    parts axis, which the kernel does not make: it reads each part from
    its own tensor.  chunk_tbl [>= 4n, L] (2^(4c) mod q_l; the kernel
    reads its rows 0, 8, 16, ...), wrap [L, 1] = 2^(16n) mod q_l, q [L,
    1], its primes below 2^23 (DeviceContext checks them on the host)."""
    with annotate("fhe.limbs_to_residues"):
        if second is not None and (poly.dim() < 3 or second.dim() != poly.dim()
                                   or second.shape[:-3] != poly.shape[:-3]
                                   or second.shape[-2:] != poly.shape[-2:]):
            raise ValueError(
                f"limbs_to_residues: parts {tuple(poly.shape)} and "
                f"{tuple(second.shape)} do not join along axis -3")
        if not on_cuda(poly):
            if second is not None:
                poly = torch.cat([poly, second], dim=-3)
            return crt.limbs_to_residues(poly, chunk_tbl, wrap, q, qinv_f,
                                         wide)
        n, L = poly.shape[-1], q.shape[0]
        check_shape("limbs_to_residues", poly.shape, L, n)
        if poly.dim() < 2 or chunk_tbl.dim() != 2 \
                or chunk_tbl.shape[0] < 4 * n or chunk_tbl.shape[1] != L \
                or wrap.numel() != L or q.numel() != L:
            raise ValueError(f"limbs_to_residues: limbs {tuple(poly.shape)}, "
                             f"chunk table {tuple(chunk_tbl.shape)}, wrap "
                             f"{tuple(wrap.shape)}, q {tuple(q.shape)}")
        phim = poly.shape[-2]
        if second is None:
            lead, ka, kb = poly.shape[:-2], 1, 0
            b = poly = poly.contiguous()
        else:
            lead = poly.shape[:-3] + (poly.shape[-3] + second.shape[-3],)
            ka, kb = poly.shape[-3], second.shape[-3]
            poly, b = poly.contiguous(), second.contiguous()
        check_coeffs("limbs_to_residues", poly.shape,
                     (poly.numel() + (b.numel() if kb else 0)) // n)
        out = torch.empty(lead + (L, phim), dtype=torch.int32,
                          device=poly.device)
        if out.numel():
            launch("limbs_to_residues", "fsi_limbs_to_residues",
                   (poly, b, chunk_tbl, q, wrap, out),
                   (out.numel() // ((ka + kb) * L * phim), ka, kb, phim, L, n),
                   int32=True, contiguous=True)
        return out
