"""Two-level Cooley-Tukey NTT for power-of-two m: tables and plain
PyTorch versions of the three transforms.

Counterpart of fhe_si_tpu/ops/ntt_ct.py (see its header for the
factorization).  For m = 2^k, N = m/2 = phim, W = w^2 of order N:

    c = c1 + N1*c2 (coefficients),  u = j2 + N2*j1 (evaluations)
    forward:  y[c1, j2] = sum_c2 T2[j2, c2] x[c1 + N1*c2]      (stage 1)
              y[c1, j2] *= tw[c1, j2]                          (twiddle)
              X[j1, j2] = sum_c1 T1[j1, c1] y[c1, j2]          (stage 2)
    inverse:  z[c1, j2] = sum_j1 T1i[c1, j1] X[j1, j2]
              z[c1, j2] *= twi[c1, j2]
              x[c1, c2] = sum_j2 T2i[c2, j2] z[c1, j2]

with the chirp and 1/N folded into the tables.  Every stage output is
the canonical residue in [0, q), so each transform is the exact function
`T . x mod q` per stage: the JAX int8-plane Karatsuba, the Pallas
kernels, the CUDA kernels of ntt_ct_cuda.py and the plain versions here
all give bit-identical outputs.

The tables are kept as int32 integers (the JAX package splits them into
int8 digit planes for the MXU, 6 of them on the narrow lane, 9 on the
wide one); ct_tables and with_crt_premultiplier compute every entry in
Python ints or int64 products below 2^46, exact for primes below 2^23 on
both lanes.

The plain versions run each stage as a float64 matmul, which is exact
while every partial sum stays below 2^53.  A stage sums K products of a
table entry (below q < 2^23 on either lane) and an operand y: a residue
below q, or a keyswitch digit below 2^digit_bits <= 2^24.  _stage takes
the widest lane's bound for both: one matmul while K * 2^23 * y_max <
2^53, which covers residue stages up to K = 128 and the digit stage up to
K = 64.  m = 8192 (N1 = N2 = 64) and m = 2^14 (128 x 64) stay inside it.
Past it (the digit stage from m = 2^15, every stage from m = 2^16)
_stage splits the table at 12 bits into two exact matmuls
(K * 2^12 * 2^24 < 2^53 for K < 2^17) and joins them mod q, so no
supported m gives an inexact result.  The mixed-radix family (odd part
of m > 1) is not ported.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..hostmath import numbth

Q_MAX = (1 << 23) - 1    # every chain prime lies below 2^23 (either lane)
MAX_DIGIT_BITS = 24      # keyswitch digit radix (decompSize <= 3)


class CtMeta(NamedTuple):
    """Static transform geometry, kept beside the table dict."""
    N1: int
    N2: int
    phim: int
    q_odd: int       # odd prime of m's odd part (1 for m = 2^k)

    @property
    def N(self) -> int:
        return self.N1 * self.N2


def ct_supported(m: int) -> bool:
    """True when m rides the Cooley-Tukey family: even m >= 8 whose odd
    part is 1 or an odd prime power (numpy-only twin of
    fhe_si_tpu.ops.ntt_ct.ct_supported, which FheContext needs)."""
    if m < 8 or m % 2:
        return False
    odd = m
    while odd % 2 == 0:
        odd //= 2
    if odd == 1:
        return True
    return len(set(numbth.factorize(odd))) == 1


def _split(N: int) -> tuple[int, int]:
    """N = N1*N2 with N1 >= N2, both divisors, as square as possible."""
    best = 1
    for d in range(1, int(math.isqrt(N)) + 1):
        if N % d == 0:
            best = d
    return N // best, best


def ct_tables(m: int, primes, roots) -> tuple[CtMeta, dict]:
    """Per-prime integer tables for power-of-two m (the loop of
    fhe_si_tpu/ops/ntt_ct.py CtNttTables):

      q    [L]            int32 primes
      t1   [L, N1, N1]    W^(N2*j1*c1)
      t2   [L, N2, N2]    W^(N1*j2*c2) * w^(N1*c2)         (rows j2)
      tw   [L, N1, N2]    w^c1 * W^(c1*j2)                 (rows c1)
      t1i  [L, N1, N1]    W^(-N2*j1*c1)
      t2i  [L, N2, N2]    W^(-N1*j2*c2) * w^(-N1*c2) / N   (rows c2)
      twi  [L, N1, N2]    w^(-c1) * W^(-c1*j2)

    All entries are int32 residues in [0, q)."""
    if m < 8 or m & (m - 1):
        raise NotImplementedError(
            f"m={m}: only power-of-two rings ride the ported CT transform")
    N = m // 2
    N1, N2 = _split(N)
    primes = np.asarray(primes, dtype=np.int64)
    roots = np.asarray(roots, dtype=np.int64)
    L = len(primes)
    tabs = {k: np.empty((L,) + s, dtype=np.int64) for k, s in (
        ('t1', (N1, N1)), ('t2', (N2, N2)), ('t1i', (N1, N1)),
        ('t2i', (N2, N2)), ('tw', (N1, N2)), ('twi', (N1, N2)))}
    j1 = np.arange(N1, dtype=np.int64)
    j2 = np.arange(N2, dtype=np.int64)
    c1, c2 = j1, j2
    for l in range(L):
        q, w = int(primes[l]), int(roots[l])
        if pow(w, m, q) != 1 or pow(w, m // 2, q) != q - 1:
            raise ValueError("root is not a primitive m-th root of unity")
        pw = np.empty(m, dtype=np.int64)
        pwi = np.empty(m, dtype=np.int64)
        acc, acci, winv = 1, 1, numbth.modinv(w, q)
        for i in range(m):
            pw[i], pwi[i] = acc, acci
            acc = acc * w % q
            acci = acci * winv % q
        tabs['t1'][l] = pw[(2 * N2 * np.outer(j1, j1)) % m]
        tabs['t1i'][l] = pwi[(2 * N2 * np.outer(j1, j1)) % m]
        tabs['t2'][l] = pw[(N1 * c2[None, :] * (2 * j2[:, None] + 1)) % m]
        tabs['t2i'][l] = (pwi[(N1 * c2[:, None] * (2 * j2[None, :] + 1)) % m]
                          * numbth.modinv(N, q) % q)
        tabs['tw'][l] = pw[(c1[:, None] * (2 * j2[None, :] + 1)) % m]
        tabs['twi'][l] = pwi[(c1[:, None] * (2 * j2[None, :] + 1)) % m]
    tabs = {k: v.astype(np.int32) for k, v in tabs.items()}
    tabs['q'] = primes.astype(np.int32)
    return CtMeta(N1, N2, N, 1), tabs


def with_crt_premultiplier(tabs: dict, binv) -> dict:
    """Table dict plus 't2i_crt' = t2i * binv mod q: the per-row CRT
    premultiplier (binv on value rows, 1 on the redundant row) folded
    into the last stage of ct_inv, so its output feeds
    crt.residues_to_limbs_fast(prescaled=True).  Host-side equivalent of
    fhe_si_tpu/device.py ct_with_crt."""
    binv = np.asarray(binv, dtype=np.int64)
    scale = np.where(binv == 0, 1, binv)
    q = tabs['q'].astype(np.int64)[:, None, None]
    out = dict(tabs)
    out['t2i_crt'] = (tabs['t2i'].astype(np.int64) * scale[:, None, None]
                      % q).astype(np.int32)
    return out


# ------------------------------------------------------------ plain versions
def _check_meta(meta: CtMeta):
    if meta.q_odd != 1:
        raise NotImplementedError("mixed-radix m is not ported")


def _dot(tab, y):
    return torch.matmul(tab.to(torch.float64),
                        y.to(torch.float64)).to(torch.int64)


def _stage(tab, y, q, y_max: int):
    """(tab @ y) mod q per prime, exact (module header).  tab [L, o, k]
    int32 residues, y [..., L or 1, k, f] in [0, y_max] -> int64."""
    if tab.shape[-1] * y_max * Q_MAX < 1 << 53:
        return _dot(tab, y) % q
    hi = _dot(tab >> 12, y) % q
    return (hi * 4096 + _dot(tab & 4095, y)) % q


def ct_fwd(T: dict, x, meta: CtMeta):
    """Evaluations at the primitive m-th roots (zms order, u = j2 + N2*j1)
    of residues x int32 [..., L, N] in [0, q)."""
    _check_meta(meta)
    N1, N2 = meta.N1, meta.N2
    *lead, L, N = x.shape
    q = T['q'].to(torch.int64)[:, None, None]
    y = _stage(T['t2'], x.reshape(*lead, L, N2, N1), q, Q_MAX)  # [.., j2, c1]
    y = y * T['tw'].transpose(-1, -2) % q
    X = _stage(T['t1'], y.transpose(-1, -2), q, Q_MAX)        # [.., j1, j2]
    return X.to(torch.int32).reshape(*lead, L, N)


def ct_fwd_digits(T: dict, digits, meta: CtMeta, digit_bits: int):
    """ct_fwd of prime-independent digit rows: digits int32 [..., N] in
    [0, 2^digit_bits), digit_bits <= 24 -> [..., L, N].  The first mod-q
    reduction happens after the stage-1 products."""
    _check_meta(meta)
    if digit_bits > MAX_DIGIT_BITS:
        raise NotImplementedError(f"digit radix above 2^{MAX_DIGIT_BITS}")
    N1, N2 = meta.N1, meta.N2
    *lead, N = digits.shape
    L = T['q'].shape[0]
    q = T['q'].to(torch.int64)[:, None, None]
    d = digits.reshape(*lead, 1, N2, N1)                       # [.., 1, c2, c1]
    y = _stage(T['t2'], d, q, (1 << digit_bits) - 1)           # [.., L, j2, c1]
    y = y * T['tw'].transpose(-1, -2) % q
    X = _stage(T['t1'], y.transpose(-1, -2), q, Q_MAX)
    return X.to(torch.int32).reshape(*lead, L, N)


def ct_inv(T: dict, evals, meta: CtMeta, t2i_key: str = 't2i'):
    """Inverse of ct_fwd: coefficients in natural c = c1 + N1*c2 order.
    t2i_key='t2i_crt' selects the table with the CRT premultiplier."""
    _check_meta(meta)
    N1, N2 = meta.N1, meta.N2
    *lead, L, N = evals.shape
    q = T['q'].to(torch.int64)[:, None, None]
    z = _stage(T['t1i'], evals.reshape(*lead, L, N1, N2), q, Q_MAX)  # [.., c1, j2]
    z = z * T['twi'] % q
    x = _stage(T[t2i_key], z.transpose(-1, -2), q, Q_MAX)      # [.., c2, c1]
    return x.to(torch.int32).reshape(*lead, L, N)
