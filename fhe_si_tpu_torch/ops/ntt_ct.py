"""Two-level Cooley-Tukey NTT for m = 2^a * q^b (q an odd prime): tables
and plain PyTorch versions of the three transforms.

Counterpart of fhe_si_tpu/ops/ntt_ct.py (see its header for the
factorization).  N = m/2, W = w^2 of order N, N = N1*N2 (ops _split):

    c = c1 + N1*c2 (coefficients),  u = j2 + N2*j1 (evaluations)
    forward:  y[c1, j2] = sum_c2 T2[j2, c2] x[c1 + N1*c2]      (stage 1)
              y[c1, j2] *= tw[c1, j2]                          (twiddle)
              X[j1, j2] = sum_c1 T1[j1, c1] y[c1, j2]          (stage 2)
    inverse:  z[c1, j2] = sum_j1 T1i[c1, j1] X[j1, j2]
              z[c1, j2] *= twi[c1, j2]
              x[c1, c2] = sum_j2 T2i[c2, j2] z[c1, j2]

with the chirp and 1/N folded into the tables.  Every stage output is
the canonical residue in [0, q), so each N-point transform (ct_*_n) is
the exact function `T . x mod q` per stage: the JAX int8-plane
Karatsuba, the Pallas kernels, the CUDA kernel of ntt_ct_cuda.py and the
plain versions here all give bit-identical outputs.

For m = 2^k, phim = N and the public transforms are the N-point ones.
For an odd part q^b > 1, phim = N (q-1)/q and the public transforms take
and return phim-wide tensors, as the JAX package's do: the forward one
zero-pads the coefficients to N (pad_to_N) and keeps the evaluations u
with u mod q != (q-1)/2 (drop_excluded); the inverse one puts a zero at
the excluded u (insert_excluded), runs the N-point inverse and reduces
the degree<N result mod Phi_m by one signed block fold (fold_mod_phim,
X^(phim+r) = sum_{i<q-1} (-1)^(i+1) X^(i*s+r), s = N/q).  The fold is
linear, so the CRT premultiplier of t2i_crt may sit before it.  The CUDA
wrappers run the same helpers around the kernel, which computes only the
N-point transform.

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
K = 64.  Past it (the digit stage from m = 2^15 or N2 = 80 at m = 20480,
every stage from m = 2^16) _stage splits the table at 12 bits into two
exact matmuls (K * 2^12 * 2^24 < 2^53 for K < 2^17) and joins them mod
q, so no supported m gives an inexact result.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..hostmath import numbth
from .modular import mod_add

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

    @property
    def u0(self) -> int:
        """Excluded DFT row residue: u = (q-1)/2 (mod q) has q | 2u+1."""
        return (self.q_odd - 1) // 2


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


def _odd_prime(m: int) -> int:
    odd = m
    while odd % 2 == 0:
        odd //= 2
    return 1 if odd == 1 else min(numbth.factorize(odd))


def _split(N: int) -> tuple[int, int]:
    """N = N1*N2 with N1 >= N2, both divisors, as square as possible."""
    best = 1
    for d in range(1, int(math.isqrt(N)) + 1):
        if N % d == 0:
            best = d
    return N // best, best


def ct_tables(m: int, primes, roots) -> tuple[CtMeta, dict]:
    """Per-prime integer tables for m = 2^a * q^b (the loop of
    fhe_si_tpu/ops/ntt_ct.py CtNttTables):

      q    [L]            int32 primes
      t1   [L, N1, N1]    W^(N2*j1*c1)
      t2   [L, N2, N2]    W^(N1*j2*c2) * w^(N1*c2)         (rows j2)
      tw   [L, N1, N2]    w^c1 * W^(c1*j2)                 (rows c1)
      t1i  [L, N1, N1]    W^(-N2*j1*c1)
      t2i  [L, N2, N2]    W^(-N1*j2*c2) * w^(-N1*c2) / N   (rows c2)
      twi  [L, N1, N2]    w^(-c1) * W^(-c1*j2)

    All entries are int32 residues in [0, q)."""
    if not ct_supported(m):
        raise ValueError(f"m={m}: the Cooley-Tukey family takes even "
                         "m >= 8 whose odd part is a prime power")
    N = m // 2
    q_odd = _odd_prime(m)
    phim = N if q_odd == 1 else N // q_odd * (q_odd - 1)
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
    return CtMeta(N1, N2, phim, q_odd), tabs


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


# ------------------------------------------------- phim <-> N (module header)
def pad_to_N(x, meta: CtMeta):
    """[..., phim] coefficients or digits -> [..., N], zeros on top."""
    if meta.q_odd == 1:
        return x
    return F.pad(x, (0, meta.N - meta.phim))


def drop_excluded(full, meta: CtMeta):
    """[..., N] DFT output in u-order -> [..., phim], the rows with 2u+1
    coprime to m (u mod q != u0): a reshape and a column slice."""
    if meta.q_odd == 1:
        return full
    q, u0 = meta.q_odd, meta.u0
    g = full.reshape(full.shape[:-1] + (meta.N // q, q))
    return torch.cat([g[..., :u0], g[..., u0 + 1:]], dim=-1).reshape(
        full.shape[:-1] + (meta.phim,))


def insert_excluded(evals, meta: CtMeta):
    """Inverse of drop_excluded: a zero column at the excluded residue."""
    if meta.q_odd == 1:
        return evals
    q, u0 = meta.q_odd, meta.u0
    g = evals.reshape(evals.shape[:-1] + (meta.N // q, q - 1))
    z = torch.zeros(g.shape[:-1] + (1,), dtype=evals.dtype,
                    device=evals.device)
    return torch.cat([g[..., :u0], z, g[..., u0:]], dim=-1).reshape(
        evals.shape[:-1] + (meta.N,))


def fold_mod_phim(z, q, meta: CtMeta):
    """Degree<N coefficients -> degree<phim, exactly mod Phi_m (module
    header).  z: residues [..., L, N] in [0, q), q: the primes [L]."""
    if meta.q_odd == 1:
        return z
    qo, phim = meta.q_odd, meta.phim
    s = meta.N - phim
    head = z[..., :phim].reshape(z.shape[:-1] + (qo - 1, s))
    tail = z[..., None, phim:]                       # [..., L, 1, s]
    qd = q.reshape(-1, 1, 1)
    # block i takes the tail with sign (-1)^(i+1): -, +, -, ...; as an
    # addend, q - tail (in [1, q]) on the minus blocks
    neg = (torch.arange(qo - 1, device=z.device) % 2 == 0)[:, None]
    folded = mod_add(head, torch.where(neg, qd - tail, tail), qd)
    return folded.reshape(z.shape[:-1] + (phim,))


# ------------------------------------------------------------ plain versions
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


def ct_fwd_n(T: dict, x, meta: CtMeta):
    """The N-point forward transform of residues x int32 [..., L, N] in
    [0, q): evaluations in u order (u = j2 + N2*j1)."""
    N1, N2 = meta.N1, meta.N2
    *lead, L, N = x.shape
    q = T['q'].to(torch.int64)[:, None, None]
    y = _stage(T['t2'], x.reshape(*lead, L, N2, N1), q, Q_MAX)  # [.., j2, c1]
    y = y * T['tw'].transpose(-1, -2) % q
    X = _stage(T['t1'], y.transpose(-1, -2), q, Q_MAX)        # [.., j1, j2]
    return X.to(torch.int32).reshape(*lead, L, N)


def ct_fwd_digits_n(T: dict, digits, meta: CtMeta, digit_bits: int):
    """ct_fwd_n of prime-independent digit rows: digits int32 [..., N] in
    [0, 2^digit_bits), digit_bits <= 24 -> [..., L, N].  The first mod-q
    reduction happens after the stage-1 products."""
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


def ct_inv_n(T: dict, evals, meta: CtMeta, t2i_key: str = 't2i'):
    """Inverse of ct_fwd_n: degree<N coefficients in natural
    c = c1 + N1*c2 order.  t2i_key='t2i_crt' selects the table with the
    CRT premultiplier."""
    N1, N2 = meta.N1, meta.N2
    *lead, L, N = evals.shape
    q = T['q'].to(torch.int64)[:, None, None]
    z = _stage(T['t1i'], evals.reshape(*lead, L, N1, N2), q, Q_MAX)  # [.., c1, j2]
    z = z * T['twi'] % q
    x = _stage(T[t2i_key], z.transpose(-1, -2), q, Q_MAX)      # [.., c2, c1]
    return x.to(torch.int32).reshape(*lead, L, N)


def ct_fwd(T: dict, x, meta: CtMeta):
    """Evaluations at the primitive m-th roots (zms order) of residues
    x int32 [..., L, phim] in [0, q) -> [..., L, phim]."""
    return drop_excluded(ct_fwd_n(T, pad_to_N(x, meta), meta), meta)


def ct_fwd_digits(T: dict, digits, meta: CtMeta, digit_bits: int):
    """ct_fwd of prime-independent digits int32 [..., phim] in
    [0, 2^digit_bits), digit_bits <= 24 -> [..., L, phim]."""
    return drop_excluded(ct_fwd_digits_n(T, pad_to_N(digits, meta), meta,
                                         digit_bits), meta)


def ct_inv(T: dict, evals, meta: CtMeta, t2i_key: str = 't2i'):
    """Inverse of ct_fwd: the canonical degree<phim representative mod
    Phi_m of evaluations [..., L, phim]."""
    return fold_mod_phim(ct_inv_n(T, insert_excluded(evals, meta), meta,
                                  t2i_key), T['q'], meta)
