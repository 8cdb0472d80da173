"""Conversions between limb coefficients and per-prime residues.

Counterpart of fhe_si_tpu/ops/crt.py, both residue lanes.  from_poly
reduces the big coefficients mod each prime with 4-bit chunk dot
products against 2^(4c) mod q_l tables (Cmodulus::FFT's input
reduction, CModulus.cpp:89-107); to_poly is the single-pass
redundant-modulus CRT reconstruction of DoubleCRT::toPoly
(DoubleCRT.cpp:349-398); residues_to_limbs is the Garner scan it
replaced, kept as its cross-check.  These are the plain versions:
DeviceContext and the sharded pipelines reach the lift and the
single-pass reconstruction through ops/crt_cuda.py, which runs them for
CPU tensors and the kernels of csrc/crt.cu for CUDA tensors.

PyTorch has no integer matmul on CUDA, so the chunk dot of
limbs_to_residues runs as one float64 matmul on both lanes, where the
JAX package keeps int32 sums (one dot on the narrow lane, two dots of
12-bit table planes on the wide one).  It is exact: every partial sum is
a nonnegative integer below 15 * q * 4n.  Narrow lane (q < 2^20): below
2^31 for n <= 34, so the sum and its Barrett stay in int32 as in the JAX
package.  Wide lane (q < 2^23): below 2^53 for any n < 2^24; the sum is
taken to int64 and reduced with `%`, the canonical residue the JAX
Barrett-Horner also returns.

The reconstruction keeps the JAX package's int32 arithmetic on both
lanes; `wide` selects the lane of its mod_mul (binv, Bmodr and P^-1 mod
m_r products), whose modulus may be a 23-bit prime.  Its limb
accumulation stays int32-exact there: c >> 10 < 2^13 against 16-bit
limbs of B << 10 stays below 2^29, and the m_r term sum below
L * 2^23 < 2^29 for L <= 64.
"""
from __future__ import annotations

import torch

from . import limbs as lb
from .modular import barrett, mod_mul, mod_sub

CHUNK = 4
CMASK = (1 << CHUNK) - 1


def _chunks(poly):
    """[..., x, n] limbs -> [..., x, 4n] 4-bit chunks, chunk c of limb k
    at index 4k + c (the row order of the chunk tables)."""
    n = poly.shape[-1]
    chunks = torch.stack([(poly >> (CHUNK * i)) & CMASK for i in range(4)],
                         dim=-1)
    return chunks.reshape(*poly.shape[:-1], 4 * n)


def limbs_to_residues(poly, chunk_tbl, wrap, q, qinv_f, wide: bool = False):
    """[..., phim, n] limbs -> [..., L, phim] residues.

    chunk_tbl: int32 [>=4n, L] with tbl[c, l] = 2^(4c) mod q_l
    wrap:      int32 [L, 1]   2^(16n) mod q_l for THIS n (sign correction)
    """
    n = poly.shape[-1]
    bound = (15 * 4 * n) << (23 if wide else 20)
    if chunk_tbl.shape[0] < 4 * n or bound >= 1 << (53 if wide else 31):
        raise ValueError("limb width does not fit the chunk table")
    chunks = _chunks(poly)
    sign = lb.is_negative(poly)[..., None, :]  # [..., 1, phim]
    # exact float64 dot (header bounds)
    raw = torch.matmul(chunks.to(torch.float64),
                       chunk_tbl[:4 * n].to(torch.float64))
    raw = raw.transpose(-1, -2)                     # [..., L, phim]
    if wide:
        return ((raw.to(torch.int64) - sign * wrap) % q).to(torch.int32)
    return barrett(raw.to(torch.int32) - sign * wrap, q, qinv_f)


def limbs_to_mod_small(poly, p_chunk_tbl, p_wrap, p, pinv_f):
    """[..., phim, n] limbs -> [..., phim] values mod small p (decrypt
    tail).  p_wrap must be 2^(16n) mod p for THIS input width n; the
    int32 sum stays below 15 * 2^20 * 4n < 2^31 for p < 2^20."""
    n = poly.shape[-1]
    if p_chunk_tbl.shape[0] < 4 * n:
        raise ValueError("chunk table narrower than input")
    raw = torch.sum(_chunks(poly) * p_chunk_tbl[:4 * n], dim=-1,
                    dtype=torch.int32)
    raw = raw - lb.is_negative(poly) * p_wrap
    return barrett(raw, p, pinv_f)


def crt_partials(res, t, q, qinv_f, prescaled: bool = False,
                 wide: bool = False):
    """Per-prime half of the single-pass CRT reconstruction (see
    fhe_si_tpu/ops/crt.py crt_partials for the derivation).

    res: [..., Lrows, phim] residue rows INCLUDING the redundant row.
    Returns (acc [..., phim, n] partial limbs, sig_raw [..., phim],
    er [..., phim])."""
    mr, mrinv = t['mr'], t['mrinv_f']
    i32 = torch.int32
    if prescaled:
        c = res  # acc/sig terms on the redundant row are zeroed by B/Bmodr
    else:
        c = mod_mul(res, t['binv'][:, None], q, qinv_f, wide)  # 0 on redundant

    # limb accumulation  S = sum_l c_l * B_l   (10-bit digit split)
    cl = (c & 1023)[..., None]
    ch = (c >> 10)[..., None]
    p0 = cl * t['B'][:, None, :]                 # < 2^26
    p1 = ch * t['Bh'][:, None, :]
    acc = (torch.sum(p0 & lb.LIMB_MASK, dim=-3, dtype=i32)
           + torch.sum(p1 & lb.LIMB_MASK, dim=-3, dtype=i32))
    hi = (torch.sum(p0 >> lb.LIMB_BITS, dim=-3, dtype=i32)
          + torch.sum(p1 >> lb.LIMB_BITS, dim=-3, dtype=i32))
    acc = acc + lb._shift_up(hi)

    term = mod_mul(c, t['Bmodr'][:, None], mr, mrinv, wide)
    sig_raw = torch.sum(term, dim=-2, dtype=i32)       # < Lrows * 2^23
    er = torch.sum(t['er_mask'][:, None] * res, dim=-2, dtype=i32)
    return acc, sig_raw, er


def crt_finish(acc, sig_raw, er, t, n_limbs: int, wide: bool = False):
    """Exact wrap count w = ((S mod m_r) - E_r) * P^{-1} mod m_r, subtract
    w*P in the limb domain, normalize."""
    mr, mrinv = t['mr'], t['mrinv_f']
    sig = barrett(sig_raw, mr, mrinv)
    diff = mod_sub(sig, er, mr)
    w = mod_mul(diff, t['Pinv_r'], mr, mrinv, wide)

    wl = (w & 1023)[..., None]
    wh = (w >> 10)[..., None]
    sub = wl * t['P_limbs'] + wh * t['P_limbs_sh10']
    acc = acc - (sub & lb.LIMB_MASK)
    acc = acc - lb._shift_up(sub >> lb.LIMB_BITS)
    out = lb.normalize(acc)
    if out.shape[-1] != n_limbs:
        raise AssertionError("table width mismatch")
    return out


def residues_to_limbs_fast(res, t, q, qinv_f, n_limbs: int | None = None,
                           prescaled: bool = False, wide: bool = False):
    """Single-pass CRT reconstruction via the redundant modulus: the
    centered signed value as limbs at the basis width t['B'].shape[-1].
    res: [..., L, phim] with the LAST row tracking E mod m_r."""
    acc, sig_raw, er = crt_partials(res, t, q, qinv_f, prescaled, wide)
    return crt_finish(acc, sig_raw, er, t,
                      n_limbs if n_limbs is not None else t['B'].shape[-1],
                      wide)


def residues_to_limbs(res, tables, q, qinv_f, n_limbs: int,
                      wide: bool = False):
    """Garner reconstruction: [..., L, phim] residues -> [..., phim, n]
    limbs of the centered representative in (-P/2, P/2).  Counterpart of
    fhe_si_tpu/ops/crt.py residues_to_limbs (the scheme paths take the
    single-pass residues_to_limbs_fast; the two agree within its budget).

    tables: FheContext.garner_tables on the device (DeviceContext.garner):
      invq [L, L], W / Wh [L, n] (prefix products, plain and 2^10-shifted),
      P_limbs [n], halfP_digits [L].
    """
    L = res.shape[-2]
    invq, W, Wh = tables['invq'], tables['W'], tables['Wh']
    half_digits = tables['halfP_digits']

    # mixed-radix digits: digit j in [0, q_j); after step j the rows past j
    # hold the partial remainders
    t = res
    digits = []
    for j in range(L):
        a_j = t[..., j, :]
        digits.append(a_j)
        if j + 1 < L:
            qr, qir = q[j + 1:], qinv_f[j + 1:]
            diff = mod_sub(t[..., j + 1:, :], a_j[..., None, :] % qr, qr)
            t = torch.cat([t[..., :j + 1, :],
                           mod_mul(diff, invq[j, j + 1:, None], qr, qir,
                                   wide)], dim=-2)
    D = torch.stack(digits, dim=-2)                  # [..., L, phim]

    # lexicographic compare against floor(P/2), most significant digit last
    gt = torch.zeros(D.shape[:-2] + D.shape[-1:], dtype=torch.int32,
                     device=D.device)
    for j in range(L):
        dj, hj = D[..., j, :], half_digits[j]
        gt = torch.where(dj > hj, 1, torch.where(dj < hj, 0, gt))

    # limb accumulation: sum_j digit_j * W_j, digits split at 10 bits
    p0 = (D & 1023)[..., None] * W[:, None, :]      # < 2^26
    p1 = (D >> 10)[..., None] * Wh[:, None, :]
    i32 = torch.int32
    acc = (torch.sum(p0 & lb.LIMB_MASK, dim=-3, dtype=i32)
           + torch.sum(p1 & lb.LIMB_MASK, dim=-3, dtype=i32))
    hi = (torch.sum(p0 >> lb.LIMB_BITS, dim=-3, dtype=i32)
          + torch.sum(p1 >> lb.LIMB_BITS, dim=-3, dtype=i32))
    acc = acc + lb._shift_up(hi) - gt[..., None] * tables['P_limbs']
    out = lb.normalize(acc)
    if out.shape[-1] != n_limbs:
        raise AssertionError("table width mismatch")
    return out
