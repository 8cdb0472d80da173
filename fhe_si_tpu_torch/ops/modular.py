"""Modular arithmetic on int32 residue tensors, both residue lanes.

Counterpart of fhe_si_tpu/ops/modular.py.  Every output is the canonical
residue in [0, q), so any exact method gives the JAX package's tensors.

On the card, the products of the main path no longer run here: the
tensor product and the keyswitch dot of mul+relin run on the kernels of
csrc/modular.cu (ops/modular_cuda.py: exact 64-bit products, one
reduction per output).  These functions remain their plain versions
(modular_cuda.tensor_product_plain and keyswitch_dot_plain are made of
them), the CPU path, and the residue arithmetic of the rest of the port
on either device: keygen, encrypt, decrypt, the constant and scalar
multiplies, signed_group_sum_tensored, DoubleCrt.

Narrow lane (q < 2^20): the JAX package's arithmetic as it is.  Every
product stays below 2^31 and quotients are estimated in float32
("f32 Barrett"):

    quo = round(f32(t) * f32(1/q))       |error| <= 1/2 + (t/q) * 2^-23 < 1
    r   = t - quo*q   in (-q, 2q)  ->  two conditional corrections

torch.round rounds half to even like jnp.rint, and int32 products wrap
mod 2^32 on CPU and CUDA alike, so the intermediate `t - quo*q` is exact
whenever the true value is small.  mod_dot's int32 partial sums take at
most 512 terms.

Wide lane (q < 2^23): where the JAX package runs a 6-bit Horner
(mod_mul) and 12-bit splits (mod_dot) to stay inside int32, the port
computes in int64: a product is below 2^46 and a dot of K terms below
K * 2^46, exact for K < 2^17 (context.py caps the wide keyswitch dot at
64 terms, as the JAX package's int32 splits need).  `%` on int64 with a
positive divisor returns the canonical residue on CPU and CUDA.

torch.sum of an int32 tensor returns int64 where jnp.sum keeps int32; the
int32 sums below pass dtype=torch.int32 so later shifts and masks see
the same type as in the JAX package.
"""
from __future__ import annotations

import torch

D = 10           # split point for narrow-lane modmul
DMASK = (1 << D) - 1
WIDE_DOT_MAX_TERMS = 1 << 17     # K * (2^23 - 1)^2 < 2^63


def barrett(t, q, qinv_f):
    """t mod q for int32 t with |t| < 2^31 (t may be any sign).

    q: int32 (broadcastable), qinv_f: float32 1/q (broadcastable).
    """
    quo = torch.round(t.to(torch.float32) * qinv_f).to(torch.int32)
    r = t - quo * q  # int32 wraparound is exact mod 2^32; true r is small
    r = torch.where(r < 0, r + q, r)
    return torch.where(r >= q, r - q, r)


def mod_mul(a, b, q, qinv_f, wide: bool = False):
    """(a*b) mod q for residues a, b in [0, q).

    narrow (q < 2^20): split at 10 bits,
        a*b = (a1*b1)*2^20 + (a1*b0 + a0*b1)*2^10 + a0*b0;
    a1*b1 < 2^20 needs no reduction; two Barrett steps finish the Horner
    combine with every intermediate < 2^31.

    wide (q < 2^23): the int64 product (< 2^46) mod q."""
    if wide:
        return (a.to(torch.int64) * b % q).to(torch.int32)
    a1, a0 = a >> D, a & DMASK
    b1, b0 = b >> D, b & DMASK
    h = a1 * b1                              # < 2^20
    t = (h << D) + a1 * b0 + a0 * b1         # < 2^30 + 2^21
    tm = barrett(t, q, qinv_f)
    u = (tm << D) + a0 * b0                  # < 2^30 + 2^20
    return barrett(u, q, qinv_f)


def mod_dot(a, b, q, qinv_f, axis: int, wide: bool = False):
    """Exact (sum_k a_k * b_k) mod q, reduced once.

    narrow: 10-bit splits, the partial-product sums accumulate unreduced
    (terms < 2^20, K <= 512), then a Barrett-Horner.
    wide: int64 products summed unreduced (K * 2^46 < 2^63), one
    remainder."""
    K = a.shape[axis] if a.shape[axis] != 1 else b.shape[axis]
    if wide:
        if K >= WIDE_DOT_MAX_TERMS:
            raise ValueError("mod_dot: too many terms for an int64 sum")
        prod = a.to(torch.int64) * b
        return (torch.sum(prod, dim=axis) % q).to(torch.int32)
    if K > 512:
        raise ValueError("mod_dot: too many terms for unreduced accumulation")
    a_lo, a_hi = a & DMASK, a >> D
    b_lo, b_hi = b & DMASK, b >> D
    i32 = torch.int32
    ll = torch.sum(a_lo * b_lo, dim=axis, dtype=i32)         # < K * 2^20
    lh = (torch.sum(a_lo * b_hi, dim=axis, dtype=i32)
          + torch.sum(a_hi * b_lo, dim=axis, dtype=i32))     # < 2K * 2^20
    hh = torch.sum(a_hi * b_hi, dim=axis, dtype=i32)         # < K * 2^20
    r = barrett(hh, q, qinv_f)
    r = barrett((r << D) + lh, q, qinv_f)         # < 2^30 + 2K*2^20
    return barrett((r << D) + ll, q, qinv_f)      # < 2^30 + K*2^20


def mod_add(a, b, q):
    s = a + b
    return torch.where(s >= q, s - q, s)


def mod_sub(a, b, q):
    s = a - b
    return torch.where(s < 0, s + q, s)


def mod_neg(a, q):
    return torch.where(a == 0, a, q - a)
