"""The Cooley-Tukey transforms as exact float64 stage products: the route
of every split that the tensor-core kernel cannot take.

Counterpart of the XLA stage products of fhe_si_tpu/ops/ntt_ct.py
(ct_fwd, ct_fwd_digits, ct_inv: each stage one ntt.modmatmul), which the
JAX package runs wherever its Pallas kernels do not apply.  On the port
ct_mma_kernel (ops/ntt_ct_cuda.py) takes every split whose sides are
both at least 2 and whose layout fits an H100 block's shared memory
(ntt_ct_cuda.kernel_takes); DeviceContext sends the other splits here,
chosen from the split before any launch (DeviceContext.ct_route):

  - the reference's rings m = p - 1 for a safe prime p >= 4127: N = m/2
    is prime and splits as N x 1, so stage 2 is one dense N x N product
    per prime (p = 8147: 4073 x 4073);
  - m = 2^16 (256 x 128), whose byte-plane layout needs 479,232 bytes of
    shared memory;
  - m = 2^a * q with a prime q too large for the kernel (4 * 2053).

The tables, the stage order and the phim <-> N steps (pad_to_N,
drop_excluded, insert_excluded, fold_mod_phim) are those of
ops/ntt_ct.py; only the stage products differ.  Each stage is one
ntt.modmatmul (a float64 torch.matmul per prime, lead dims folded into
its columns, then mod q) on operands that stage_operands makes once from
the integer tables, the twiddle an int64 product mod q.  A stage sums
n_in products of a table entry below q_max and an input in [0, y_max]
(a residue, or a keyswitch digit below 2^24); ntt.needs_split decides
from that bound, n_in * y_max * (q_max - 1) < 2^53, whether one matmul
is exact or the table is split at 12 bits into two.  So at p = 8147
(narrow lane, n_in = 4073) every stage is one matmul, while at m = 2^16
(wide lane) the residue stage over 256 terms and the digit stage over
128 split.  Every output is the canonical residue in [0, q), so the route
equals the plain versions of ops/ntt_ct.py, the kernel and the JAX
package bit for bit.

The route is plain torch, not a kernel: it runs on the device of the
tensors it is handed, the CPU included.  CALLS counts its transforms per
function, as cuda_build.LAUNCHES counts the kernel's, and PRODUCTS the
stage products (ntt.modmatmul calls) each function runs, two a
transform.  Spans (profiling.annotate): fhe.route_fwd,
fhe.route_fwd_digits and fhe.route_inv around the three functions, named
apart from the kernel wrappers' fhe.ct_*; inside them fhe.route_twiddle
around each twiddle and fhe.route_reindex around each phim <-> N step,
beside the stage products' own fhe.modmatmul.
"""
from __future__ import annotations

import numpy as np
import torch

from ..profiling import annotate
from . import ntt
from .ntt_ct import (MAX_DIGIT_BITS, CtMeta, drop_excluded, fold_mod_phim,
                     insert_excluded, pad_to_N)

CALLS = {"ct_fwd": 0, "ct_fwd_digits": 0, "ct_inv": 0}
PRODUCTS = dict.fromkeys(CALLS, 0)
DIGIT_MAX = (1 << MAX_DIGIT_BITS) - 1    # the largest keyswitch digit


def reset_calls():
    for k in CALLS:
        CALLS[k] = 0


def reset_products():
    for k in PRODUCTS:
        PRODUCTS[k] = 0


def stage_operands(ct_np: dict, q_max: int, device) -> dict:
    """The route's operands on `device` from the numpy tables of
    ntt_ct.ct_tables (with t2i_crt where present), for primes up to
    q_max:

      q          [L, 1] int32 primes
      t1 t2 t1i t2i t2i_crt   modmatmul operands of each table
      t2_digits  the operands of t2 stacked over the primes, [1, L*N2, N2],
                 for prime-independent digits below 2^24 (one product
                 for every prime); q_digits [1, L*N2] its row primes
      tw         [N1, L, N2] int64, the forward twiddle in stage 1's
                 output layout [c1, L, j2]
      twi        [N2, L, N1] int64, the inverse one in [j2, L, c1]
    """
    q = np.asarray(ct_np['q'], np.int64).reshape(-1)
    L, N2 = len(q), ct_np['t2'].shape[-1]
    out = {k: ntt.device_operands((ct_np[k][l:l + 1] for l in range(L)), L,
                                  q_max, device)
           for k in ('t1', 't2', 't1i', 't2i', 't2i_crt') if k in ct_np}
    out['t2_digits'] = tuple(
        t.to(device) for t in ntt.operands(
            np.asarray(ct_np['t2']).reshape(1, L * N2, N2), q_max, DIGIT_MAX))
    out['q'] = torch.as_tensor(q.astype(np.int32)[:, None], device=device)
    out['q_digits'] = torch.as_tensor(np.repeat(q, N2).astype(np.int32)[None],
                                      device=device)
    out['tw'] = torch.as_tensor(np.ascontiguousarray(np.transpose(
        ct_np['tw'], (1, 0, 2))).astype(np.int64), device=device)
    out['twi'] = torch.as_tensor(np.ascontiguousarray(np.transpose(
        ct_np['twi'], (2, 0, 1))).astype(np.int64), device=device)
    return out


def _product(name: str, tab, x, q):
    """One stage product (ntt.modmatmul), counted under PRODUCTS[name]."""
    PRODUCTS[name] += 1
    return ntt.modmatmul(tab, x, q)


def _twiddle(y, tw, q):
    """y int32 [..., a, L, b] times tw [a, L, b] mod q [L, 1]."""
    with annotate("fhe.route_twiddle"):
        return (y.to(torch.int64) * tw % q).to(torch.int32)


def _reindex(step, *args):
    """One phim <-> N step of ops/ntt_ct.py (pad_to_N, drop_excluded,
    insert_excluded, fold_mod_phim) under the route's span."""
    with annotate("fhe.route_reindex"):
        return step(*args)


def _fwd_tail(T, y, meta: CtMeta, name: str):
    """Twiddle and stage 2 of the forward transform: y [..., c1, L, j2]
    -> [..., L, N] in u = j2 + N2*j1 order."""
    y = _twiddle(y, T['tw'], T['q'])
    X = _product(name, T['t1'], y.transpose(-1, -3), T['q'])  # [.., j2, L, j1]
    return X.movedim(-3, -1).reshape(X.shape[:-3] + (X.shape[-2], meta.N))


def ct_fwd_n(T: dict, x, meta: CtMeta):
    """The N-point forward transform of residues int32 [..., L, N] in
    [0, q): evaluations in u order."""
    *lead, L, _ = x.shape
    xs = x.reshape(*lead, L, meta.N2, meta.N1).movedim(-1, -3)
    return _fwd_tail(T, _product("ct_fwd", T['t2'], xs,       # [.., c1, L, j2]
                                 T['q']), meta, "ct_fwd")


def ct_fwd_digits_n(T: dict, digits, meta: CtMeta):
    """ct_fwd_n of prime-independent digits int32 [..., N] below 2^24 ->
    [..., L, N]: stage 1 is one product of the stacked t2 of every
    prime, and the first reduction mod q follows it."""
    *lead, _ = digits.shape
    L = T['q'].shape[0]
    d = digits.reshape(*lead, 1, meta.N2, meta.N1).movedim(-1, -3)
    y = _product("ct_fwd_digits", T['t2_digits'], d,   # [.., c1, 1, L*N2]
                 T['q_digits'])
    return _fwd_tail(T, y.reshape(*lead, meta.N1, L, meta.N2), meta,
                     "ct_fwd_digits")


def ct_inv_n(T: dict, evals, meta: CtMeta, t2i_key: str = 't2i'):
    """Inverse of ct_fwd_n: degree<N coefficients in c = c1 + N1*c2
    order."""
    *lead, L, N = evals.shape
    e = evals.reshape(*lead, L, meta.N1, meta.N2).movedim(-1, -3)
    z = _twiddle(_product("ct_inv", T['t1i'], e, T['q']),     # [.., j2, L, c1]
                 T['twi'], T['q'])
    x = _product("ct_inv", T[t2i_key], z.transpose(-1, -3),   # [.., c1, L, c2]
                 T['q'])
    return x.movedim(-3, -1).reshape(*lead, L, N)


def ct_fwd(T: dict, x, meta: CtMeta):
    """Evaluations at the primitive m-th roots (zms order) of residues
    x int32 [..., L, phim] in [0, q) -> [..., L, phim]."""
    with annotate("fhe.route_fwd"):
        CALLS["ct_fwd"] += 1
        return _reindex(drop_excluded, ct_fwd_n(
            T, _reindex(pad_to_N, x, meta), meta), meta)


def ct_fwd_digits(T: dict, digits, meta: CtMeta, digit_bits: int):
    """ct_fwd of prime-independent digits int32 [..., phim] in
    [0, 2^digit_bits), digit_bits <= 24 -> [..., L, phim]."""
    if digit_bits > MAX_DIGIT_BITS:
        raise NotImplementedError(f"digit radix above 2^{MAX_DIGIT_BITS}")
    with annotate("fhe.route_fwd_digits"):
        CALLS["ct_fwd_digits"] += 1
        return _reindex(drop_excluded, ct_fwd_digits_n(
            T, _reindex(pad_to_N, digits, meta), meta), meta)


def ct_inv(T: dict, evals, meta: CtMeta, t2i_key: str = 't2i'):
    """Inverse of ct_fwd: the canonical degree<phim representative mod
    Phi_m of evaluations [..., L, phim]; t2i_key='t2i_crt' folds in the
    CRT premultiplier."""
    with annotate("fhe.route_inv"):
        CALLS["ct_inv"] += 1
        return _reindex(fold_mod_phim, ct_inv_n(
            T, _reindex(insert_excluded, evals, meta), meta, t2i_key),
            T['q'], meta)
