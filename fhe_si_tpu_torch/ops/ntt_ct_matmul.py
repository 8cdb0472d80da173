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
ops/ntt_ct.py; only the stage products differ.  A stage sums n_in
products of a table entry below q_max and an input in [0, y_max] (a
residue, or a keyswitch digit below 2^24); ntt.needs_split decides from
that bound, n_in * y_max * (q_max - 1) < 2^53, whether one matmul is
exact or the table is split at 12 bits into two.  Every output is the
canonical residue in [0, q), so the route equals the plain versions of
ops/ntt_ct.py, the kernel and the JAX package bit for bit.  Two forms,
chosen by stage_operands from the split and that bound and seen by the
transforms in the tables it builds:

  - N x 1 with one exact N x N matmul (the rings m = p - 1; p = 8147:
    narrow lane, 4073 terms): stage 1 is a 1 x 1 table, one residue per
    prime, folded into the twiddle on the host (route_cuda.folded_table:
    tw * t2, twi * t2i, twi * t2i_crt).  A transform is three steps:
    route_cuda.enter (pad or insert, the folded twiddle, the float64
    operand), one torch.matmul of the t1 or t1i operand batched over the
    primes, route_cuda.leave (the reduction mod q, the folded inverse
    twiddle, drop or fold).  On a CUDA tensor enter and leave are the
    kernels of csrc/route.cu; on the CPU their plain versions.
  - every other split (m = 2^16, m = 4 * 2053, an N x 1 ring whose chain
    bound splits the N x N table): two stage products, each one
    ntt.modmatmul (a float64 torch.matmul per prime, lead dims folded
    into its columns, then mod q), the twiddle an int64 product mod q
    between them, the phim <-> N steps of ops/ntt_ct.py around them; at
    m = 2^16 (wide lane) the residue stage over 256 terms and the digit
    stage over 128 split.

CALLS counts the route's transforms per function, as cuda_build.LAUNCHES
counts the kernels', and PRODUCTS the stage products (GEMMs, each a
torch.matmul) each function runs: one a transform on the folded form,
two on the other.  Spans (profiling.annotate): fhe.route_fwd,
fhe.route_fwd_digits and fhe.route_inv around the three functions, named
apart from the kernel wrappers' fhe.ct_*; inside them, on the folded
form, route_cuda's fhe.route_enter and fhe.route_leave; on the other,
fhe.route_twiddle around each twiddle and fhe.route_reindex around each
phim <-> N step, beside the stage products' own fhe.modmatmul.
"""
from __future__ import annotations

import numpy as np
import torch

from ..profiling import annotate
from . import ntt, route_cuda
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
      t1 t1i     modmatmul operands of each table (ops/ntt.operands)

    On a split N x 1 whose N x N product is one exact matmul (the folded
    form, module header), then the folded twiddles
    (route_cuda.folded_table, [2, L, N] int32):

      tw_t2        tw * t2, the forward's and the digits'
      twi_t2i      twi * t2i, the raw inverse's
      twi_t2i_crt  twi * t2i_crt, the CRT-prescaled inverse's

    On any other split, then:

      t2 t2i t2i_crt   modmatmul operands of each table
      t2_digits  the operands of t2 stacked over the primes, [1, L*N2, N2],
                 for prime-independent digits below 2^24 (one product
                 for every prime); q_digits [1, L*N2] its row primes
      tw         [N1, L, N2] int64, the forward twiddle in stage 1's
                 output layout [c1, L, j2]
      twi        [N2, L, N1] int64, the inverse one in [j2, L, c1]
    """
    q = np.asarray(ct_np['q'], np.int64).reshape(-1)
    L, (N1, N2) = len(q), ct_np['tw'].shape[-2:]
    folded = N2 == 1 and not ntt.needs_split(N1, q_max)
    keys = ('t1', 't1i') if folded else ('t1', 't2', 't1i', 't2i', 't2i_crt')
    out = {k: ntt.device_operands((ct_np[k][l:l + 1] for l in range(L)), L,
                                  q_max, device)
           for k in keys if k in ct_np}
    out['q'] = torch.as_tensor(q.astype(np.int32)[:, None], device=device)
    if folded:
        out['tw_t2'] = torch.as_tensor(route_cuda.folded_table(
            ct_np['tw'][..., 0], ct_np['t2'][:, 0, 0], q), device=device)
        for k in ('t2i', 't2i_crt'):
            if k in ct_np:
                out['twi_' + k] = torch.as_tensor(route_cuda.folded_table(
                    ct_np['twi'][..., 0], ct_np[k][:, 0, 0], q),
                    device=device)
        return out
    out['t2_digits'] = tuple(
        t.to(device) for t in ntt.operands(
            np.asarray(ct_np['t2']).reshape(1, L * N2, N2), q_max, DIGIT_MAX))
    out['q_digits'] = torch.as_tensor(np.repeat(q, N2).astype(np.int32)[None],
                                      device=device)
    out['tw'] = torch.as_tensor(np.ascontiguousarray(np.transpose(
        ct_np['tw'], (1, 0, 2))).astype(np.int64), device=device)
    out['twi'] = torch.as_tensor(np.ascontiguousarray(np.transpose(
        ct_np['twi'], (2, 0, 1))).astype(np.int64), device=device)
    return out


def _folded(T: dict, x, meta: CtMeta, mode: str, tab):
    """A transform of the folded form (module header): route_cuda.enter in
    `mode` ("fwd", "fwd_digits", "inv"), one GEMM of t1 (t1i for "inv")
    batched over the primes, route_cuda.leave; tab the folded twiddle,
    the forward's on entry, the inverse's on leaving.  x [..., L, phim],
    or [..., phim] digits -> [..., L, phim]."""
    inv = mode == "inv"
    keep = 1 if mode == "fwd_digits" else 2
    lead = x.shape[:-keep]
    q = T['q']
    y = route_cuda.enter(x.reshape((-1,) + x.shape[-keep:]),
                         None if inv else tab, q, meta, mode)  # [R, L, N]
    PRODUCTS["ct_" + mode] += 1
    z = torch.matmul(T['t1i' if inv else 't1'][0],
                     y.permute(1, 2, 0))                     # [L, N, R]
    return route_cuda.leave(z, tab if inv else None, q, meta,
                            "inv" if inv else "fwd").reshape(
        lead + (q.shape[0], meta.phim))


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
        if 'tw_t2' in T:
            return _folded(T, x, meta, "fwd", T['tw_t2'])
        return _reindex(drop_excluded, ct_fwd_n(
            T, _reindex(pad_to_N, x, meta), meta), meta)


def ct_fwd_digits(T: dict, digits, meta: CtMeta, digit_bits: int):
    """ct_fwd of prime-independent digits int32 [..., phim] in
    [0, 2^digit_bits), digit_bits <= 24 -> [..., L, phim]."""
    if digit_bits > MAX_DIGIT_BITS:
        raise NotImplementedError(f"digit radix above 2^{MAX_DIGIT_BITS}")
    with annotate("fhe.route_fwd_digits"):
        CALLS["ct_fwd_digits"] += 1
        if 'tw_t2' in T:
            return _folded(T, digits, meta, "fwd_digits", T['tw_t2'])
        return _reindex(drop_excluded, ct_fwd_digits_n(
            T, _reindex(pad_to_N, digits, meta), meta), meta)


def ct_inv(T: dict, evals, meta: CtMeta, t2i_key: str = 't2i'):
    """Inverse of ct_fwd: the canonical degree<phim representative mod
    Phi_m of evaluations [..., L, phim]; t2i_key='t2i_crt' folds in the
    CRT premultiplier."""
    with annotate("fhe.route_inv"):
        CALLS["ct_inv"] += 1
        if 'tw_t2' in T:
            return _folded(T, evals, meta, "inv", T['twi_' + t2i_key])
        return _reindex(fold_mod_phim, ct_inv_n(
            T, _reindex(insert_excluded, evals, meta), meta, t2i_key),
            T['q'], meta)
