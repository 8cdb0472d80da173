"""The limb/CRT kernels of fhe_si_tpu_torch/csrc/crt.cu on the CPU.

Two halves, both exact (integers, no tolerance):
  - every mode of ops/crt_cuda.py (crt_partials, crt_finish and
    crt_to_limbs, with and without the ScaleDown and signed-reduction
    tails, and limbs_to_residues) takes its plain version on a CPU
    tensor; each is held equal to the JAX package's functions
    (fhe_si_tpu/ops/crt.py, the limb tails of fhe_si_tpu/device.py
    _scale_down and _keyswitch_digits) on numpy-seeded inputs, at
    m = 32 and 256 on both residue lanes (prime_bits = 23 forces the
    wide one) and on the full, keyswitch and linear bases;
  - a numpy model of each kernel's per-coefficient loop, at the kernel's
    own integer widths (the split form's int32 limb sums and 32-bit
    Shoup products; the one-pass kernel's 64-bit column sums over 32-bit
    words, its signed 64-bit subtraction and carry pass; the lift's
    64-bit sums over pairs of limbs) and reading the kernel's own table
    layout (crt_cuda.kernel_table), held equal to the plain versions on
    worst-case inputs: every residue q - 1, every limb 0xFFFF, negative
    values, and synthetic bases of up to 64 rows and 48 limbs (the
    kernels' largest), where it also asserts the bounds the crt.cu
    header states;
  - the two-source lift (limbs_to_residues with `second`, the operands
    of DeviceContext._tensor_mul read without joining them) against the
    lift of the joined operands, in the port and in the JAX package.
The kernels themselves run only on a card (tests/test_torch_cuda.py,
chip_smoke.py phase 3).
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fhe_si_tpu.context import FheContext as RefContext, int_to_limbs
from fhe_si_tpu.device import device_context
from fhe_si_tpu.ops import crt as jcrt, limbs as jlb
from fhe_si_tpu_torch import DeviceContext, FheContext
from fhe_si_tpu_torch.hostmath import numbth
from fhe_si_tpu_torch.ops import crt, crt_cuda, cuda_build
from fhe_si_tpu_torch.ops.crt_cuda import HEADER, PASS_ROW, ROW_WORDS, Tail

torch.set_num_threads(1)

CONFIGS = [pytest.param((32, 97, None), id="m32"),
           pytest.param((256, 257, None), id="m256"),
           pytest.param((32, 97, 23), id="m32-wide"),
           pytest.param((256, 257, 23), id="m256-wide")]
BASES = ["full", "ksw", "lin"]
MODES = [("partials", None), ("finish", None), ("finish", "round_down"),
         ("finish", "reduce_signed"), ("to_limbs", None),
         ("to_limbs", "round_down"), ("to_limbs", "reduce_signed"),
         ("lift", None)]
TAILS = [None, "round_down", "reduce_signed"]
M = 0xFFFF
M32 = (1 << 32) - 1
U64 = np.uint64


@functools.cache
def _devices(m, p, prime_bits):
    kw = dict(m=m, log_q=80, p=p, generator=3, prime_bits=prime_bits)
    ref, ctx = RefContext(**kw), FheContext(**kw)
    assert ref.wide == ctx.wide == (prime_bits == 23)
    return device_context(ref), DeviceContext(ctx, "cpu")


def _tables(cfg, basis):
    """(port DeviceContext, its tables of `basis`, the JAX package's)."""
    jd, td = _devices(*cfg)
    T, JT = {"full": (td.full, jd._full_as_subset(jd.C)),
             "ksw": (td.ksw, jd._ksw_tables(jd.C)),
             "lin": (td.lin, jd._lin_tables(jd.C))}[basis]
    return td, T, JT


def _eq(want, got):
    want, got = np.asarray(want), got.numpy()
    assert want.dtype == got.dtype and want.shape == got.shape
    assert np.array_equal(want, got)


def _jax_tail(x, kind, log_q, width):
    """The JAX package's limb tails: fhe_si_tpu/device.py _scale_down's
    rounding (round_down) and _reduce_signed, at `width` limbs."""
    q_limbs = jnp.asarray(int_to_limbs(1 << log_q, x.shape[-1]))
    if kind == "round_down":
        y = jlb.shift_left(x, 1)
        y = jlb.add(y, jnp.broadcast_to(q_limbs, y.shape))
        x = jlb.arith_shift_right(y, log_q + 1)
    return jlb.reduce_mod_q(x, log_q, False, q_limbs, out_width=width)


@pytest.mark.parametrize("mode,tail", MODES,
                         ids=[f"{m}-{t}" if t else m for m, t in MODES])
@pytest.mark.parametrize("basis", BASES)
@pytest.mark.parametrize("cfg", CONFIGS)
def test_modes_equal_jax(cfg, basis, mode, tail):
    td, T, JT = _tables(cfg, basis)
    primes, wide = T["primes_np"], td.wide
    rng = np.random.default_rng(11)
    if mode == "lift":
        for n in (td.n_ct, T["fast_crt"]["B"].shape[-1]):
            poly = rng.integers(0, 1 << 16, size=(2, 3, td.phim, n))
            poly[0, 0] = M                                  # the value -1
            poly = poly.astype(np.int32)
            wrap = td._wrap_const(primes, n)
            _eq(jcrt.limbs_to_residues(jnp.asarray(poly), JT["chunk_tbl"],
                                       jnp.asarray(wrap.numpy()), JT["q"],
                                       JT["qinv_f"], wide),
                crt_cuda.limbs_to_residues(torch.from_numpy(poly),
                                           T["chunk_tbl"], wrap, T["q"],
                                           T["qinv_f"], wide))
        return
    res = rng.integers(0, primes[:, None], size=(2, 3, len(primes), td.phim))
    res[0, 0] = primes[:, None] - 1
    res = res.astype(np.int32)
    want = jcrt.crt_partials(jnp.asarray(res), JT["fast_crt"], JT["q"],
                             JT["qinv_f"], prescaled=True, wide=wide)
    if mode == "partials":
        got = crt_cuda.crt_partials(torch.from_numpy(res), T["fast_crt"], wide)
        for w, g in zip(want, got):
            _eq(w, g)
        return
    n = T["fast_crt"]["B"].shape[-1]
    limbs = jcrt.crt_finish(*want, JT["fast_crt"], n, wide)
    _eq(limbs, crt_cuda.crt_to_limbs(torch.from_numpy(res), T["fast_crt"],
                                     wide))
    t = td.tail(tail) if tail else None
    if t:
        limbs = _jax_tail(limbs, tail, td.log_q, td.n_ct)
    if mode == "finish":
        got = crt_cuda.crt_finish(
            *(torch.from_numpy(np.array(w)) for w in want), T["fast_crt"],
            wide, t)
    else:
        got = crt_cuda.crt_to_limbs(torch.from_numpy(res), T["fast_crt"],
                                    wide, t)
    _eq(limbs, got)


@pytest.mark.parametrize("stage", ["scale_down", "keyswitch_digits"])
@pytest.mark.parametrize("cfg", CONFIGS)
def test_device_tails_equal_jax(cfg, stage):
    """DeviceContext._scale_down and _keyswitch_digits, which fuse their
    limb tails into crt_cuda.crt_to_limbs, against the JAX device's."""
    jd, td = _devices(*cfg)
    ctx = td.ctx
    rng = np.random.default_rng(12)
    if stage == "scale_down":
        ev = rng.integers(0, ctx.primes[:, None], size=(2, 3, td.L, td.phim))
        ev = ev.astype(np.int32)
        _eq(jd._scale_down(jd.C, jnp.asarray(ev)),
            td._scale_down(torch.from_numpy(ev)))
        return
    K = 2 * td.ndigits
    kq = td.ksw["primes_np"]
    mat = rng.integers(0, ctx.primes[:, None], size=(2, K, td.L, td.phim))
    digs = rng.integers(0, kq[:, None], size=(2, K, len(kq), td.phim))
    mat, digs = mat.astype(np.int32), digs.astype(np.int32)
    _eq(jd._keyswitch_digits(jd.C, jnp.asarray(mat), jnp.asarray(digs)),
        td._keyswitch_digits(torch.from_numpy(mat), torch.from_numpy(digs)))


# ------------------------------------------------------ the kernels' model
def _umulhi(a, b):
    """floor(a b / 2^32) of uint64 arrays holding 32-bit values."""
    a0, a1, b0, b1 = a & U64(M), a >> U64(16), b & U64(M), b >> U64(16)
    mid = a0 * b1 + a1 * b0 + ((a0 * b0) >> U64(16))
    return a1 * b1 + (mid >> U64(16))


def _shoup(a, w, wr, q):
    """crt.cu shoup: a w - umulhi(a, w') q in 32 bits, asserted in [0, 2q)."""
    a = np.asarray(a).astype(U64)
    w, wr, q = U64(w), U64(wr), U64(q)
    out = (a * w - _umulhi(a, wr) * q) & U64(M32)
    assert (out < U64(2) * q).all()
    return out.astype(np.int64)


def _csub(x, q):
    return np.where(x >= q, x - q, x)


def _normalize(v, n):
    v = v[:, :n].copy()
    carry = np.zeros(len(v), np.int64)
    for k in range(n):
        t = v[:, k] + carry
        v[:, k], carry = t & M, t >> 16
    return v


def _model_tail(v, n, tail):
    """crt.cu round_down / reduce_signed on canonical limbs v [C, n]."""
    log_q, nw = tail.log_q, tail.width
    nm = max(n, nw)
    x = np.zeros((len(v), nm), np.int64)
    x[:, :n] = v
    if tail.kind == "round_down":
        prev = np.zeros_like(x)
        prev[:, 1:] = x[:, :-1]
        x = ((x << 1) | (prev >> 15)) & M
        x[:, log_q >> 4] += 1 << (log_q & 15)
        x[:, :n] = _normalize(x, n)
        ls, bs = divmod(log_q + 1, 16)
        fill = np.where((x[:, n - 1] >> 15) & 1, M, 0)[:, None]
        b = 0
        while 1 << b < nm:                     # the barrel of limb shifts
            step = 1 << b
            if ls & step:
                y = np.repeat(fill, nm, axis=1)
                y[:, :max(n - step, 0)] = x[:, step:n]
                x = y
            b += 1
        nxt = np.repeat(fill, nm, axis=1)
        nxt[:, :n - 1] = x[:, 1:n]
        x = ((x >> bs) | (nxt << (16 - bs))) & M
    hi_limb, hi_bits = divmod(log_q, 16)
    m = np.zeros((len(v), nm), np.int64)
    m[:, :min(n, hi_limb)] = x[:, :min(n, hi_limb)]
    if hi_bits and hi_limb < n:
        m[:, hi_limb] = x[:, hi_limb] & ((1 << hi_bits) - 1)
    sign = (m[:, (log_q - 1) >> 4] >> ((log_q - 1) & 15)) & 1
    m[:, hi_limb] -= sign << hi_bits
    return _normalize(m, nw)


def model_crt(tab, mode, res=None, partials=None, tail=None):
    """crt_kernel<mode> of csrc/crt.cu for every coefficient at once,
    reading the table words: res [..., rows, phim] residues (partials and
    to_limbs) or the partials (acc [C, n], sig_raw [C], er [C]) in the
    kernel's coefficient order (finish).  Returns what it writes, with
    coefficients in rows: acc, sig_raw, er (partials) or limbs [C, width]."""
    w = tab.view(np.uint32).astype(np.int64)
    rows, n, mr, pinv, pinv_r = (int(v) for v in w[:5])
    rowc = w[HEADER:HEADER + ROW_WORDS * rows].reshape(rows, ROW_WORDS)
    o = HEADER + ROW_WORDS * rows
    B = w[o:o + rows * n].reshape(rows, n)
    Bh = w[o + rows * n:o + 2 * rows * n].reshape(rows, n)
    P = w[o + 2 * rows * n:o + 2 * rows * n + n]
    P10 = w[o + 2 * rows * n + n:crt_cuda.split_words(rows, n)]
    if mode == "finish":
        acc = np.zeros((len(partials[1]), n + 1), np.int64)
        acc[:, :n] = partials[0]
        sig, er = (np.asarray(p, np.int64) for p in partials[1:])
    else:
        c = np.moveaxis(res, -2, -1).reshape(-1, rows).astype(np.int64)
        acc = np.zeros((len(c), n + 1), np.int64)    # acc[:, n]: dropped carry
        sig = np.zeros(len(c), np.int64)
        er = np.zeros(len(c), np.int64)
        for l in range(rows):
            cl, ch = c[:, l] & 1023, c[:, l] >> 10
            p0, p1 = cl[:, None] * B[l], ch[:, None] * Bh[l]
            assert p0.max() < 1 << 26 and p1.max() < 1 << 29
            acc[:, :n] += (p0 & M) + (p1 & M)
            acc[:, 1:] += (p0 >> 16) + (p1 >> 16)
            sig += _csub(_shoup(c[:, l], rowc[l, 0], rowc[l, 1], mr), mr)
            er += rowc[l, 2] * c[:, l]
        # the int32 sums stay inside the crt.cu header's bounds
        assert acc.min() >= 0 and acc.max() < 1 << 29
        assert sig.max() < 1 << 29 and er.max() < 1 << 31
        if mode == "partials":
            return (acc[:, :n].astype(np.int32), sig.astype(np.int32),
                    er.astype(np.int32))
    s = sig % mr
    diff = s - er
    diff = np.where(diff < 0, diff + mr, diff)
    wc = _csub(_shoup(diff, pinv, pinv_r, mr), mr)
    sub = (wc & 1023)[:, None] * P + (wc >> 10)[:, None] * P10
    acc[:, :n] -= sub & M
    acc[:, 1:] -= sub >> 16
    assert np.abs(acc).max() < 1 << 30
    v = _normalize(acc, n)
    return (v if tail is None else _model_tail(v, n, tail)).astype(np.int32)


def model_lift(poly, chunk_tbl, q, wrap):
    """lift_kernel of csrc/crt.cu: limbs [..., phim, n] -> [..., L, phim]."""
    n = poly.shape[-1]
    x = (poly.reshape(-1, n).astype(np.int64) & M).astype(U64)
    sign = (poly.reshape(-1, n)[:, -1].astype(np.int64) >> 15) & 1
    T = chunk_tbl[0:4 * n:4].astype(U64)                    # [n, L]
    out = np.empty((len(x), len(q)), np.int64)
    for l, ql in enumerate(int(v) for v in q):
        qr, c32 = (1 << 32) // ql, (1 << 32) % ql
        acc = (x * T[:, l]).sum(axis=1)
        assert int(acc.max()) < n * (1 << 16) * (1 << 23)
        v = (_shoup(acc >> U64(32), c32, (c32 << 32) // ql, ql)
             + _shoup(acc & U64(M32), 1, qr, ql))
        assert v.max() < 4 * ql
        r = _csub(_csub(v, 2 * ql), ql) - sign * int(wrap[l])
        out[:, l] = np.where(r < 0, r + ql, r)
    lead = poly.shape[:-2] + (poly.shape[-2], len(q))
    return np.moveaxis(out.reshape(lead), -1, -2).astype(np.int32)


def _words(limbs):
    """16-bit limbs [..., n] -> 32-bit words [..., ceil(n/2)] (limbs 2j and
    2j + 1), uint64."""
    limbs = np.asarray(limbs, np.int64)
    n = limbs.shape[-1]
    x = np.zeros(limbs.shape[:-1] + (n + n % 2,), np.int64)
    x[..., :n] = limbs
    return (x[..., 0::2] | (x[..., 1::2] << 16)).astype(U64)


def _reduce64(x, q, r32, c32, c32_r):
    """crt.cu reduce64: x mod q by two Shoup products of its halves."""
    v = (_shoup(x >> U64(32), c32, c32_r, q)
         + _shoup(x & U64(M32), 1, r32, q))
    assert v.max() < 4 * q
    return _csub(_csub(v, 2 * q), q)


def model_pass(tab, res, tail=None):
    """crt_pass_kernel of csrc/crt.cu (the one-pass reconstruction) for
    every coefficient at once, reading the table's one-pass section:
    res [..., rows, phim] -> limbs [C, width].  Its integer widths: the
    exact 64-bit column sums over 32-bit words (sig, er and S's words),
    the signed 64-bit subtraction of w P, one carry pass into 32-bit
    words, and the tails on those words (sign_extend,
    round_down_words); each bound the crt.cu header states is
    asserted."""
    w = tab.view(np.uint32).astype(np.int64)
    rows, n, mr, pinv, pinv_r = (int(v) for v in w[:5])
    o = crt_cuda.pass_offset(rows, n)
    nw, c32, c32_r, r32 = (int(v) for v in w[o:o + 4])
    assert nw == (n + 1) // 2 and not w[o + 4:o + HEADER].any()
    body = w[o + HEADER:o + HEADER + PASS_ROW * (rows + 1)].reshape(
        rows + 1, PASS_ROW)
    assert not body[:, 2 + nw:].any() and not body[rows, :2].any()
    cols = body[:rows, :2 + nw].astype(U64)      # Bmodr, er_mask, B's words
    c = np.moveaxis(res, -2, -1).reshape(-1, rows).astype(U64)
    assert c.max() < 1 << 23 and cols.max() < 1 << 32
    acc = np.zeros((len(c), 2 + nw), U64)
    for l in range(rows):
        prod = c[:, l:l + 1] * cols[l]
        assert prod.max() < 1 << 55
        acc += prod
    assert acc[:, 2:].max() < 1 << 61
    assert acc[:, 0].max() < 1 << 52 and acc[:, 1].max() < 1 << 29
    s = _reduce64(acc[:, 0], mr, r32, c32, c32_r)
    diff = s - acc[:, 1].astype(np.int64)
    diff = np.where(diff < 0, diff + mr, diff)
    wc = _csub(_shoup(diff, pinv, pinv_r, mr), mr)
    assert wc.max() < mr < 1 << 23
    # E = S - w P: signed 64-bit columns, one carry pass into 32-bit
    # words (as many as the kernel's register bucket holds at least)
    t = acc[:, 2:].astype(np.int64) - wc[:, None] * body[rows, 2:2 + nw]
    assert t.min() > -(1 << 55) and t.max() < 1 << 61
    width = n if tail is None else tail.width
    nwk = max(nw, (width + 1) // 2)
    x = np.zeros((len(c), nwk), np.int64)
    carry = np.zeros(len(c), np.int64)
    for j in range(nwk):
        v = (t[:, j] if j < nw else 0) + carry
        x[:, j], carry = v & M32, v >> 32
        assert np.abs(carry).max() < 1 << 30
    if tail is not None and tail.kind == "round_down":
        x = _round_down_words(x, n, tail.log_q)
    if tail is not None:
        x = _sign_extend(x, tail.log_q - 1)
    limbs = np.stack([x[:, k >> 1] >> 16 if k & 1 else x[:, k >> 1] & M
                      for k in range(width)], axis=-1)
    return limbs.astype(np.int32)


def _sign_extend(x, bit):
    """crt.cu sign_extend: the words x [C, NW] sign-extended from `bit`."""
    x = x.copy()
    hw, hb = divmod(bit, 32)
    fill = np.where((x[:, hw] >> hb) & 1, M32, 0)
    keep = (2 << hb) - 1
    x[:, hw] = (x[:, hw] & keep) | (fill & (M32 ^ keep))
    x[:, hw + 1:] = fill[:, None]
    return x


def _round_down_words(x, n, log_q):
    """crt.cu round_down_words on the words x [C, NW] of X: Y = (2X +
    2^logQ) mod 2^16n sign-extended from bit 16n - 1, shifted right by
    logQ + 1 with Y's sign shifted in."""
    nwk = x.shape[1]
    y = (x << 1) & M32
    y[:, 1:] |= x[:, :-1] >> 31
    qw = log_q >> 5
    y[:, qw] += 1 << (log_q & 31)
    for k in range(qw, nwk - 1):                      # the carry up
        y[:, k + 1] += y[:, k] >> 32
        y[:, k] &= M32
    y[:, -1] &= M32
    y = _sign_extend(y, 16 * n - 1)
    fill = np.where(y[:, -1] >> 31, M32, 0)[:, None]
    ws, bs = divmod(log_q + 1, 32)
    y = np.concatenate([y, np.repeat(fill, nwk + 1, axis=1)], axis=1)
    y = y[:, ws:ws + nwk + 1]
    return ((y[:, :-1] | (y[:, 1:] << 32)) >> bs) & M32


def model_lift_words(poly, chunk_tbl, q, wrap):
    """lift_kernel of csrc/crt.cu: limbs [..., phim, n] -> [..., L, phim]
    through 64-bit sums over pairs of limbs (32-bit words) against the
    chunk table's rows 0, 8, 16, ... (2^(32j) mod q_l)."""
    n = poly.shape[-1]
    nw = (n + 1) // 2
    x = _words(poly.reshape(-1, n).astype(np.int64) & M)
    sign = (poly.reshape(-1, n)[:, -1].astype(np.int64) >> 15) & 1
    assert chunk_tbl.shape[0] >= 4 * n and 8 * (nw - 1) < 4 * n
    T = chunk_tbl[0:8 * nw:8].astype(U64)                  # [nw, L]
    out = np.empty((len(x), len(q)), np.int64)
    for l, ql in enumerate(int(v) for v in q):
        prod = x * T[:, l]
        assert prod.max() < 1 << 55
        acc = prod.sum(axis=1)
        assert int(acc.max()) < 1 << 60
        c32 = (1 << 32) % ql
        r = _reduce64(acc, ql, (1 << 32) // ql, c32, (c32 << 32) // ql) \
            - sign * int(wrap[l])
        out[:, l] = np.where(r < 0, r + ql, r)
    lead = poly.shape[:-2] + (poly.shape[-2], len(q))
    return np.moveaxis(out.reshape(lead), -1, -2).astype(np.int32)


def synthetic_basis(rows, n, bits, worst, rng):
    """numpy basis tables of `rows` rows (one per prime: the `rows`
    largest primes below 2^bits, the redundant modulus m_r the largest,
    its row last in er_mask) and n limbs, made as
    FheContext._fast_crt_for makes them (Bh and P_limbs_sh10 the limbs of
    B << 10 and P << 10 mod 2^16n): every limb of B and P 0xFFFF and
    every Bmodr m_r - 1 (worst), or random.  Returns (primes, tables
    with the kernel table, the same as torch tensors)."""
    primes = np.array(_primes_below(1 << bits, rows), np.int64)
    mr, top = int(primes[0]), 1 << (16 * n)
    ints = [top - 1 if worst else int.from_bytes(rng.bytes(2 * n), "little")
            for _ in range(rows + 1)]
    er_mask = np.zeros(rows, np.int64)
    er_mask[-1] = 1
    fc = dict(B=np.array([int_to_limbs(b, n) for b in ints[:rows]], np.int32),
              Bh=np.array([int_to_limbs((b << 10) % top, n)
                           for b in ints[:rows]], np.int32),
              Bmodr=(np.full(rows, mr - 1, np.int64) if worst else
                     rng.integers(0, mr, size=rows)),
              er_mask=er_mask,
              P_limbs=np.array(int_to_limbs(ints[rows], n), np.int32),
              P_limbs_sh10=np.array(int_to_limbs((ints[rows] << 10) % top, n),
                                    np.int32),
              mr=mr, Pinv_r=mr - 1 if worst else int(rng.integers(1, mr)),
              binv=np.ones(rows, np.int64))
    fc["k_crt"] = crt_cuda.kernel_table(fc)
    t = {k: torch.as_tensor(np.asarray(v, np.int32)) for k, v in fc.items()}
    t["mrinv_f"] = torch.as_tensor(np.float32(1.0 / mr))
    return primes, fc, t


def _check_crt_model(T, t_torch, res, wide, tail_args):
    """Every mode of the model against the plain versions on res."""
    tab = T["k_crt"] if isinstance(T["k_crt"], np.ndarray) else \
        T["k_crt"].numpy()
    rt = torch.from_numpy(res)
    got = crt_cuda.crt_partials(rt, t_torch, wide)
    part = model_crt(tab, "partials", res=res)
    n = part[0].shape[-1]
    for g, mdl in zip(got, part):
        assert np.array_equal(g.numpy().reshape(mdl.shape), mdl)
    for tail in (None,) + tail_args:
        want = crt_cuda.crt_to_limbs(rt, t_torch, wide, tail).numpy()
        width = want.shape[-1]
        assert np.array_equal(model_crt(tab, "to_limbs", res=res, tail=tail),
                              want.reshape(-1, width))
        assert np.array_equal(model_crt(tab, "finish", partials=part,
                                        tail=tail), want.reshape(-1, width))
        assert np.array_equal(crt_cuda.crt_finish(
            *(torch.from_numpy(p) for p in part), t_torch, wide,
            tail).numpy().reshape(-1, width), want.reshape(-1, width))
    return n


@pytest.mark.parametrize("kernel", ["crt_to_limbs", "limbs_to_residues"])
@pytest.mark.parametrize("basis", BASES)
@pytest.mark.parametrize("cfg", CONFIGS)
def test_kernel_model_equals_plain(cfg, basis, kernel):
    """The model on the port's own tables (DeviceContext's k_crt and
    chunk_tbl), random and worst-case inputs, every mode and tail."""
    td, T, _ = _tables(cfg, basis)
    primes, fc = T["primes_np"], T["fast_crt"]
    rng = np.random.default_rng(13)
    if kernel == "crt_to_limbs":
        res = rng.integers(0, primes[:, None], size=(3, len(primes), td.phim))
        res[0] = primes[:, None] - 1                      # every residue q - 1
        _check_crt_model(fc, fc, res.astype(np.int32), td.wide,
                         (td.tail("round_down"), td.tail("reduce_signed")))
        return
    for n in (td.n_ct, fc["B"].shape[-1]):
        poly = rng.integers(0, 1 << 16, size=(3, td.phim, n))
        poly[0] = M                                          # every limb 0xFFFF
        poly[1, :, -1] |= 0x8000                             # negative values
        poly = poly.astype(np.int32)
        wrap = td._wrap_const(primes, n)
        want = crt_cuda.limbs_to_residues(torch.from_numpy(poly),
                                          T["chunk_tbl"], wrap, T["q"],
                                          T["qinv_f"], td.wide)
        assert np.array_equal(model_lift(poly, T["chunk_tbl"].numpy(),
                                         primes, wrap.numpy().ravel()),
                              want.numpy())
        assert np.array_equal(model_lift_words(poly, T["chunk_tbl"].numpy(),
                                               primes, wrap.numpy().ravel()),
                              want.numpy())


def _primes_below(bound, count):
    out, q = [], bound - 1
    while len(out) < count:
        if numbth.is_prime(q):
            out.append(q)
        q -= 1
    return out


@pytest.mark.parametrize("kernel", ["crt_to_limbs", "limbs_to_residues"])
@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_kernel_model_at_its_bounds(wide, kernel):
    """A synthetic basis at the kernels' limits, 64 rows and 48 limbs,
    every table limb and every residue at its largest (the redundant
    modulus m_r the lane's largest prime), and 64 primes for the lift:
    the model's asserts check the crt.cu header's bounds, and it equals
    the plain versions in every mode."""
    qmax = 1 << (23 if wide else 20)
    rows, n = cuda_build.MAX_ROWS, cuda_build.MAX_LIMBS
    primes = np.array(_primes_below(qmax, rows), np.int64)
    rng = np.random.default_rng(14)
    if kernel == "limbs_to_residues":
        # the narrow plain version sums 4-bit chunks in int32: n <= 34
        n = n if wide else 34
        poly = rng.integers(0, 1 << 16, size=(3, 64, n))
        poly[0] = M
        poly[1, :, -1] |= 0x8000
        poly = poly.astype(np.int32)
        tbl = np.array([[pow(2, 4 * c, int(q)) for q in primes]
                        for c in range(4 * n)], np.int32)
        wrap = np.array([pow(2, 16 * n, int(q)) for q in primes], np.int64)
        want = crt_cuda.limbs_to_residues(
            torch.from_numpy(poly), torch.from_numpy(tbl),
            torch.from_numpy(wrap.astype(np.int32)[:, None]),
            torch.from_numpy(primes.astype(np.int32)[:, None]),
            torch.from_numpy((1.0 / primes[:, None]).astype(np.float32)),
            wide)
        assert np.array_equal(model_lift(poly, tbl, primes, wrap),
                              want.numpy())
        return
    mr = int(primes[0])
    er_mask = np.zeros(rows, np.int64)
    er_mask[-1] = 1
    fc = dict(B=np.full((rows, n), M, np.int32), Bh=np.full((rows, n), M,
                                                             np.int32),
              Bmodr=np.full(rows, mr - 1, np.int64), er_mask=er_mask,
              P_limbs=np.full(n, M, np.int32),
              P_limbs_sh10=np.full(n, M, np.int32), mr=mr, Pinv_r=mr - 1,
              binv=np.ones(rows, np.int64))
    fc["k_crt"] = crt_cuda.kernel_table(fc)
    t_torch = {k: torch.as_tensor(np.asarray(v, np.int32))
               for k, v in fc.items() if k != "k_crt"}
    t_torch["mrinv_f"] = torch.as_tensor(np.float32(1.0 / mr))
    res = rng.integers(0, mr, size=(3, rows, 64))
    res[0] = mr - 1
    log_q = 16 * (n - 3) - 5
    _check_crt_model(fc, t_torch, res.astype(np.int32), wide,
                     (Tail("round_down", log_q, n - 3),
                      Tail("reduce_signed", log_q, n - 3)))


@pytest.mark.parametrize("tail", TAILS,
                         ids=["none", "round_down", "reduce_signed"])
@pytest.mark.parametrize("basis", BASES)
@pytest.mark.parametrize("cfg", CONFIGS)
def test_pass_model_equals_plain(cfg, basis, tail):
    """The one-pass kernel's model on the port's own tables (random
    residues and a worst-case row, every residue q - 1) equals
    crt_to_limbs's plain version, without a tail and with each."""
    td, T, _ = _tables(cfg, basis)
    primes, fc = T["primes_np"], T["fast_crt"]
    rng = np.random.default_rng(15)
    res = rng.integers(0, primes[:, None], size=(3, len(primes), td.phim))
    res[0] = primes[:, None] - 1
    res = res.astype(np.int32)
    t = td.tail(tail) if tail else None
    want = crt_cuda.crt_to_limbs(torch.from_numpy(res), fc, td.wide, t)
    got = model_pass(fc["k_crt"].numpy(), res, t)
    assert np.array_equal(got, want.numpy().reshape(got.shape))


@pytest.mark.parametrize("tail", TAILS,
                         ids=["none", "round_down", "reduce_signed"])
@pytest.mark.parametrize("n", [1, 17, 48])
@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_pass_model_at_its_bounds(wide, n, tail):
    """The one-pass model on synthetic bases of 64 rows (primes just below
    2^20 or 2^23) at n = 1, 17 (odd: the last word holds one limb) and
    48: every table limb 0xFFFF with every residue q - 1 (the model
    asserts each bound of the crt.cu header there), then random tables;
    equal to the plain version each time."""
    rng = np.random.default_rng(16)
    rows = cuda_build.MAX_ROWS
    width = max(1, n - 3)
    t = Tail(tail, 16 * width - 5, width) if tail else None
    for worst in (True, False):
        primes, fc, tt = synthetic_basis(rows, n, 23 if wide else 20, worst,
                                         rng)
        res = rng.integers(0, primes[:, None], size=(2, rows, 64))
        res[0] = primes[:, None] - 1
        res = res.astype(np.int32)
        want = crt_cuda.crt_to_limbs(torch.from_numpy(res), tt, wide, t)
        got = model_pass(fc["k_crt"], res, t)
        assert np.array_equal(got, want.numpy().reshape(got.shape))


@pytest.mark.parametrize("n", [7, 8])
def test_pass_model_tails_at_every_offset(n):
    """The word tails of the one-pass model (sign_extend at bit logQ - 1,
    ScaleDown's shift by logQ + 1 across words) at every logQ below 16n
    and at widths from the narrowest the tail takes to past n, against
    the plain tails: every word and bit offset of an n-limb value."""
    rng = np.random.default_rng(23)
    primes, fc, tt = synthetic_basis(5, n, 20, False, rng)
    res = rng.integers(0, primes[:, None], size=(2, 5, 32)).astype(np.int32)
    for log_q in range(1, 16 * n):
        for width in sorted({log_q // 16 + 1, n, n + 3}):
            for kind in TAILS[1:]:
                t = Tail(kind, log_q, width)
                want = crt_cuda.crt_to_limbs(torch.from_numpy(res), tt, False,
                                             t)
                got = model_pass(fc["k_crt"], res, t)
                assert np.array_equal(got, want.numpy().reshape(got.shape))


@pytest.mark.parametrize("wide,n", [(False, 1), (False, 2), (False, 17),
                                    (False, 34), (True, 1), (True, 6),
                                    (True, 17), (True, 48)])
def test_lift_model_at_odd_and_even_n(wide, n):
    """The lift's model over pairs of limbs at odd n (the last word holds
    one limb) and even n, on 64 primes just below 2^20 or 2^23 (the
    narrow plain version sums 4-bit chunks in int32: n <= 34 there),
    with every limb 0xFFFF and negative values: equal to the plain
    version; the model asserts the header's 2^55 and 2^60."""
    rows = cuda_build.MAX_ROWS
    primes = np.array(_primes_below(1 << (23 if wide else 20), rows),
                      np.int64)
    rng = np.random.default_rng(17)
    poly = rng.integers(0, 1 << 16, size=(3, 64, n))
    poly[0] = M
    poly[1, :, -1] |= 0x8000
    poly = poly.astype(np.int32)
    tbl = np.array([[pow(2, 4 * c, int(q)) for q in primes]
                    for c in range(4 * n)], np.int32)
    wrap = np.array([pow(2, 16 * n, int(q)) for q in primes], np.int64)
    want = crt_cuda.limbs_to_residues(
        torch.from_numpy(poly), torch.from_numpy(tbl),
        torch.from_numpy(wrap.astype(np.int32)[:, None]),
        torch.from_numpy(primes.astype(np.int32)[:, None]),
        torch.from_numpy((1.0 / primes[:, None]).astype(np.float32)), wide)
    assert np.array_equal(model_lift_words(poly, tbl, primes, wrap),
                          want.numpy())


@pytest.mark.parametrize("cfg", CONFIGS)
def test_two_source_lift_equals_joined(cfg):
    """limbs_to_residues with a second limb tensor equals the lift of the
    two joined along the parts axis, in the port (cat, then the plain
    lift) and in the JAX package (fhe_si_tpu/ops/crt.py:38 on
    jnp.concatenate), on both residue lanes; mismatched operands raise."""
    td, T, JT = _tables(cfg, "full")
    rng = np.random.default_rng(18)
    shape = (2, td.phim, td.n_ct)
    a = rng.integers(0, 1 << 16, size=(2,) + shape)
    b = rng.integers(0, 1 << 16, size=(2, 3) + shape[1:])
    a[0, 0] = M
    b[1, :, :, -1] |= 0x8000
    a, b = a.astype(np.int32), b.astype(np.int32)
    wrap = td._wrap_const(T["primes_np"], td.n_ct)
    args = (T["chunk_tbl"], wrap, T["q"], T["qinv_f"], td.wide)
    got = crt_cuda.limbs_to_residues(torch.from_numpy(a), *args,
                                     second=torch.from_numpy(b))
    joined = np.concatenate([a, b], axis=-3)
    assert torch.equal(got, crt.limbs_to_residues(torch.from_numpy(joined),
                                                  *args))
    _eq(jcrt.limbs_to_residues(jnp.asarray(joined), JT["chunk_tbl"],
                               jnp.asarray(wrap.numpy()), JT["q"],
                               JT["qinv_f"], td.wide), got)
    for other in (b[:1], b[..., :-1], b[:, 0]):
        with pytest.raises(ValueError, match="join along axis -3"):
            crt_cuda.limbs_to_residues(torch.from_numpy(a), *args,
                                       second=torch.from_numpy(other))


@pytest.mark.parametrize("cfg", CONFIGS)
def test_tensor_mul_lifts_both_operands_in_one_call(cfg, monkeypatch):
    """DeviceContext._tensor_mul hands both operands to one
    limbs_to_residues call (second=b), not a join of them, and equals the
    JAX package's _tensor_mul (fhe_si_tpu/device.py:558)."""
    jd, td = _devices(*cfg)
    rng = np.random.default_rng(19)
    a = rng.integers(0, 1 << 16, size=(2, 2, td.phim, td.n_ct))
    b = rng.integers(0, 1 << 16, size=(2, 2, td.phim, td.n_ct))
    a, b = a.astype(np.int32), b.astype(np.int32)
    calls = []
    lift = crt_cuda.limbs_to_residues

    def counted(poly, chunk_tbl, wrap, q, qinv_f, wide=False, second=None):
        calls.append((tuple(poly.shape), None if second is None
                      else tuple(second.shape)))
        return lift(poly, chunk_tbl, wrap, q, qinv_f, wide, second)
    monkeypatch.setattr(crt_cuda, "limbs_to_residues", counted)
    got = td._tensor_mul(torch.from_numpy(a), torch.from_numpy(b))
    assert calls == [(a.shape, b.shape)]
    _eq(jd._tensor_mul(jd.C, jnp.asarray(a), jnp.asarray(b)), got)


def test_kernel_table_layout():
    """kernel_table's words: the header, the per-row constants with their
    Shoup reciprocals, then B, Bh, P_limbs, P_limbs_sh10; then, at a
    16-byte boundary, the one-pass section."""
    td = _devices(256, 257, None)[1]
    fc = td.ctx.fast_crt_tables
    w = crt_cuda.kernel_table(fc).view(np.uint32).astype(np.int64)
    rows, n = fc["B"].shape
    mr = int(fc["mr"])
    assert w.size == crt_cuda.table_words(rows, n)
    assert list(w[:HEADER]) == [rows, n, mr, fc["Pinv_r"],
                                (int(fc["Pinv_r"]) << 32) // mr, 0, 0, 0]
    rowc = w[HEADER:HEADER + ROW_WORDS * rows].reshape(rows, ROW_WORDS)
    assert np.array_equal(rowc[:, 0], fc["Bmodr"])
    assert np.array_equal(rowc[:, 1], (fc["Bmodr"].astype(np.int64) << 32)
                          // mr)
    assert np.array_equal(rowc[:, 2], fc["er_mask"])
    o = HEADER + ROW_WORDS * rows
    assert np.array_equal(w[o:o + 2 * rows * n],
                          np.concatenate([fc["B"].ravel(), fc["Bh"].ravel()]))
    end = crt_cuda.split_words(rows, n)
    assert np.array_equal(w[o + 2 * rows * n:end],
                          np.concatenate([fc["P_limbs"], fc["P_limbs_sh10"]]))
    # the one-pass section: at the next 16-byte boundary, its header,
    # rows of (Bmodr, er_mask, B's 32-bit words, zeros), P's words
    po = crt_cuda.pass_offset(rows, n)
    assert po % 4 == 0 and 0 <= po - end < 4 and not w[end:po].any()
    nw = (n + 1) // 2
    c32 = (1 << 32) % mr
    assert list(w[po:po + HEADER]) == [nw, c32, (c32 << 32) // mr,
                                       (1 << 32) // mr, 0, 0, 0, 0]
    body = w[po + HEADER:].reshape(rows + 1, PASS_ROW)
    assert w.size == po + HEADER + PASS_ROW * (rows + 1)
    assert np.array_equal(body[:rows, 0], fc["Bmodr"])
    assert np.array_equal(body[:rows, 1], fc["er_mask"])
    big = [sum(int(v) << (16 * k) for k, v in enumerate(limbs))
           for limbs in list(fc["B"]) + [fc["P_limbs"]]]
    assert np.array_equal(body[:, 2:2 + nw], [[(x >> (32 * j)) & M32
                                               for j in range(nw)]
                                              for x in big])
    assert not body[:, 2 + nw:].any() and not body[rows, :2].any()
    assert np.array_equal(td.full["fast_crt"]["k_crt"].numpy(),
                          crt_cuda.kernel_table(fc))


def test_kernel_table_past_its_widths():
    """A basis wider than MAX_LIMBS (the kernels refuse it on the card)
    still gets its table on the CPU: the split form's words alone, so a
    DeviceContext of such a context builds there and runs the plain
    versions."""
    ctx = FheContext(m=256, log_q=800, p=257, generator=3)
    assert ctx.n_limbs > cuda_build.MAX_LIMBS
    dc = DeviceContext(ctx, "cpu")
    fc = ctx.fast_crt_tables
    rows, n = fc["B"].shape
    tab = dc.full["fast_crt"]["k_crt"].numpy()
    assert tab.size == crt_cuda.table_words(rows, n) \
        == crt_cuda.split_words(rows, n)
    assert np.array_equal(tab[:HEADER].view(np.uint32)[:3],
                          [rows, n, int(fc["mr"])])
    res = np.random.default_rng(22).integers(
        0, dc.full["primes_np"][:, None], size=(2, rows, dc.phim))
    res = torch.from_numpy(res.astype(np.int32))
    assert torch.equal(crt_cuda.crt_to_limbs(res, dc.full["fast_crt"]),
                       crt.residues_to_limbs_fast(res, dc.full["fast_crt"],
                                                  None, None,
                                                  prescaled=True))


@pytest.mark.parametrize("rows,n,tail,primes", [
    (65, 17, None, None), (12, 49, None, None), (0, 17, None, None),
    (12, 17, Tail("round_down", 272, 6), None),
    (12, 17, Tail("reduce_signed", 80, 5), None),
    (12, 17, Tail("truncate", 80, 6), None),
    (2, 17, None, [97, 1 << 23]), (2, 17, None, [1, 97])])
def test_shapes_the_kernels_refuse(rows, n, tail, primes):
    """check_shape (which DeviceContext runs on a CUDA device before any
    path, with each basis' primes, on which the crt.cu bounds rest) and
    the tail check raise with the shape."""
    with pytest.raises(ValueError, match=r"crt_to_limbs"):
        crt_cuda.check_shape("crt_to_limbs", (7, rows, 4096), rows, n,
                             None if primes is None else np.array(primes))
        crt_cuda._check_tail("crt_to_limbs", tail, n)


@pytest.mark.parametrize("cfg", CONFIGS)
def test_context_bases_the_kernels_take(cfg):
    """Every basis of the narrow and the wide contexts passes the host
    check that DeviceContext runs on a CUDA device."""
    td = _devices(*cfg)[1]
    for T in (td.full, td.ksw, td.lin):
        B = T["fast_crt"]["B"]
        crt_cuda.check_shape("crt_to_limbs", B.shape, *B.shape,
                             T["primes_np"])


@pytest.mark.parametrize("cfg", CONFIGS)
def test_kernel_operands_are_contiguous_int32(cfg):
    """What the kernels read from a DeviceContext (the basis table, the
    chunk table of every basis, a row gather among them, and q) is
    contiguous int32, as their wrappers require on the card."""
    td = _devices(*cfg)[1]
    for T in (td.full, td.ksw, td.lin):
        for t in (T["fast_crt"]["k_crt"], T["chunk_tbl"], T["q"],
                  td._wrap_const(T["primes_np"], td.n_ct)):
            assert t.dtype == torch.int32 and t.is_contiguous()
