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
    own integer widths (int32 limb sums, 32-bit Shoup products, the
    64-bit lift sum) and reading the kernel's own table layout
    (crt_cuda.kernel_table), held equal to the plain versions on
    worst-case inputs: every residue q - 1, every limb 0xFFFF, negative
    values, and synthetic bases of 64 rows and 48 limbs (the kernels'
    largest), where it also asserts the bounds the crt.cu header states.
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
from fhe_si_tpu_torch.ops import crt_cuda
from fhe_si_tpu_torch.ops.crt_cuda import HEADER, ROW_WORDS, Tail

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
    P, P10 = w[o + 2 * rows * n:o + 2 * rows * n + n], w[o + 2 * rows * n + n:]
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
    rows, n = crt_cuda.MAX_ROWS, crt_cuda.MAX_LIMBS
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


def test_kernel_table_layout():
    """kernel_table's words: the header, the per-row constants with their
    Shoup reciprocals, then B, Bh, P_limbs, P_limbs_sh10."""
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
    assert np.array_equal(w[o + 2 * rows * n:],
                          np.concatenate([fc["P_limbs"], fc["P_limbs_sh10"]]))
    assert np.array_equal(td.full["fast_crt"]["k_crt"].numpy(),
                          crt_cuda.kernel_table(fc))


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
