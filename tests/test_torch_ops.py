"""The port's modular, limb and CRT ops against fhe_si_tpu.ops on the
same numpy-seeded inputs: exact equality."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fhe_si_tpu.ops import crt as jcrt, limbs as jlb, modular as jmod
from fhe_si_tpu_torch import DeviceContext, FheContext
from fhe_si_tpu_torch.ops import crt as tcrt, limbs as tlb, modular as tmod

torch.set_num_threads(1)

QS = np.array([1032193, 786433, 40961], dtype=np.int64)   # chain-sized primes


def _both(a):
    """One numpy int32/float32 array as (jnp, torch)."""
    a = np.asarray(a)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _eq(j, t):
    j = np.asarray(j)
    t = t.numpy()
    assert j.dtype == t.dtype and j.shape == t.shape
    assert np.array_equal(j, t)


def _q():
    return (_both(QS[:, None].astype(np.int32))
            + _both((1.0 / QS[:, None]).astype(np.float32)))


# ------------------------------------------------------------------ modular
@pytest.mark.parametrize("op", ["barrett", "mod_mul", "mod_add", "mod_sub",
                                "mod_neg", "mod_dot"])
def test_modular_parity(op):
    rng = np.random.default_rng(1)
    qj, qt, qij, qit = _q()
    a = rng.integers(0, QS[:, None], size=(4, 3, 64)).astype(np.int32)
    b = rng.integers(0, QS[:, None], size=(4, 3, 64)).astype(np.int32)
    (aj, at), (bj, bt) = _both(a), _both(b)
    if op == "barrett":
        t = rng.integers(-2 ** 31, 2 ** 31, size=(4, 3, 64)).astype(np.int32)
        tj, tt = _both(t)
        _eq(jmod.barrett(tj, qj, qij), tmod.barrett(tt, qt, qit))
        assert np.array_equal(tmod.barrett(tt, qt, qit).numpy(),
                              t.astype(np.int64) % QS[:, None])
    elif op == "mod_mul":
        _eq(jmod.mod_mul(aj, bj, qj, qij), tmod.mod_mul(at, bt, qt, qit))
    elif op == "mod_add":
        _eq(jmod.mod_add(aj, bj, qj), tmod.mod_add(at, bt, qt))
    elif op == "mod_sub":
        _eq(jmod.mod_sub(aj, bj, qj), tmod.mod_sub(at, bt, qt))
    elif op == "mod_neg":
        a[0, :, :5] = 0
        aj, at = _both(a)
        _eq(jmod.mod_neg(aj, qj), tmod.mod_neg(at, qt))
    else:   # the keyswitch shape: [2, K, L, n] x [B, 1, K, L, n], axis -3
        mat = rng.integers(0, QS[:, None], size=(2, 12, 3, 64)).astype(np.int32)
        dig = rng.integers(0, QS[:, None], size=(5, 1, 12, 3, 64)).astype(np.int32)
        (mj, mt), (dj, dt) = _both(mat), _both(dig)
        _eq(jmod.mod_dot(mj, dj, qj, qij, axis=-3),
            tmod.mod_dot(mt, dt, qt, qit, axis=-3))


# -------------------------------------------------------------------- limbs
LOG_Q = 80
N = 6


def _limbs(rng, shape=(3, 17), n=N):
    return rng.integers(0, 1 << 16, size=shape + (n,)).astype(np.int32)


def _q_limbs(n=N):
    from fhe_si_tpu.context import int_to_limbs
    return _both(int_to_limbs(1 << LOG_Q, n))


@pytest.mark.parametrize("op", [
    "normalize", "add", "sub", "neg", "is_negative", "reduce_positive",
    "reduce_signed", "match_width", "arith_shift_right", "shift_left",
    "mul_small", "scale_coeffs_by_bigint", "from_small_signed",
    "byte_decomp"])
def test_limbs_parity(op):
    rng = np.random.default_rng(2)
    a = _limbs(rng)
    b = _limbs(rng)
    (aj, at), (bj, bt) = _both(a), _both(b)
    if op == "normalize":
        acc = rng.integers(-2 ** 20, 2 ** 20, size=(3, 17, N)).astype(np.int32)
        _eq(jlb.normalize(jnp.asarray(acc)), tlb.normalize(torch.from_numpy(acc)))
    elif op in ("add", "sub"):
        _eq(getattr(jlb, op)(aj, bj), getattr(tlb, op)(at, bt))
    elif op == "neg":
        _eq(jlb.neg(aj), tlb.neg(at))
    elif op == "is_negative":
        _eq(jlb.is_negative(aj), tlb.is_negative(at))
    elif op in ("reduce_positive", "reduce_signed"):
        pos = op == "reduce_positive"
        qj, qt = _q_limbs()
        for w in (None, N, 6):
            _eq(jlb.reduce_mod_q(aj, LOG_Q, pos, qj, out_width=w),
                tlb.reduce_mod_q(at, LOG_Q, pos, qt, out_width=w))
    elif op == "match_width":
        for n in (3, N, 9):
            _eq(jlb.match_width(aj, n), tlb.match_width(at, n))
    elif op == "arith_shift_right":
        for s in (0, 7, 16, 33, LOG_Q + 1):
            _eq(jlb.arith_shift_right(aj, s), tlb.arith_shift_right(at, s))
    elif op == "shift_left":
        for s in (0, 1, 16, 24, 48, 72):
            _eq(jlb.shift_left(aj, s), tlb.shift_left(at, s))
    elif op == "mul_small":
        c = rng.integers(0, 1 << 30, size=(3, 17)).astype(np.int32)
        cj, ct = _both(c)
        _eq(jlb.mul_small(aj, cj), tlb.mul_small(at, ct))
        _eq(jlb.mul_small(aj, 2 * 40961), tlb.mul_small(at, 2 * 40961))
    elif op == "scale_coeffs_by_bigint":
        from fhe_si_tpu.context import int_to_limbs
        C = (1 << LOG_Q) // 40961
        tabs = [_both(int_to_limbs(C << s, N)) for s in (0, 10, 20)]
        coeffs = rng.integers(0, 1 << 30, size=(3, 17)).astype(np.int32)
        cj, ct = _both(coeffs)
        _eq(jlb.scale_coeffs_by_bigint(cj, *[x[0] for x in tabs]),
            tlb.scale_coeffs_by_bigint(ct, *[x[1] for x in tabs]))
        _eq(jlb.scale_coeffs_by_bigint(cj, *[x[0] for x in tabs[:2]]),
            tlb.scale_coeffs_by_bigint(ct, *[x[1] for x in tabs[:2]]))
    elif op == "from_small_signed":
        e = rng.integers(-200, 200, size=(3, 17)).astype(np.int32)
        ej, et = _both(e)
        _eq(jlb.from_small_signed(ej, 17), tlb.from_small_signed(et, 17))
    else:
        qj, qt = _q_limbs()
        for bits, nd in ((24, 4), (16, 5), (8, 10)):
            _eq(jlb.byte_decomp(aj, LOG_Q, bits, nd, qj),
                tlb.byte_decomp(at, LOG_Q, bits, nd, qt))


# ---------------------------------------------------------------------- crt
@pytest.fixture(scope="module")
def dev():
    return DeviceContext(FheContext(m=32, log_q=80, p=97, generator=3), "cpu")


def _as_jax(tables: dict) -> dict:
    """The port's tables (held equal to the JAX DeviceContext's by
    test_torch_context.py) as jnp arrays, so both packages' functions
    read the same constants."""
    return {k: _as_jax(v) if isinstance(v, dict) else jnp.asarray(v.numpy())
            for k, v in tables.items() if isinstance(v, (dict, torch.Tensor))}


@pytest.mark.parametrize("basis", ["full", "ksw"])
@pytest.mark.parametrize("op", ["limbs_to_residues", "limbs_to_mod_small",
                                "crt_partials", "crt_partials_prescaled",
                                "residues_to_limbs_fast"])
def test_crt_parity(dev, op, basis):
    T = dev.full if basis == "full" else dev.ksw
    JT = _as_jax(T)
    primes = T["primes_np"]
    rng = np.random.default_rng(3)
    if op == "limbs_to_residues":
        for n in (dev.n_ct, dev.n):
            poly = _limbs(rng, (2, 5, dev.phim), n)
            pj, pt = _both(poly)
            wrap = dev._wrap_const(primes, n)
            _eq(jcrt.limbs_to_residues(pj, JT["chunk_tbl"],
                                       jnp.asarray(wrap.numpy()),
                                       JT["q"], JT["qinv_f"]),
                tcrt.limbs_to_residues(pt, T["chunk_tbl"], wrap,
                                       T["q"], T["qinv_f"]))
    elif op == "limbs_to_mod_small":
        poly = _limbs(rng, (2, dev.phim), dev.n)
        pj, pt = _both(poly)
        p_wrap = pow(2, 16 * dev.n, dev.p)
        _eq(jcrt.limbs_to_mod_small(pj, jnp.asarray(dev.p_chunk_tbl.numpy()),
                                    jnp.int32(p_wrap), jnp.int32(dev.p),
                                    jnp.float32(1.0 / dev.p)),
            tcrt.limbs_to_mod_small(pt, dev.p_chunk_tbl, p_wrap, dev.p,
                                    dev.pinv_f))
    else:
        res = rng.integers(0, primes[:, None],
                           size=(2, 3, len(primes), dev.phim)).astype(np.int32)
        rj, rt = _both(res)
        if op == "residues_to_limbs_fast":
            _eq(jcrt.residues_to_limbs_fast(rj, JT["fast_crt"], JT["q"],
                                            JT["qinv_f"], prescaled=True),
                tcrt.residues_to_limbs_fast(rt, T["fast_crt"], T["q"],
                                            T["qinv_f"], prescaled=True))
        else:
            pre = op == "crt_partials_prescaled"
            got = tcrt.crt_partials(rt, T["fast_crt"], T["q"], T["qinv_f"],
                                    pre)
            want = jcrt.crt_partials(rj, JT["fast_crt"], JT["q"],
                                     JT["qinv_f"], pre)
            for w, g in zip(want, got):
                _eq(w, g)
            n = T["fast_crt"]["B"].shape[-1]
            _eq(jcrt.crt_finish(*want, JT["fast_crt"], n),
                tcrt.crt_finish(*got, T["fast_crt"], n))


def _centered_values(rng, P, n):
    vals = []
    for _ in range(n):
        v = int(rng.integers(0, 2 ** 63)) * int(rng.integers(0, 2 ** 63)) % P
        vals.append(v - P if v > P // 2 else v)
    return vals


@pytest.mark.parametrize("case", ["roundtrip", "fast_equals_garner"])
def test_garner_parity(dev, case):
    """The Garner reconstruction (crt.residues_to_limbs) against the JAX
    package's on the same residues, as tests/test_ops.py:117-158 use it:
    the limbs -> residues -> limbs round trip over the whole chain
    product, and equality with the single-pass reconstruction within its
    budget |E| < P/2 of the CRT product."""
    from fhe_si_tpu_torch.context import int_to_limbs, limbs_to_int
    ctx = dev.ctx
    rng = np.random.default_rng(4 if case == "roundtrip" else 7)
    P = ctx.prime_product if case == "roundtrip" else ctx.crt_product
    vals = _centered_values(rng, P, ctx.phim)
    vals[0], vals[1], vals[2] = 0, P // 2 - 1, -(P // 2 - 1)
    T = dev.full
    G, JG = dev.garner, _as_jax(dev.garner)
    if case == "roundtrip":
        poly = np.stack([int_to_limbs(v, ctx.n_limbs) for v in vals])[None]
        res = tcrt.limbs_to_residues(torch.from_numpy(poly), T["chunk_tbl"],
                                     dev._wrap_const(T["primes_np"],
                                                     ctx.n_limbs),
                                     T["q"], T["qinv_f"])
    else:
        res = torch.as_tensor(np.array([[v % int(p) for v in vals]
                                        for p in ctx.primes])[None],
                              dtype=torch.int32)
    got = tcrt.residues_to_limbs(res, G, T["q"], T["qinv_f"], ctx.n_limbs)
    _eq(jcrt.residues_to_limbs(jnp.asarray(res.numpy()), JG,
                               jnp.asarray(T["q"].numpy()),
                               jnp.asarray(T["qinv_f"].numpy()), ctx.n_limbs),
        got)
    assert [limbs_to_int(got[0, j].numpy()) for j in range(ctx.phim)] == vals
    if case == "fast_equals_garner":
        assert torch.equal(got, tcrt.residues_to_limbs_fast(
            res, T["fast_crt"], T["q"], T["qinv_f"], ctx.n_limbs))
