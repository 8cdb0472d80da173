"""Mixed-radix rings m = 2^a * q^b on the port's Cooley-Tukey family,
against fhe_si_tpu with no tolerance.  Mirrors tests/test_ntt_ct.py:59
(m = 64, 40, 96, 160, 18, 54), :79 (the digit transform at m = 64 and
160) and :125 (m = 20480, L = 2), and tests/test_ct_scheme.py:151-171
(m = 160 with use_ct forced; the m = 20480 scheme parity is slow there
and here).  The JAX package runs these rings through XLA (its Pallas
kernels take m = 2^k only), so the XLA transforms are the reference.
The CUDA wrappers route the CPU tensors here to the plain versions; the
kernel runs these shapes in test_torch_cuda.py and chip_smoke.py."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fhe_si_tpu import sampling
from fhe_si_tpu import scheme as jscheme
from fhe_si_tpu.context import FheContext as RefContext
from fhe_si_tpu.device import DeviceContext as RefDevice
from fhe_si_tpu.hostmath import oracle
from fhe_si_tpu.ops import ntt_ct as jct
from fhe_si_tpu_torch import DeviceContext, FheContext, scheme
from fhe_si_tpu_torch.hostmath import numbth
from fhe_si_tpu_torch.ops import cuda_build, ntt_ct as tct, ntt_ct_cuda

from test_torch_scheme_ops import run_scheme_parity

torch.set_num_threads(1)

xla_fwd = jax.jit(jct.ct_fwd, static_argnums=2)
xla_fwd_digits = jax.jit(jct.ct_fwd_digits, static_argnums=(2, 3))
xla_inv = jax.jit(jct.ct_inv, static_argnums=(2, 3))
M160 = dict(m=160, log_q=80, p=641, generator=3)     # phim 64, 10 x 8


def _primes_for(m: int, count: int, bits: int = 20) -> list[int]:
    """The largest `count` primes below 2^bits with m | q - 1 (the
    selection of tests/test_ntt_ct.py _primes_for)."""
    out, t = [], ((1 << bits) - 1) // m
    while len(out) < count:
        if numbth.is_prime(t * m + 1):
            out.append(t * m + 1)
        t -= 1
    return out


def _tables(m: int, primes, wide: bool = False):
    """Both packages' tables for the same primes and roots."""
    roots = [numbth.find_element_of_order(q, m) for q in primes]
    jt = jct.CtNttTables(m, primes, roots, wide=wide)
    meta, T = tct.ct_tables(m, primes, roots)
    assert tuple(meta) == tuple(jt.meta)
    return jt.meta, jt.pack(), meta, {k: torch.as_tensor(v)
                                      for k, v in T.items()}


def _check_transforms(m, primes, rows, wide=False, seed=0):
    """Forward, digits and inverse equal JAX's; the round trip is exact;
    the CUDA wrappers take CPU tensors to the plain versions."""
    jmeta, JT, meta, T = _tables(m, primes, wide)
    assert meta.phim == numbth.euler_phi(m) and meta.q_odd > 1
    rng = np.random.default_rng(seed)
    res = np.stack([rng.integers(0, q, (rows, meta.phim)) for q in primes],
                   axis=1).astype(np.int32)
    x = torch.from_numpy(res)
    ev = tct.ct_fwd(T, x, meta)
    assert np.array_equal(ev.numpy(), np.asarray(
        xla_fwd(JT, jnp.asarray(res), jmeta)))
    back = tct.ct_inv(T, ev, meta)
    assert np.array_equal(back.numpy(), np.asarray(
        xla_inv(JT, jnp.asarray(ev.numpy()), jmeta, "t2i")))
    assert torch.equal(back, x)
    d = rng.integers(0, 1 << 24, (rows, meta.phim)).astype(np.int32)
    got = tct.ct_fwd_digits(T, torch.from_numpy(d), meta, 24)
    assert np.array_equal(got.numpy(), np.asarray(
        xla_fwd_digits(JT, jnp.asarray(d), jmeta, 24)))
    cuda_build.reset_launches()
    assert torch.equal(ntt_ct_cuda.ct_fwd(T, x, meta), ev)
    assert torch.equal(ntt_ct_cuda.ct_inv(T, ev, meta), x)
    assert torch.equal(ntt_ct_cuda.ct_fwd_digits(T, torch.from_numpy(d),
                                                 meta, 24), got)
    assert not any(cuda_build.LAUNCHES.values())
    return T, meta, d, got


@pytest.mark.parametrize("m", [40, 96, 160, 18, 54])
def test_transforms_match_jax_small(m):
    """Every family shape of tests/test_ntt_ct.py:59 past m = 2^k: 2^a*5,
    2^a*3, 2*3^3 (odd N1 = 5, 3, 9 among them), three narrow primes."""
    _check_transforms(m, _primes_for(m, 3), rows=2)


def test_transforms_match_jax_m64():
    """m = 2^6 through the same public functions: pad, drop and fold are
    no-ops there."""
    jmeta, JT, meta, T = _tables(64, _primes_for(64, 3))
    assert meta.q_odd == 1 and meta.phim == meta.N
    x = np.random.default_rng(0).integers(
        0, T['q'].numpy()[:, None], (2, 3, 32)).astype(np.int32)
    ev = tct.ct_fwd(T, torch.from_numpy(x), meta)
    assert np.array_equal(ev.numpy(),
                          np.asarray(xla_fwd(JT, jnp.asarray(x), jmeta)))
    assert np.array_equal(tct.ct_inv(T, ev, meta).numpy(), x)


def test_transforms_match_jax_wide_lane():
    """m = 160 on two primes of the wide lane (below 2^23)."""
    _check_transforms(160, _primes_for(160, 2, bits=23), rows=3, wide=True,
                      seed=1)


def test_digits_equal_residue_transform():
    """tests/test_ntt_ct.py:79: the prime-independent digit transform
    equals the forward transform of the digits reduced per prime."""
    primes = _primes_for(160, 3)
    T, meta, d, got = _check_transforms(160, primes, rows=5, seed=1)
    res = d[:, None, :] % np.asarray(primes)[None, :, None]
    assert torch.equal(got, tct.ct_fwd(T, torch.from_numpy(
        res.astype(np.int32)), meta))


def test_m20480_matches_jax():
    """tests/test_ntt_ct.py:125 at m = 20480 = 2^12 * 5 (phim 8192,
    N1 x N2 = 128 x 80), L = 2: the digit stage splits its table at
    12 bits (K = 80)."""
    _check_transforms(20480, _primes_for(20480, 2), rows=1, seed=2)


@functools.cache
def _m160_pair():
    """The m = 160 ring with the Cooley-Tukey family forced on both
    packages (tests/test_ct_scheme.py:151-159)."""
    ref, ctx = RefContext(**M160), FheContext(**M160)
    assert not ref.use_ct and not ctx.use_ct
    ref.use_ct = ctx.use_ct = True
    return ref, ctx


def test_m160_forced_ct_device_matches_jax():
    """The DeviceContext tables of every basis (t2i_crt with its CRT
    premultiplier included) and the full-chain transforms equal the JAX
    DeviceContext's."""
    ref, ctx = _m160_pair()
    jd, td = RefDevice(ref), DeviceContext(ctx, "cpu")
    assert tuple(td.ct_meta) == tuple(jd.ct_meta) == (10, 8, 64, 5)
    for T, JT in ((td.full, jd.C), (td.ksw, jd.C["ksw"]),
                  (td.lin, jd.C["lin"])):
        for k in ("t1", "t2", "t1i", "t2i", "t2i_crt"):
            p = np.asarray(JT["ct"][k]).astype(np.int64)
            assert np.array_equal(T["ct"][k].numpy(),
                                  p[0] + (p[1] << 7) + (p[2] << 14)), k
    x = np.random.default_rng(3).integers(
        0, ctx.primes[:, None], (2, 3, ctx.num_primes, ctx.phim)).astype(
            np.int32)
    ev = td.ntt_fwd(torch.from_numpy(x))
    assert np.array_equal(ev.numpy(), np.asarray(jd.ntt_fwd(jnp.asarray(x))))
    assert np.array_equal(td.ntt_inv(ev).numpy(), x)
    assert np.array_equal(
        td.to_poly(ev).numpy(),
        np.asarray(jd.to_poly(jnp.asarray(ev.numpy()))))


def test_m160_forced_ct_scheme_matches_jax_and_oracle():
    """Keys, ciphertexts and a relinearized product equal the JAX
    package's on the same draws; then the oracle circuit of
    tests/test_ct_scheme.py:159 (encrypt, mul+relin, automorph and
    rotation, decrypt) on the port."""
    ref, ctx = _m160_pair()
    out = []
    for sch, c, dev in ((jscheme, ref, ref),
                        (scheme, ctx, DeviceContext(ctx, "cpu"))):
        src = sampling.RandomSource(9)
        sk, pk = sch.keygen(dev, src)
        ksw = sch.KeySwitch.for_relinearization(sk, src)
        msgs = [src.uniform_mod_p(c.phim, c.p) for _ in range(2)]
        cts = [pk.encrypt(sch.Plaintext(c, mm), src) for mm in msgs]
        prod = ksw.apply(cts[0] * cts[1])
        out.append((np.asarray(pk.pk_limbs), np.asarray(sk.sk_evals),
                    [ct.to_python_parts() for ct in cts],
                    prod.to_python_parts(), list(sk.decrypt(prod).message)))
        want = list(oracle.plaintext_mul(c, *msgs))
    (jpk, jsk, jcts, jprod, jdec), (tpk, tsk, tcts, tprod, tdec) = out
    assert np.array_equal(jpk, tpk) and np.array_equal(jsk, tsk)
    assert jcts == tcts and jprod == tprod
    assert jdec == tdec == want
    run_scheme_parity(ctx, seed=9)


@pytest.mark.slow
def test_m20480_scheme_parity():
    """tests/test_ct_scheme.py:162-171: encrypt, mul+relin and decrypt at
    FheContext(m=20480, log_q=80, p=40961, generator=3) (phim 8192) on
    the port, against the oracle on the same draws."""
    ctx = FheContext(m=20480, log_q=80, p=40961, generator=3)
    assert ctx.use_ct and ctx.phim == 8192
    dev = DeviceContext(ctx, "cpu")
    assert tuple(dev.ct_meta) == (128, 80, 8192, 5)
    src_d, src_o = sampling.RandomSource(13), sampling.RandomSource(13)
    args = (ctx.phim, ctx.stdev, ctx.log_q)
    sk_d, pk_d = scheme.keygen(dev, sampling.sample_keygen(src_d, *args))
    sk_o, pk_o = oracle.keygen(ctx, sampling.sample_keygen(src_o, *args))
    msgs, cd, co = [], [], []
    for _ in range(2):
        msgs.append(src_d.uniform_mod_p(ctx.phim, ctx.p))
        src_o.uniform_mod_p(ctx.phim, ctx.p)
        cd.append(pk_d.encrypt(scheme.Plaintext(ctx, msgs[-1]),
                               sampling.sample_encrypt(src_d, ctx.phim,
                                                       ctx.stdev)))
        co.append(oracle.encrypt(pk_o, msgs[-1], sampling.sample_encrypt(
            src_o, ctx.phim, ctx.stdev)))
    assert cd[0].to_python_parts() == co[0].parts
    ksw_d = scheme.KeySwitch.for_relinearization(
        sk_d, sampling.sample_keyswitch(src_d, *args, 3, ctx.ndigits))
    ksw_o = oracle.keyswitch_init_s2(
        sk_o, sampling.sample_keyswitch(src_o, *args, 3, ctx.ndigits))
    got = ksw_d.apply(cd[0] * cd[1])
    assert got.to_python_parts() == oracle.apply_keyswitch(
        ksw_o, oracle.mul(co[0], co[1])).parts
    assert list(sk_d.decrypt(got).message) == list(
        oracle.plaintext_mul(ctx, *msgs))
