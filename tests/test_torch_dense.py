"""The dense transform family of the port (ops/ntt.py and DeviceContext's
dense branch) against fhe_si_tpu on the CPU, with no tolerance: modmatmul
against the JAX int8-plane modmatmul, the public ntt_fwd / ntt_inv and the
prescaled inverse of every basis against the JAX DeviceContext's tables,
at m = 22, 46 and 31 on both residue lanes and at m = 262 (phim 130),
where the wide lane takes the 12-bit split and the narrow lane does not;
plus the decompSize >= 4 digit planes and the large-p decrypt tail."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fhe_si_tpu.context import FheContext as RefContext
from fhe_si_tpu.context import ints_to_limbs
from fhe_si_tpu.device import device_context
from fhe_si_tpu.ops import limbs as jlimbs
from fhe_si_tpu.ops import ntt as jntt
from fhe_si_tpu_torch import DeviceContext, FheContext
from fhe_si_tpu_torch.hostmath import numbth
from fhe_si_tpu_torch.ops import limbs as lb
from fhe_si_tpu_torch.ops import ntt

torch.set_num_threads(1)

# (m, log_q, p, generator)
RINGS = [pytest.param((22, 80, 23, 7), id="m22"),
         pytest.param((46, 96, 47, 5), id="m46"),
         pytest.param((31, 80, 2, 3), id="m31-p2-d5"),
         pytest.param((262, 80, 263, 17), id="m262")]
LANES = [pytest.param(None, id="narrow"), pytest.param(23, id="wide")]


def _primes(n, top_bits):
    """n primes just below 2^top_bits."""
    out, p = [], (1 << top_bits) - 1
    while len(out) < n:
        if numbth.is_prime(p):
            out.append(p)
        p -= 2
    return np.array(out, dtype=np.int64)


def _unchunk(planes):
    """The JAX package's int8 digit planes -> the integer table."""
    p = np.asarray(planes).astype(np.int64)
    if p.shape[0] == jntt.N_PLANES_W:
        return p[0] + (p[1] << 6) + (p[2] << 12) + (p[3] << 18)
    return p[0] + (p[1] << 7) + (p[2] << 14)


def _integer_table(operands):
    """The port's float64 operands -> the integer table."""
    t = [op.to(torch.int64).numpy() for op in operands]
    return t[0] if len(t) == 1 else (t[0] << ntt.SPLIT_BITS) + t[1]


def _jax_mm(planes, x, q_np):
    return np.asarray(jntt.modmatmul(
        planes, jnp.asarray(x), jnp.asarray(q_np[:, None].astype(np.int32)),
        jnp.asarray((1.0 / q_np[:, None]).astype(np.float32))))


@pytest.mark.parametrize("top_bits,K,split", [(20, 200, False),
                                              (23, 100, False),
                                              (23, 200, True)],
                         ids=["narrow-K200", "wide-K100", "wide-K200-split"])
def test_modmatmul_equals_jax(top_bits, K, split):
    rng = np.random.default_rng(K + top_bits)
    qs = _primes(3, top_bits)
    assert ntt.needs_split(K, int(qs.max())) == split
    tab = rng.integers(0, qs[:, None, None], size=(3, 7, K))
    x = rng.integers(0, qs[:, None], size=(2, 4, 3, K)).astype(np.int32)
    q = torch.as_tensor(qs[:, None])
    ops = ntt.operands(tab, int(qs.max()))
    assert len(ops) == 1 + split
    got = ntt.modmatmul(ops, torch.as_tensor(x), q).numpy()
    assert got.dtype == np.int32 and got.shape == (2, 4, 3, 7)
    want = np.einsum("lok,...lk->...lo", tab.astype(object),
                     x.astype(object)) % qs[:, None]
    assert np.array_equal(got, want.astype(np.int64))
    planes = jnp.asarray(jntt.chunk_matrix(tab, wide=top_bits > 20))
    assert np.array_equal(got, _jax_mm(planes, x, qs))


def test_crt_premultiplier_fold():
    rng = np.random.default_rng(3)
    qs = _primes(3, 23)
    tab = rng.integers(0, qs[:, None, None], size=(3, 5, 5)).astype(np.int32)
    binv = np.array([7, 123456, 0])
    got = ntt.with_crt_premultiplier(tab, binv, qs)
    want = tab.astype(np.int64) * np.array([7, 123456, 1])[:, None, None]
    assert np.array_equal(got, want % qs[:, None, None])


@pytest.mark.parametrize("prime_bits", LANES)
@pytest.mark.parametrize("ring", RINGS)
def test_dense_transforms_equal_jax(ring, prime_bits):
    m, log_q, p, g = ring
    kw = dict(m=m, log_q=log_q, p=p, generator=g, prime_bits=prime_bits)
    ref, ctx = RefContext(**kw), FheContext(**kw)
    assert not ctx.use_ct and ctx.wide == (prime_bits is not None)
    jd, td = device_context(ref), DeviceContext(ctx, "cpu")
    assert td.ct_meta is None
    # the m = 262 ring: the wide lane splits, the narrow one does not
    want_split = m == 262 and ctx.wide
    assert all(len(T[k]) == 1 + want_split
               for T in (td.full, td.ksw, td.lin) for k in ("fwd", "inv_crt"))
    rng = np.random.default_rng(m)

    def residues(q_np, lead=(3,)):
        return rng.integers(0, q_np[:, None], size=lead + (len(q_np), ctx.phim)
                            ).astype(np.int32)

    x = residues(ctx.primes, (2, 3))
    xt = torch.as_tensor(x)
    assert np.array_equal(td.ntt_fwd(xt).numpy(), np.asarray(jd.ntt_fwd(x)))
    assert np.array_equal(td.ntt_inv(xt).numpy(), np.asarray(jd.ntt_inv(x)))
    assert np.array_equal(_integer_table(td.full["inv"]),
                          _unchunk(jd.C["inv_chunks"]))
    # every basis: the forward and the prescaled inverse table are JAX's
    # (unchunked), and the port's transforms equal their exact products
    subsets = [(td.full, jd._full_as_subset(jd.C)),
               (td.ksw, jd._ksw_tables(jd.C)), (td.lin, jd._lin_tables(jd.C))]
    for T, JT in subsets:
        q_np = T["primes_np"]
        assert np.array_equal(T["q"].numpy(), np.asarray(JT["q"]))
        xs = residues(q_np)
        for op, key, jkey in ((td._fwd_t, "fwd", "fwd_chunks"),
                              (td._inv_crt_t, "inv_crt", "inv_chunks")):
            tab = _unchunk(JT[jkey])
            assert np.array_equal(_integer_table(T[key]), tab)
            want = np.einsum("lok,...lk->...lo", tab, xs.astype(np.int64))
            assert np.array_equal(op(T, torch.as_tensor(xs)).numpy(),
                                  want % q_np[:, None])
    # the prescaled full-chain inverse is JAX's unchunked inv_chunks_crt
    assert np.array_equal(_integer_table(td.full["inv_crt"]),
                          _unchunk(jd.C["inv_chunks_crt"]))


@pytest.mark.parametrize("digit_bits,ndigits,log_q", [(32, 3, 80),
                                                      (40, 3, 96),
                                                      (64, 2, 120)])
def test_byte_decomp_planes_equals_jax(digit_bits, ndigits, log_q):
    rng = np.random.default_rng(digit_bits)
    n = (log_q + 16) // 16
    a = rng.integers(0, 1 << 16, size=(2, 9, n)).astype(np.int32)
    q_limbs = ints_to_limbs([1 << log_q], n + 1)[0]
    got = lb.byte_decomp_planes(torch.as_tensor(a), log_q, digit_bits,
                                ndigits, torch.as_tensor(q_limbs))
    want = jlimbs.byte_decomp_planes(jnp.asarray(a), log_q, digit_bits,
                                     ndigits, jnp.asarray(q_limbs))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_mod_p_bounded_equals_jax():
    """The cases of tests/test_large_p.py::test_mod_p_bounded_unit."""
    rng = np.random.default_rng(0)
    for p in [(1 << 20) + 7, (1 << 24) + 43, (1 << 30) - 35, 999999937]:
        K = 2000
        vals = [int(v) for v in rng.integers(-K * p, K * p, 256)]
        vals += [0, 1, -1, p, -p, K * p - 1, -(K * p) + 1, p - 1, -(p - 1)]
        y = ints_to_limbs(vals, 8)
        got = lb.mod_p_bounded(torch.as_tensor(y), p, 2048)
        assert got.dtype == torch.int32
        assert got.tolist() == [v % p for v in vals]
        want = jlimbs.mod_p_bounded(jnp.asarray(y), jnp.asarray(
            ints_to_limbs([p], 4)[0]), jnp.float32(p), 2048)
        assert np.array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="window"):
        lb.mod_p_bounded(torch.as_tensor(ints_to_limbs([0], 8)),
                         (1 << 30) - 35, 1 << 20)
