"""The matmul route of the Cooley-Tukey family (ops/ntt_ct_matmul.py):
the splits the tensor-core kernel cannot take, against fhe_si_tpu with
no tolerance.

The JAX package runs these splits through the XLA stage products of
fhe_si_tpu/ops/ntt_ct.py (its Pallas kernels take m = 2^k with
8 <= N2 <= N1 <= 128 only), so those are the reference.  The rings: m = 22
with use_ct forced (N = 11: 11 x 1), the reference's m = p - 1 at
p = 4127 (the smallest safe prime whose ring FheContext puts on the
Cooley-Tukey family: 2063 x 1), and m = 160 with use_ct forced (10 x 8,
two non-trivial stages) called directly on its tables.  The route on the
card: tests/test_torch_cuda.py and chip_smoke.py phase 11."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fhe_si_tpu import sampling
from fhe_si_tpu import scheme as jscheme
from fhe_si_tpu.context import FheContext as RefContext
from fhe_si_tpu.device import device_context
from fhe_si_tpu.hostmath import oracle
from fhe_si_tpu.ops import ntt_ct as jct
from fhe_si_tpu_torch import DeviceContext, FheContext, scheme
from fhe_si_tpu_torch.hostmath import numbth
from fhe_si_tpu_torch.ops import cuda_build, ntt, ntt_ct as tct, ntt_ct_cuda
from fhe_si_tpu_torch.ops import ntt_ct_matmul as route
from fhe_si_tpu_torch.ops import route_cuda

from test_torch_scheme_ops import run_scheme_parity

torch.set_num_threads(1)

xla_fwd = jax.jit(jct.ct_fwd, static_argnums=2)
xla_fwd_digits = jax.jit(jct.ct_fwd_digits, static_argnums=(2, 3))
xla_inv = jax.jit(jct.ct_inv, static_argnums=(2, 3))

M22 = dict(m=22, log_q=80, p=23, generator=7)        # forced: 11 x 1
M4126 = dict(m=4126, log_q=80, p=4127, generator=5)  # 2063 x 1
M160 = dict(m=160, log_q=80, p=641, generator=3)     # forced: 10 x 8


@functools.cache
def _pair(name):
    """Both packages' contexts and DeviceContexts (CPU) of a ring on the
    Cooley-Tukey family, use_ct forced where FheContext would pick the
    dense one; the JAX DeviceContext is the one its scheme uses."""
    kw = {"m22": M22, "m4126": M4126}[name]
    ref, ctx = RefContext(**kw), FheContext(**kw)
    if name == "m22":
        assert not ref.use_ct and not ctx.use_ct
        ref.use_ct = ctx.use_ct = True
    assert ref.use_ct and ctx.use_ct
    return ref, ctx, device_context(ref), DeviceContext(ctx, "cpu")


def _bases(td, jd):
    """(label, port basis, JAX basis): the full chain and both subsets."""
    out = [("full", td.full, jd.C)]
    for name in ("ksw", "lin"):
        assert jd.C[name] is not None
        out.append((name, getattr(td, name), jd.C[name]))
    return out


@pytest.mark.parametrize("split,takes", [
    ((11, 1), False), ((256, 128), False), ((4073, 1), False),
    ((128, 128), True), ((128, 80), True), ((81, 81), True), ((3, 3), True),
    ((2, 2), True), ((11, 2), True)])
def test_kernel_takes_agrees_with_check_kernel_shape(split, takes):
    """kernel_takes is check_kernel_shape's rule in both orientations,
    read on the host: a side of 1 and m = 2^16's layout past shared
    memory are refused, the kernel's splits taken."""
    N1, N2 = split
    meta = tct.CtMeta(N1, N2, N1 * N2, 1)
    assert ntt_ct_cuda.kernel_takes(meta) is takes

    def passes(S, R):
        try:
            ntt_ct_cuda.check_kernel_shape("ct_fwd", (1, N1 * N2), S, R)
        except ValueError:
            return False
        return True
    assert takes == (passes(N2, N1) and passes(N1, N2))
    # a card that allows less shared memory takes less
    assert not ntt_ct_cuda.kernel_takes(meta, limit=0)


@pytest.mark.parametrize("m,route_name", [
    (8192, "kernel"), (1 << 15, "kernel"), (20480, "kernel"),
    (13122, "kernel"), (1 << 16, "matmul"), (8146, "matmul"),
    (4126, "matmul"), (19582, "matmul"), (4 * 2053, "matmul")])
def test_route_is_chosen_from_the_split(m, route_name):
    """DeviceContext.ct_route follows kernel_takes on the split alone: the
    rings the kernel ran before keep it, and the reference's m = p - 1
    past p = 4079 (N x 1), m = 2^16 and m = 4 * 2053 (2053 x 2, past
    shared memory) take the route."""
    N1, N2 = tct._split(m // 2)
    meta = tct.CtMeta(N1, N2, m // 2, 1)
    assert ("kernel" if ntt_ct_cuda.kernel_takes(meta) else "matmul") \
        == route_name


@pytest.mark.parametrize("name", ["m22", "m4126"])
def test_route_matches_jax_on_every_basis(name):
    """Forward, 24-bit digits, raw and CRT inverse of the route equal the
    JAX package's XLA transforms on the same tables, on the full chain
    and both subset bases; the round trip is exact.  No kernel table is
    built, and the CUDA wrappers' counters do not move."""
    ref, ctx, jd, td = _pair(name)
    meta = td.ct_meta
    assert td.ct_route == "matmul" and meta.N2 == 1
    assert tuple(meta) == tuple(jd.ct_meta)
    rng = np.random.default_rng(ctx.m)
    cuda_build.reset_launches()
    route.reset_calls()
    route.reset_products()
    for label, T, JT in _bases(td, jd):
        assert not any(k.startswith("k_") for k in T["ct"]), label
        # the folded form: no 1 x 1 stage operands are kept
        assert {"tw_t2", "twi_t2i", "twi_t2i_crt"} <= set(T["ct"]), label
        assert not {"t2", "t2i", "t2_digits", "tw"} & set(T["ct"]), label
        q = T["primes_np"]
        x = rng.integers(0, q[:, None], (3, len(q), ctx.phim)).astype(np.int32)
        ev = route.ct_fwd(T["ct"], torch.from_numpy(x), meta)
        assert np.array_equal(ev.numpy(), np.asarray(
            xla_fwd(JT["ct"], jnp.asarray(x), jd.ct_meta))), label
        for key in ("t2i", "t2i_crt"):
            got = route.ct_inv(T["ct"], ev, meta, key)
            assert np.array_equal(got.numpy(), np.asarray(xla_inv(
                JT["ct"], jnp.asarray(ev.numpy()), jd.ct_meta, key))), \
                (label, key)
        assert torch.equal(route.ct_inv(T["ct"], ev, meta),
                           torch.from_numpy(x)), label
        d = rng.integers(0, 1 << 24, (2, ctx.phim)).astype(np.int32)
        got = route.ct_fwd_digits(T["ct"], torch.from_numpy(d), meta, 24)
        assert np.array_equal(got.numpy(), np.asarray(xla_fwd_digits(
            JT["ct"], jnp.asarray(d), jd.ct_meta, 24))), label
    assert route.CALLS == {"ct_fwd": 3, "ct_fwd_digits": 3, "ct_inv": 9}
    assert route.PRODUCTS == route.CALLS     # one GEMM a transform
    assert not any(cuda_build.LAUNCHES.values())


def test_route_takes_two_stage_splits_m160():
    """m = 160 with use_ct forced (10 x 8, two non-trivial stages and the
    mixed-radix pad, drop, insert and fold), the route called directly
    on operands made from the tables: equal to JAX's XLA transforms, a
    CRT premultiplier folded into t2i_crt included."""
    primes = [q for q in range(161, 1 << 20, 160) if numbth.is_prime(q)][-3:]
    roots = [numbth.find_element_of_order(q, 160) for q in primes]
    jt = jct.CtNttTables(160, primes, roots)
    meta, ct = tct.ct_tables(160, primes, roots)
    assert tuple(meta) == tuple(jt.meta) == (10, 8, 64, 5)
    binv = np.array([3, 5, 7])
    ct = tct.with_crt_premultiplier(ct, binv)
    T = route.stage_operands(ct, max(primes), "cpu")
    assert "tw_t2" not in T and {"t2", "t2_digits", "tw", "twi"} <= set(T)
    JT = jt.pack()
    rng = np.random.default_rng(160)
    route.reset_calls()
    route.reset_products()
    x = rng.integers(0, np.array(primes)[:, None], (2, 3, 3, 64)).astype(
        np.int32)
    ev = route.ct_fwd(T, torch.from_numpy(x), meta)
    assert np.array_equal(ev.numpy(), np.asarray(
        xla_fwd(JT, jnp.asarray(x), jt.meta)))
    assert np.array_equal(route.ct_inv(T, ev, meta).numpy(), np.asarray(
        xla_inv(JT, jnp.asarray(ev.numpy()), jt.meta, "t2i")))
    assert torch.equal(route.ct_inv(T, ev, meta), torch.from_numpy(x))
    # t2i_crt: the raw inverse times binv mod q
    q = np.array(primes, np.int64)[:, None]
    want = route.ct_inv(T, ev, meta).numpy().astype(np.int64) * binv[:, None]
    want %= q
    assert np.array_equal(route.ct_inv(T, ev, meta, "t2i_crt").numpy(), want)
    d = rng.integers(0, 1 << 24, (5, 64)).astype(np.int32)
    assert np.array_equal(
        route.ct_fwd_digits(T, torch.from_numpy(d), meta, 24).numpy(),
        np.asarray(xla_fwd_digits(JT, jnp.asarray(d), jt.meta, 24)))
    assert route.CALLS == {"ct_fwd": 1, "ct_fwd_digits": 1, "ct_inv": 4}
    assert route.PRODUCTS == {k: 2 * n for k, n in route.CALLS.items()}
    with pytest.raises(NotImplementedError, match="digit radix"):
        route.ct_fwd_digits(T, torch.from_numpy(d), meta, 25)


@pytest.mark.parametrize("n_in,q_max,y_max,split", [
    (4073, (1 << 20) - 1, None, False),       # p = 8147, narrow residues
    (1, (1 << 20) - 1, route.DIGIT_MAX, False),   # its digit stage, k = N2
    (128, (1 << 23) - 1, None, False),        # m = 2^16, stage over N2
    (256, (1 << 23) - 1, None, True),         # ... and over N1
    (128, (1 << 23) - 1, route.DIGIT_MAX, True),  # its digit stage
    (8193, (1 << 20) - 1, None, True)])
def test_stage_split_follows_the_chain_bound(n_in, q_max, y_max, split):
    """ntt.needs_split decides a stage's 12-bit split from the chain's
    bound n_in * y_max * (q_max - 1) < 2^53, and operands follow it."""
    assert ntt.needs_split(n_in, q_max, y_max) is split
    tab = np.full((1, 2, n_in), q_max - 1, np.int64)
    assert len(ntt.operands(tab, q_max, y_max)) == 1 + split


@pytest.mark.parametrize("m,p,g", [(22, 23, 7), (4126, 4127, 5)])
def test_folded_tables_equal_numpy_products(m, p, g):
    """stage_operands on a split N x 1 keeps no 1 x 1 stage: its folded
    twiddles equal tw * t2, twi * t2i and twi * t2i_crt mod q, computed
    here in Python integers, each beside its Shoup quotient
    floor(w * 2^32 / q), on the context's tables and on the same tables
    with random residues in place of the 1 x 1 stages (on the rings
    m = p - 1 t2 is 1 and t2i is 1/N, so the fold is not an identity
    only there)."""
    ctx = FheContext(m=m, log_q=80, p=p, generator=g)
    meta, ct = tct.ct_tables(m, ctx.primes, ctx.roots)
    assert (meta.N2, meta.q_odd, meta.phim) == (1, meta.N, meta.N - 1)
    ct = tct.with_crt_premultiplier(ct, ctx.fast_crt_tables["binv"])
    q = [int(v) for v in ct["q"]]
    rng = np.random.default_rng(m)
    shuffled = dict(ct, **{k: rng.integers(
        0, np.array(q)[:, None, None], (len(q), 1, 1)).astype(np.int32)
        for k in ("t2", "t2i", "t2i_crt")})
    for tabs in (ct, shuffled):
        T = route.stage_operands(tabs, max(q), "cpu")
        assert not {"t2", "t2i", "t2i_crt", "t2_digits", "tw", "twi"} \
            & set(T)
        for key, tw, one in (("tw_t2", "tw", "t2"), ("twi_t2i", "twi", "t2i"),
                             ("twi_t2i_crt", "twi", "t2i_crt")):
            got = T[key].numpy()
            assert got.shape == (2, len(q), meta.N) and got.dtype == np.int32
            for l, ql in enumerate(q):
                want = [int(w) * int(tabs[one][l, 0, 0]) % ql
                        for w in tabs[tw][l, :, 0]]
                assert got[0, l].tolist() == want, (key, l)
                assert got[1, l].view(np.uint32).tolist() == [
                    (w << 32) // ql for w in want], (key, l)


def test_folded_plain_boundaries_at_their_edges():
    """route_cuda's plain enter and leave (what the CPU runs and the
    card's kernels are held to) against Python integers at m = 4126
    (2063 x 1): residues at q - 1, digits at 2^24 - 1, GEMM outputs up to
    N (q - 1)^2, the padded column, the excluded evaluation u0 and the
    fold's signs."""
    ctx = FheContext(**M4126)
    meta, ct = tct.ct_tables(ctx.m, ctx.primes, ctx.roots)
    q = np.asarray(ct["q"], np.int64)
    L, N, phim, u0 = len(q), meta.N, meta.phim, meta.u0
    tw = route_cuda.folded_table(ct["tw"][..., 0], ct["t2"][:, 0, 0], q)
    twi = route_cuda.folded_table(ct["twi"][..., 0], ct["t2i"][:, 0, 0], q)
    qt = torch.from_numpy(q.astype(np.int32)[:, None])
    rng = np.random.default_rng(4126)
    R = 3
    x = rng.integers(0, q[:, None], (R, L, phim))
    x[0] = q[:, None] - 1
    d = rng.integers(0, 1 << 24, (R, phim))
    d[0] = (1 << 24) - 1
    y = route_cuda.enter_plain(torch.from_numpy(x.astype(np.int32)),
                               torch.from_numpy(tw), qt, meta, "fwd").numpy()
    assert y.dtype == np.float64 and y.shape == (R, L, N)
    assert np.array_equal(y[..., :phim], x * tw[0][:, :phim] % q[:, None])
    assert not y[..., phim:].any()
    y = route_cuda.enter_plain(torch.from_numpy(d.astype(np.int32)),
                               torch.from_numpy(tw), qt, meta,
                               "fwd_digits").numpy()
    assert np.array_equal(y[..., :phim],
                          d[:, None, :] * tw[0][:, :phim] % q[:, None])
    assert not y[..., phim:].any()
    y = route_cuda.enter_plain(torch.from_numpy(x.astype(np.int32)), None,
                               qt, meta, "inv").numpy()
    assert np.array_equal(np.delete(y, u0, axis=-1), x)
    assert not y[..., u0].any()
    # GEMM outputs [L, N, R]: random below N (q - 1)^2, row 0 at the top
    top = N * (q - 1) ** 2
    assert top.max() < 1 << 53
    z = (rng.random((L, N, R)) * top[:, None, None]).astype(np.int64)
    z[..., 0] = top[:, None]
    zr = np.transpose(z % q[:, None, None], (2, 0, 1))      # [R, L, N]
    got = route_cuda.leave_plain(torch.from_numpy(z.astype(np.float64)),
                                 None, qt, meta, "fwd").numpy()
    assert np.array_equal(got, np.delete(zr, u0, axis=-1))
    got = route_cuda.leave_plain(torch.from_numpy(z.astype(np.float64)),
                                 torch.from_numpy(twi), qt, meta,
                                 "inv").numpy()
    w = zr * twi[0] % q[:, None]
    sign = np.where(np.arange(phim) % 2 == 0, -1, 1)
    assert np.array_equal(got, (w[..., :phim] + sign * w[..., phim:])
                          % q[:, None])


@pytest.mark.parametrize("q", [2, 3, 11, 4127 * 2 + 1, 786433, 1032193,
                               (1 << 20) - 3, 8257537, (1 << 23) - 15])
def test_route_kernel_arithmetic_model(q):
    """csrc/route.cu's two reductions, modelled in numpy at their widths:
    leave's float64 v mod q (t = floor(v * fl(1/q)), r = v - t q, which
    the kernel's fma computes exactly) lands in [-q, 2q) before its one
    correction each way, for GEMM outputs over [0, 2^53) (the extremes,
    multiples of q and their neighbours among them); enter's and leave's
    Shoup product of x < 2^32 by w < q lands in [0, 2q) before its one
    subtraction."""
    rng = np.random.default_rng(q)
    v = rng.integers(0, 1 << 53, 20000, dtype=np.int64)
    k = rng.integers(0, (1 << 53) // q, 2000, dtype=np.int64)
    v = np.concatenate([v, k * q, k * q + 1, k * q - 1,
                        [0, 1, (1 << 53) - 1, (1 << 53) - 2,
                         (1 << 53) // q * q]])
    v = v[(v >= 0) & (v < 1 << 53)]
    t = np.floor(v.astype(np.float64) * (1.0 / q)).astype(np.int64)
    r = v - t * q
    assert r.min() >= -q and r.max() < 2 * q
    r = np.where(r < 0, r + q, r)
    r = np.where(r >= q, r - q, r)
    assert np.array_equal(r, v % q)
    x = np.concatenate([rng.integers(0, 1 << 32, 5000, dtype=np.uint64),
                        np.array([0, (1 << 24) - 1, q - 1, (1 << 32) - 1],
                                 np.uint64)])
    w = rng.integers(0, q, x.size, dtype=np.uint64)
    w[:3] = q - 1
    ws = (w << np.uint64(32)) // np.uint64(q)
    qhat = (x * ws) >> np.uint64(32)            # umulhi: x, ws < 2^32
    got = (x * w - qhat * np.uint64(q)) & np.uint64(0xFFFFFFFF)
    assert got.max() < 2 * q
    got = np.where(got >= q, got - np.uint64(q), got)
    assert np.array_equal(got, x * w % np.uint64(q))


# the route cell's step at batch 64 (m = 8146: N = 4073, phim 4072; 23
# primes, 13 on the keyswitch basis, 8 digits): (enter mode, rows, L, GB
# both boundary kernels move, rounded as the route's byte table gives it)
ROUTE_CELL_BYTES = [("fwd", 256, 23, 0.58), ("fwd_digits", 1536, 13, 1.65),
                    ("inv", 192, 23, 0.43), ("inv", 128, 13, 0.16)]


@pytest.mark.parametrize("mode,rows,L,gb", ROUTE_CELL_BYTES)
def test_route_boundary_bounds_count_the_cell_bytes(mode, rows, L, gb):
    """chip_smoke.route_boundary_bound, the boundary kernels' yardstick
    (the benchmark has none), counts each operand once: 4 B an int32
    residue in and out (the digits once for every prime), 8 B the
    float64 GEMM operand written and its output read, over 3.35 TB/s."""
    import chip_smoke
    N, phim = 4073, 4072
    n_in = rows * phim if mode == "fwd_digits" else rows * L * phim
    want = {"route_enter": 4 * n_in + 8 * rows * L * N,
            "route_leave": 8 * rows * L * N + 4 * rows * L * phim}
    for kernel, nbytes in want.items():
        ms, by = chip_smoke.route_boundary_bound(kernel, mode, rows, L, phim,
                                                N)
        assert by == "bytes"
        assert ms * 3.35e9 == pytest.approx(nbytes, rel=1e-12)
    assert round(sum(want.values()) / 1e9, 2) == gb


def test_route_boundary_bounds_sum_to_the_cell_bound():
    """The four transforms' boundary bytes: about 2.8 GB, 0.84 ms a call."""
    import chip_smoke
    ms = sum(chip_smoke.route_boundary_bound(k, mode, rows, L, 4072, 4073)[0]
             for mode, rows, L, _ in ROUTE_CELL_BYTES
             for k in ("route_enter", "route_leave"))
    assert round(ms, 2) == 0.84


def test_forced_route_on_a_power_of_two_ring(monkeypatch):
    """A DeviceContext whose split the kernel rule refuses rides the
    route whatever its shape: m = 256 (16 x 8) on the route equals the
    kernel route's plain versions on every basis, and the
    coefficient-sharded path reads integer tables on either route."""
    from fhe_si_tpu_torch.parallel import shard
    ctx = FheContext(m=256, log_q=80, p=257, generator=3)
    plain = DeviceContext(ctx, "cpu")
    monkeypatch.setattr(ntt_ct_cuda, "kernel_takes", lambda meta: False)
    dc = DeviceContext(ctx, "cpu")
    assert plain.ct_route == "kernel" and dc.ct_route == "matmul"
    rng = np.random.default_rng(256)
    for basis in ("full", "ksw", "lin"):
        T, P = getattr(dc, basis), getattr(plain, basis)
        x = torch.from_numpy(rng.integers(
            0, T["primes_np"][:, None], (2, len(T["primes_np"]), 128)).astype(
                np.int32))
        assert torch.equal(dc._fwd_t(T, x), plain._fwd_t(P, x))
        assert torch.equal(dc._inv_crt_t(T, x), plain._inv_crt_t(P, x))
    x = torch.from_numpy(rng.integers(0, ctx.primes[:, None], (2, dc.L, 128))
                         .astype(np.int32))
    assert torch.equal(dc.ntt_inv(x), plain.ntt_inv(x))
    ints, kernel_ints = shard._ct_int_tables(dc), plain.full["ct"]
    for k in ("q", "t1", "t2", "t1i", "t2i", "t2i_crt", "tw", "twi"):
        assert torch.equal(ints[k], kernel_ints[k]), k


def test_m22_forced_scheme_matches_jax_and_oracle():
    """keygen, relinearization key, encrypt, mul+relin and decrypt at
    m = 22 with use_ct forced equal the JAX package's tensors on the same
    draws and the oracle; the port ran the route and launched nothing.
    Then the oracle circuit (automorph and rotation included)."""
    ref, ctx, jd, td = _pair("m22")
    out = []
    route.reset_calls()
    cuda_build.reset_launches()
    for sch, c, dev in ((jscheme, ref, ref), (scheme, ctx, td)):
        src = sampling.RandomSource(22)
        sk, pk = sch.keygen(dev, src)
        ksw = sch.KeySwitch.for_relinearization(sk, src)
        msgs = [src.uniform_mod_p(c.phim, c.p) for _ in range(2)]
        cts = [pk.encrypt(sch.Plaintext(c, mm), src) for mm in msgs]
        prod = ksw.apply(cts[0] * cts[1])
        out.append((np.asarray(pk.pk_limbs), np.asarray(sk.sk_evals),
                    np.asarray(ksw.matrix_evals),
                    [ct.to_python_parts() for ct in cts],
                    prod.to_python_parts(), list(sk.decrypt(prod).message)))
        want = list(oracle.plaintext_mul(c, *msgs))
    (jpk, jsk, jm, jcts, jprod, jdec), (tpk, tsk, tm, tcts, tprod, tdec) = out
    assert np.array_equal(jpk, tpk) and np.array_equal(jsk, tsk)
    assert np.array_equal(jm, tm)
    assert jcts == tcts and jprod == tprod
    assert jdec == tdec == want
    assert td.ct_route == "matmul" and all(route.CALLS.values())
    assert not any(cuda_build.LAUNCHES.values())
    run_scheme_parity(ctx, seed=22)


def test_m4126_scheme_matches_jax():
    """The lean scheme round at p = 4127 (m = 4126, 2063 x 1): keys, two
    ciphertexts and their relinearized product equal the JAX package's
    on the same draws, and the product decrypts to the oracle's."""
    ref, ctx, jd, td = _pair("m4126")
    out = []
    for sch, c, dev in ((jscheme, ref, ref), (scheme, ctx, td)):
        src = sampling.RandomSource(4126)
        sk, pk = sch.keygen(dev, src)
        ksw = sch.KeySwitch.for_relinearization(sk, src)
        msgs = [src.uniform_mod_p(c.phim, c.p) for _ in range(2)]
        cts = pk.encrypt_batch([sch.Plaintext(c, mm) for mm in msgs], src)
        prod = sch.relin_batch(sch.mul_batch([(cts[0], cts[1])]), ksw)[0]
        out.append((np.asarray(pk.pk_limbs), np.asarray(ksw.matrix_evals),
                    np.stack([np.asarray(ct.parts) for ct in cts]),
                    np.asarray(prod.parts), sk.decrypt(prod).message))
    for j, t in zip(*out):
        assert np.array_equal(j, t)
    assert np.array_equal(out[1][-1], oracle.plaintext_mul(ref, *msgs))
