"""The evaluation-domain kernels of fhe_si_tpu_torch/csrc/modular.cu on
the CPU.

Two halves, both exact (integers, no tolerance):
  - both wrappers of ops/modular_cuda.py take their plain versions on CPU
    tensors; each is held equal to the JAX package on numpy-seeded
    canonical residues, at m = 32 and 256 on both residue lanes
    (prime_bits = 23 forces the wide one), on the full and the keyswitch
    bases: tensor_product against fhe_si_tpu/device.py _tensor_mul on the
    same lifted inputs (the two halves of one lift, and two lifts) and
    against the JAX package's mod_mul / mod_add on each basis' rows, with
    (2, 2) and (3, 2) parts; keyswitch_dot against
    fhe_si_tpu.ops.modular.mod_dot with the same axis=-3 broadcast;
  - a numpy model of each kernel's per-element arithmetic at the kernel's
    own integer widths (uint64 products and sums, __umul64hi, the 64-bit
    Barrett reduction) reading the kernel's own table layout
    (modular_cuda.kernel_table), held equal to the plain versions on
    worst-case inputs: every residue q - 1, primes just below 2^20 and
    2^23, K at MAX_TERMS and na = nb at MAX_PARTS, where it asserts every
    bound the modular.cu header states.
The kernels themselves run only on a card (tests/test_torch_cuda.py,
chip_smoke.py phase 3).
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fhe_si_tpu.context import FheContext as RefContext
from fhe_si_tpu.device import device_context
from fhe_si_tpu.ops import modular as jmod
from fhe_si_tpu_torch import DeviceContext, FheContext
from fhe_si_tpu_torch.context import MAX_KSW_PARTS
from fhe_si_tpu_torch.hostmath import numbth
from fhe_si_tpu_torch.ops import modular_cuda
from fhe_si_tpu_torch.ops.modular_cuda import MAX_PARTS, MAX_TERMS

torch.set_num_threads(1)

CONFIGS = [pytest.param((32, 97, None), id="m32"),
           pytest.param((256, 257, None), id="m256"),
           pytest.param((32, 97, 23), id="m32-wide"),
           pytest.param((256, 257, 23), id="m256-wide")]
BASES = ["full", "ksw"]
PARTS = [pytest.param((2, 2), id="2x2"), pytest.param((3, 2), id="3x2")]
U64 = np.uint64
M32 = U64((1 << 32) - 1)


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
             "ksw": (td.ksw, jd._ksw_tables(jd.C))}[basis]
    return td, T, JT


def _eq(want, got):
    want, got = np.asarray(want), got.numpy()
    assert want.dtype == got.dtype and want.shape == got.shape
    assert np.array_equal(want, got)


def _canonical(rng, primes, lead, phim):
    """Canonical residues [*lead, L, phim] of `primes`, int32, with the
    first row along the first lead axis all q - 1."""
    q = np.asarray(primes, np.int64)[:, None]
    x = rng.integers(0, q, size=tuple(lead) + (len(q), phim))
    x[0] = q - 1
    return x.astype(np.int32)


# ------------------------------------------------------ against the JAX package
@pytest.mark.parametrize("parts", PARTS)
@pytest.mark.parametrize("cfg", CONFIGS)
def test_tensor_product_equals_jax_tensor_mul(cfg, parts):
    """The wrapper on the port's lift of the same limbs, as the two halves
    of one lift and as two lifts, equals the JAX package's _tensor_mul
    (fhe_si_tpu/device.py:558-582); so does DeviceContext._tensor_mul,
    which calls it."""
    jd, td = _devices(*cfg)
    na, nb = parts
    rng = np.random.default_rng(21)
    a = rng.integers(0, 1 << 16, size=(2, na, td.phim, td.n_ct))
    b = rng.integers(0, 1 << 16, size=(2, nb, td.phim, td.n_ct))
    a[0, 0] = 0xFFFF                                   # the value -1
    a, b = a.astype(np.int32), b.astype(np.int32)
    want = jd._tensor_mul(jd.C, jnp.asarray(a), jnp.asarray(b))
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    ev = td.from_poly(torch.cat([at, bt], dim=-3))
    for a_ev, b_ev in ((ev[..., :na, :, :], ev[..., na:, :, :]),
                       (td.from_poly(at), td.from_poly(bt))):
        _eq(want, modular_cuda.tensor_product(a_ev, b_ev, td.full, td.wide))
    _eq(want, td._tensor_mul(at, bt))


@pytest.mark.parametrize("parts", PARTS)
@pytest.mark.parametrize("basis", BASES)
@pytest.mark.parametrize("cfg", CONFIGS)
def test_tensor_product_equals_jax_on_basis(cfg, basis, parts):
    """On each basis' rows: the JAX package's _tensor_mul arithmetic
    (mod_mul by p mod q, the part products, mod_add) with that basis' q."""
    td, T, JT = _tables(cfg, basis)
    na, nb = parts
    primes = T["primes_np"]
    rng = np.random.default_rng(22)
    a = _canonical(rng, primes, (2, na), td.phim)
    b = _canonical(rng, primes, (2, nb), td.phim)
    q, qi = JT["q"], JT["qinv_f"]
    pq = jnp.asarray((td.p % primes)[:, None].astype(np.int32))
    aj = jmod.mod_mul(jnp.asarray(a), pq, q, qi, td.wide)
    bj = jnp.asarray(b)
    out = [None] * (na + nb - 1)
    for i in range(na):
        for j in range(nb):
            pr = jmod.mod_mul(aj[:, i], bj[:, j], q, qi, td.wide)
            out[i + j] = pr if out[i + j] is None else jmod.mod_add(
                out[i + j], pr, q)
    _eq(jnp.stack(out, axis=1), modular_cuda.tensor_product(
        torch.from_numpy(a), torch.from_numpy(b), T, td.wide))


@pytest.mark.parametrize("terms", ["2nd", "3nd"])
@pytest.mark.parametrize("basis", BASES)
@pytest.mark.parametrize("cfg", CONFIGS)
def test_keyswitch_dot_equals_jax(cfg, basis, terms):
    """keyswitch_dot against fhe_si_tpu.ops.modular.mod_dot with the
    matrix broadcast over a [2, 3] lead shape, as _keyswitch_digits calls
    it, at K = 2 and 3 times ndigits (an automorph's and a
    relinearization's keyswitch)."""
    td, T, JT = _tables(cfg, basis)
    K = int(terms[0]) * td.ndigits
    primes = T["primes_np"]
    rng = np.random.default_rng(23)
    mat = _canonical(rng, primes, (2, K), td.phim)
    dig = _canonical(rng, primes, (2, 3, K), td.phim)
    want = jmod.mod_dot(jnp.asarray(mat), jnp.asarray(dig)[..., None, :, :, :],
                        JT["q"], JT["qinv_f"], axis=-3, wide=td.wide)
    _eq(want, modular_cuda.keyswitch_dot(torch.from_numpy(mat),
                                         torch.from_numpy(dig), T, td.wide))


# ------------------------------------------------------ the kernels' model
def _rows(tab):
    """q, p mod q and mu = floor(2^64 / q) per row of the kernel table,
    uint64 [L, 1] each."""
    w = tab.view(np.uint32).astype(U64)
    return w[:, 0:1], w[:, 1:2], w[:, 2:3] | (w[:, 3:4] << U64(32))


def _umul64hi(x, y):
    """__umul64hi: floor(x y / 2^64) of uint64 arrays, from 32-bit halves
    (every partial product and the middle sum stay below 2^64)."""
    x0, x1, y0, y1 = x & M32, x >> U64(32), y & M32, y >> U64(32)
    ll, hl, lh, hh = x0 * y0, x1 * y0, x0 * y1, x1 * y1
    mid = (ll >> U64(32)) + (hl & M32) + lh
    return hh + (hl >> U64(32)) + (mid >> U64(32))


def _reduce(x, q, mu):
    """modular.cu reduce: x - umulhi(x, mu) q, asserted in [0, 2q) (the
    header's bound), then one conditional subtraction."""
    r = x - _umul64hi(x, mu) * q               # mod 2^64, as in the kernel
    assert (r < U64(2) * q).all() and (r < U64(1 << 24)).all()
    return np.where(r >= q, r - q, r)


def model_tensor_product(tab, a, b):
    """tensor_product_kernel for every element at once: a [R, na, L,
    phim], b [R, nb, L, phim] -> [R, na+nb-1, L, phim], the parts held
    in arrays of MAX_PARTS, zero past na and nb."""
    q, pq, mu = _rows(tab)
    R, na, L, phim = a.shape
    nb = b.shape[1]
    zero = np.zeros((R, L, phim), U64)
    av, bv = [zero] * MAX_PARTS, [zero] * MAX_PARTS
    for i in range(na):
        prod = a[:, i].astype(U64) * pq
        assert (prod < U64(1 << 46)).all()
        av[i] = _reduce(prod, q, mu)
    for j in range(nb):
        bv[j] = b[:, j].astype(U64)
    out = []
    for k in range(na + nb - 1):
        acc = zero
        for i in range(MAX_PARTS):
            if 0 <= k - i < MAX_PARTS:
                prod = av[i] * bv[k - i]
                assert (prod < U64(1 << 46)).all()
                acc = acc + prod
        assert (acc < U64(1 << 48)).all()
        out.append(_reduce(acc, q, mu))
    return np.stack(out, axis=1).astype(np.int32)


def model_keyswitch_dot(tab, mat, dig):
    """keyswitch_dot_kernel for every element at once: mat [2, K, L,
    phim], dig [R, K, L, phim] -> [R, 2, L, phim], two uint64 sums."""
    q, _, mu = _rows(tab)
    K = mat.shape[1]
    out = []
    for j in range(2):
        acc = np.zeros((dig.shape[0],) + mat.shape[2:], U64)
        for k in range(K):
            prod = dig[:, k].astype(U64) * mat[j, k].astype(U64)
            assert (prod < U64(1 << 46)).all()
            acc = acc + prod
        assert (acc < U64(1 << 55)).all()
        out.append(_reduce(acc, q, mu))
    return np.stack(out, axis=1).astype(np.int32)


def _hold_model(tab, primes, wide, parts=None, K=None, phim=16, lead=3):
    """The model against the plain versions on canonical residues of
    `primes` with the first lead index all q - 1."""
    rng = np.random.default_rng(24)
    q = np.asarray(primes, np.int64)
    T = dict(q=torch.from_numpy(q[:, None].astype(np.int32)),
             qinv_f=torch.from_numpy((1.0 / q[:, None]).astype(np.float32)),
             p_mod_q=torch.from_numpy(tab.view(np.uint32)[:, 1:2].astype(
                 np.int32)),
             k_mod=torch.from_numpy(tab))
    if parts is not None:
        a = _canonical(rng, q, (lead, parts[0]), phim)
        b = _canonical(rng, q, (lead, parts[1]), phim)
        want = modular_cuda.tensor_product(torch.from_numpy(a),
                                           torch.from_numpy(b), T, wide)
        assert np.array_equal(model_tensor_product(tab, a, b), want.numpy())
        return
    mat = _canonical(rng, q, (2, K), phim)
    dig = _canonical(rng, q, (lead, K), phim)
    want = modular_cuda.keyswitch_dot(torch.from_numpy(mat),
                                      torch.from_numpy(dig), T, wide)
    assert np.array_equal(model_keyswitch_dot(tab, mat, dig), want.numpy())


@pytest.mark.parametrize("kernel", ["tensor_product", "keyswitch_dot"])
@pytest.mark.parametrize("basis", BASES)
@pytest.mark.parametrize("cfg", CONFIGS)
def test_kernel_model_equals_plain(cfg, basis, kernel):
    """The model on the port's own tables (DeviceContext's k_mod) at the
    main path's part and term counts."""
    td, T, _ = _tables(cfg, basis)
    tab = T["k_mod"].numpy()
    if kernel == "tensor_product":
        _hold_model(tab, T["primes_np"], td.wide, parts=(2, 2), phim=td.phim)
    else:
        _hold_model(tab, T["primes_np"], td.wide, K=3 * td.ndigits,
                    phim=td.phim)


def _primes_below(bound, count):
    out, q = [], bound - 1
    while len(out) < count:
        if numbth.is_prime(q):
            out.append(q)
        q -= 1
    return out


@pytest.mark.parametrize("case", [
    pytest.param(dict(parts=(MAX_PARTS, MAX_PARTS)), id="parts-4x4"),
    pytest.param(dict(parts=(3, 2)), id="parts-3x2"),
    pytest.param(dict(parts=(1, MAX_PARTS)), id="parts-1x4"),
    pytest.param(dict(K=MAX_TERMS), id="terms-384"),
    pytest.param(dict(K=1), id="terms-1")])
@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_kernel_model_at_its_limits(wide, case):
    """Synthetic bases of the three largest primes below 2^20 (narrow) and
    2^23 (wide), every residue of the first lead index q - 1, na = nb at
    MAX_PARTS and K at MAX_TERMS: the model's asserts check the modular.cu
    header's bounds, and it equals the plain versions."""
    primes = _primes_below(1 << (23 if wide else 20), 3)
    tab = modular_cuda.kernel_table(np.array(primes), 40961)
    _hold_model(tab, primes, wide, **case)


# ------------------------------------------------------ tables and host checks
@pytest.mark.parametrize("cfg", CONFIGS)
def test_kernel_table_layout(cfg):
    """kernel_table's words per row: q, p mod q, floor(2^64 / q) low and
    high; every basis of a DeviceContext carries its own, and p_mod_q."""
    td = _devices(*cfg)[1]
    for T in (td.full, td.ksw, td.lin):
        primes = T["primes_np"]
        w = T["k_mod"].numpy().view(np.uint32).astype(np.int64)
        assert T["k_mod"].dtype == torch.int32 and T["k_mod"].is_contiguous()
        assert w.shape == (len(primes), modular_cuda.ROW_WORDS)
        for row, q in zip(w, primes.tolist()):
            assert list(row) == [q, td.p % q, ((1 << 64) // q) & 0xFFFFFFFF,
                                 (1 << 64) // q >> 32]
        assert np.array_equal(T["p_mod_q"].numpy()[:, 0], td.p % primes)


@pytest.mark.parametrize("cfg", CONFIGS)
def test_context_bases_the_kernels_take(cfg):
    """Every basis passes the host check that DeviceContext runs on a CUDA
    device, the keyswitch width MAX_KSW_PARTS * ndigits included."""
    td = _devices(*cfg)[1]
    for T in (td.full, td.ksw, td.lin):
        modular_cuda.check_shape("tensor_product", T["q"].shape,
                                 T["primes_np"])
    modular_cuda.check_shape("keyswitch_dot", td.ksw["q"].shape,
                             td.ksw["primes_np"], MAX_KSW_PARTS * td.ndigits)


def test_most_digits_within_max_terms():
    """MAX_TERMS covers the widest keyswitch of any context the limb/CRT
    kernels take: the largest logQ whose reconstruction fits 48 limbs, in
    8-bit digits (decompSize 1)."""
    ctx = FheContext(m=256, log_q=336, p=257, generator=3, decomp_size=1)
    wider = FheContext(m=256, log_q=338, p=257, generator=3, decomp_size=1)
    assert ctx.n_limbs == 48 < wider.n_limbs
    assert MAX_KSW_PARTS * ctx.ndigits <= MAX_TERMS
    assert ctx.log_q < 16 * 48


def _operand(shape, L=3, phim=8):
    return torch.zeros(shape + (L, phim), dtype=torch.int32)


_TAB = dict(k_mod=torch.zeros((3, modular_cuda.ROW_WORDS), dtype=torch.int32))


@pytest.mark.parametrize("case", [
    pytest.param(("tp", (2, 5), (2, 2), _TAB, "1 to 4 parts"), id="5-parts"),
    pytest.param(("tp", (2, 2), (3, 2), _TAB, "lead"), id="lead-shapes"),
    pytest.param(("tp", (2, 0), (2, 2), _TAB, "1 to 4 parts"), id="0-parts"),
    pytest.param(("tp", (2, 2), (2, 2), {}, "k_mod"), id="no-table"),
    pytest.param(("tp", (2, 2), (2, 2), dict(k_mod=torch.zeros(
        (4, 4), dtype=torch.int32)), "k_mod for 3 rows"), id="table-rows"),
    pytest.param(("dot", (2, MAX_TERMS + 1), (5, MAX_TERMS + 1), _TAB,
                  "at most 384"), id="385-terms"),
    pytest.param(("dot", (2, 0), (5, 0), _TAB, "at most 384"), id="0-terms"),
    pytest.param(("dot", (3, 4), (5, 4), _TAB, r"\[2, K"), id="3-rows"),
    pytest.param(("dot", (2, 4), (5, 3), _TAB, r"\[2, K"), id="K-differs"),
    pytest.param(("dot", (2, 4), (5, 4), {}, "k_mod"), id="dot-no-table")])
def test_operands_the_kernels_refuse(case):
    """The host checks each wrapper runs on a CUDA tensor before the
    launch raise, with the shapes, on what the kernels do not take."""
    kind, sa, sb, T, match = case
    fn = (modular_cuda.tensor_product_operands if kind == "tp"
          else modular_cuda.keyswitch_dot_operands)
    with pytest.raises(ValueError, match=match):
        fn(_operand(sa), _operand(sb), T)


@pytest.mark.parametrize("primes,terms,match", [
    ([1, 97], None, "primes"), ([97, 1 << 23], None, "primes"),
    ([97, (1 << 23) - 15], MAX_TERMS + 1, "at most 384"),
    ([97], 0, "at most 384")])
def test_check_shape_refuses(primes, terms, match):
    with pytest.raises(ValueError, match=match):
        modular_cuda.check_shape("keyswitch_dot", (2, 7), np.array(primes),
                                 terms)


def test_tensor_product_reads_views_in_place():
    """The two halves of one lifted tensor reach the kernel as views (no
    copy), their parts at a stride of one [L, phim] block and the lead at
    (na + nb) blocks; a lead layout that does not flatten is copied."""
    L, phim = 3, 8
    ev = torch.arange(2 * 3 * 4 * L * phim, dtype=torch.int32).reshape(
        2, 3, 4, L, phim)
    a, b = ev[..., :2, :, :], ev[..., 2:, :, :]
    a2, sa, b2, sb, _, shape = modular_cuda.tensor_product_operands(a, b, _TAB)
    assert shape == (2, 3, 3, L, phim)
    assert a2.data_ptr() == ev.data_ptr()
    assert b2.data_ptr() == ev.data_ptr() + 4 * 2 * L * phim
    assert sa == sb == 4 * L * phim
    for x2, x in ((a2, a), (b2, b)):
        assert x2.stride()[1:] == (L * phim, phim, 1)
        assert torch.equal(x2, x.reshape(6, 2, L, phim))
    t = ev.transpose(0, 1)[..., :2, :, :]            # lead (3, 2): no flat view
    t2, st, *_ = modular_cuda.tensor_product_operands(t, t, _TAB)
    assert t2.is_contiguous() and st == 2 * L * phim
    assert torch.equal(t2, t.reshape(6, 2, L, phim))
