"""The host side of the tensor-core NTT kernel (csrc/ct_ntt.cu
ct_mma_kernel), on the CPU: the byte planes and Shoup reciprocals that
ops/ntt_ct_cuda.kernel_tables prepares recombine to the tables; the
kernel's 32-bit reduction of the five byte diagonals equals % up to and
past the stated bound (2^60); and a numpy emulation of the kernel's
arithmetic on those tables (byte-plane products per diagonal, the
reduction, the twiddle, the same index maps) equals the plain versions
of ct_fwd, ct_fwd_digits and ct_inv on both lanes, up to m = 2^15.  The
kernel itself runs only on a card (tests/test_torch_cuda.py,
chip_smoke.py)."""
import numpy as np
import pytest
import torch

from fhe_si_tpu_torch import DeviceContext, FheContext
from fhe_si_tpu_torch.hostmath import numbth
from fhe_si_tpu_torch.ops import ntt_ct, ntt_ct_cuda as nc

torch.set_num_threads(1)

M32 = (1 << 32) - 1
# primes of the narrow lane (below 2^20) and of the wide lane (near 2^23)
PRIMES = [1032193, 786433, 40961, 8380417, 8257537, 7340033]
CONFIGS = [pytest.param((32, 97, None), id="m32"),
           pytest.param((256, 257, None), id="m256"),
           pytest.param((32, 97, 23), id="m32-wide"),
           pytest.param((256, 257, 23), id="m256-wide")]


def _u32(a):
    return np.asarray(a).view(np.uint32).astype(np.uint64)


def _shoup(a, w, wp, q):
    """The kernel's shoup(): a*w - umulhi(a, w')*q mod 2^32."""
    a, w, wp, q = (np.asarray(v, np.uint64) for v in (a, w, wp, q))
    return (a * w - ((a * wp) >> np.uint64(32)) * q) & np.uint64(M32)


def _csub(r, q):
    return np.where(r >= q, r - q, r)


def reduce_diagonals(D, consts):
    """The kernel's reduce_diagonals(): D [5, ...] s32 diagonals (as
    uint64), consts one prime's row of prime_consts."""
    k = _u32(consts)
    q, qr, c, cp = k[0], k[1], k[2:6], k[6:10]
    s = D[0].copy()
    for d in range(4):
        s = s + _shoup(D[d + 1], c[d], cp[d], q)
    assert (s < 1 << 32).all()                # the header's s < 2^32
    return _csub(_shoup(s, 1, qr, q), q)


@pytest.mark.parametrize("q", PRIMES)
def test_reduction_equals_mod(q):
    consts = nc.prime_consts(np.array([q]))[0]
    rng = np.random.default_rng(q)
    v = np.concatenate([
        rng.integers(0, 1 << 60, size=20000, dtype=np.int64),
        np.array([0, 1, q - 1, q, q + 1, (1 << 60) - 1, 1 << 60,
                  (1 << 60) - q, ((1 << 60) // q) * q, (1 << 32) - 1,
                  1 << 32, (1 << 31) - 1], dtype=np.int64)])
    # v as diagonals the way an accumulation leaves them: bytes 0..3, the
    # rest on diagonal 4 (below 2^28 for v <= 2^60)
    D = np.stack([(v >> (8 * d)) & 255 for d in range(4)] + [v >> 32])
    got = reduce_diagonals(D.astype(np.uint64), consts)
    assert np.array_equal(got, (v % q).astype(np.uint64))
    # any five diagonals below 2^31 (an accumulation of 3 K 255^2 < 2^31
    # at K <= 11,008), including all at their maximum
    K = 11008
    D = rng.integers(0, (1 << 31) - 1, size=(5, 20000), dtype=np.int64)
    D[:, 0] = 3 * K * 255 ** 2
    D[:, 1] = (1 << 31) - 1
    D[:, 2] = 0
    want = [sum(int(D[d, i]) << (8 * d) for d in range(5)) % q
            for i in range(D.shape[1])]
    got = reduce_diagonals(D.astype(np.uint64), consts)
    assert got.tolist() == want


@pytest.mark.parametrize("mp", CONFIGS)
def test_kernel_tables_recombine(mp):
    """Planes, twiddle pairs and constants give back the tables."""
    m, p, bits = mp
    ctx = FheContext(m=m, log_q=80, p=p, generator=3, prime_bits=bits)
    meta, ct = ntt_ct.ct_tables(ctx.m, ctx.primes, ctx.roots)
    ct = ntt_ct.with_crt_premultiplier(ct, ctx.fast_crt_tables['binv'])
    kt = nc.kernel_tables(ct)
    q = ct['q'].astype(np.int64)
    for name in ('t1', 't2', 't1i', 't2i', 't2i_crt'):
        planes = kt['k_' + name].astype(np.int64)
        M = ct[name].shape[-1]
        assert planes.shape[1:] == (3, -(-M // 16) * 16, -(-M // 32) * 32 + 16)
        whole = planes[:, 0] + (planes[:, 1] << 8) + (planes[:, 2] << 16)
        assert np.array_equal(whole[:, :M, :M], ct[name])
        assert not whole[:, M:].any() and not whole[:, :, M:].any()
    for key, tw in (('k_tw', np.swapaxes(ct['tw'], 1, 2)), ('k_twi', ct['twi'])):
        tw = tw.astype(np.int64)
        pairs = kt[key].view(np.uint32).astype(np.int64)
        R = tw.shape[2]
        assert pairs.shape == tw.shape[:2] + (2 * R + 16,)
        assert np.array_equal(pairs[..., 0:2 * R:2], tw)
        assert np.array_equal(pairs[..., 1:2 * R:2],
                              (tw << 32) // q[:, None, None])
        assert not pairs[..., 2 * R:].any()
    c = kt['k_consts'].view(np.uint32).astype(np.int64)
    assert np.array_equal(c[:, 0], q)
    assert np.array_equal(c[:, 1], (1 << 32) // q)
    for d in range(1, 5):
        assert np.array_equal(c[:, 1 + d], pow(2, 8 * d) % q)
        assert np.array_equal(c[:, 5 + d], (c[:, 1 + d] << 32) // q)


def _planes_of(x):
    x = np.asarray(x, np.int64)
    return [(x >> (8 * p)) & 255 for p in range(3)]


def _stage(planes, B, consts, K):
    """One stage of the kernel: C = A @ B from byte planes per diagonal,
    reduced as the kernel does.  planes uint8 [3, Mp, Ks] of A [K, K]
    (as the kernel reads it: K padded to 32 with zeros), B [K, n] < 2^24."""
    A = [planes[p].astype(np.int64)[:K, :-16] for p in range(3)]
    # the kernel never writes the operand's padding rows: take the worst
    # bytes there, which the table planes' zero columns must cancel
    Bp = [np.pad(b, ((0, A[0].shape[1] - K), (0, 0)), constant_values=255)
          for b in _planes_of(B)]
    D = np.zeros((5, K, B.shape[1]), np.int64)
    for a in range(3):
        for b in range(3):
            D[a + b] += A[a] @ Bp[b]
    assert D.max() < 1 << 31
    return reduce_diagonals(D.astype(np.uint64), consts).astype(np.int64)


def emulate(kt, a1, a2, tw, rows, S, R):
    """ct_mma_kernel on rows [n_rows, L, S*R] (each row [S][R]) ->
    [n_rows, L, R*S] ([R][S] row-major)."""
    n_rows, L, _ = rows.shape
    out = np.empty((n_rows, L, S * R), np.int64)
    for l in range(L):
        consts = kt['k_consts'][l]
        q = np.uint64(consts.view(np.uint32)[0])
        pairs = kt[tw][l].view(np.uint32).astype(np.uint64)
        w, wp = pairs[:, 0:2 * R:2], pairs[:, 1:2 * R:2]
        for r in range(n_rows):
            y = _stage(kt[a1][l], rows[r, l].reshape(S, R), consts, S)
            y = _csub(_shoup(y, w, wp, q), q).astype(np.int64)
            out[r, l] = _stage(kt[a2][l], y.T, consts, R).reshape(-1)
    return out


def _emulate_fwd(kt, T, meta, res):
    got = emulate(kt, 'k_t2', 'k_t1', 'k_tw', res, meta.N2, meta.N1)
    want = ntt_ct.ct_fwd(T, torch.as_tensor(res, dtype=torch.int32), meta)
    assert np.array_equal(got, want.numpy())


def _emulate_fwd_digits(kt, T, meta, digits):
    L = len(kt['q'])
    got = emulate(kt, 'k_t2', 'k_t1', 'k_tw',
                  np.repeat(digits[:, None], L, axis=1), meta.N2, meta.N1)
    want = ntt_ct.ct_fwd_digits(T, torch.as_tensor(digits, dtype=torch.int32),
                                meta, 24)
    assert np.array_equal(got, want.numpy())


def _emulate_inv(kt, T, meta, ev, key):
    got = emulate(kt, 'k_t1i', 'k_' + key, 'k_twi', ev, meta.N1, meta.N2)
    want = ntt_ct.ct_inv(T, torch.as_tensor(ev, dtype=torch.int32), meta, key)
    assert np.array_equal(got, want.numpy())


def _operands(rng, q, n_rows, N):
    """Residue rows (row 0 all at q - 1) and 24-bit digit rows (row 0
    with every byte at 255)."""
    res = rng.integers(0, q[:, None], size=(n_rows, len(q), N))
    res[0] = q[:, None] - 1
    digits = rng.integers(0, 1 << 24, size=(n_rows, N))
    digits[0] = (1 << 24) - 1
    return res, digits


@pytest.mark.parametrize("mp", CONFIGS)
def test_emulated_kernel_equals_plain(mp):
    m, p, bits = mp
    dc = DeviceContext(FheContext(m=m, log_q=80, p=p, generator=3,
                                  prime_bits=bits), "cpu")
    meta, rng = dc.ct_meta, np.random.default_rng(m)
    for T in (dc.full['ct'], dc.ksw['ct']):
        kt = {k: v.numpy() for k, v in T.items()}
        res, digits = _operands(rng, kt['q'].astype(np.int64), 3, meta.N)
        _emulate_fwd(kt, T, meta, res)
        _emulate_fwd_digits(kt, T, meta, digits)
        for key in ('t2i', 't2i_crt'):
            _emulate_inv(kt, T, meta, res, key)


@pytest.mark.parametrize("transform", ["ct_fwd", "ct_fwd_digits", "ct_inv"])
def test_emulated_kernel_equals_plain_m32768(transform):
    """m = 2^15 (N1 = N2 = 128, K = 128 on both stages), the largest ring
    the kernel takes, on one narrow and one wide prime."""
    m, qs = 1 << 15, [786433, 8257537]    # 3 * 2^18 + 1, 63 * 2^17 + 1
    meta, ct = ntt_ct.ct_tables(
        m, qs, [numbth.find_element_of_order(q, m) for q in qs])
    kt = dict(ct, **nc.kernel_tables(ct))
    T = {k: torch.as_tensor(v) for k, v in kt.items()}
    res, digits = _operands(np.random.default_rng(15), ct['q'].astype(np.int64),
                            2, meta.N)
    if transform == "ct_fwd":
        _emulate_fwd(kt, T, meta, res)
    elif transform == "ct_fwd_digits":
        _emulate_fwd_digits(kt, T, meta, digits)
    else:
        _emulate_inv(kt, T, meta, res, 't2i')
