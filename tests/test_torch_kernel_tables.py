"""The host side of the tensor-core NTT kernel (csrc/ct_ntt.cu
ct_mma_kernel), on the CPU: the byte planes and Shoup reciprocals that
ops/ntt_ct_cuda.kernel_tables prepares recombine to the tables; the
kernel's 32-bit reduction of the five byte diagonals equals % up to and
past the stated bound (2^57, checked to 2^60), its quotients summed before
the one multiplication by q; the twiddle's Shoup product on the
unreduced sum (the ping-pong schedule's stage 1); and a numpy emulation of
the kernel's arithmetic on those tables (byte-plane products per
diagonal, the reduction, the twiddle read as 16-byte pairs from the
padded rows, the same index maps) equals the plain N-point transforms of
ct_fwd, ct_fwd_digits and ct_inv on both lanes, up to m = 2^15, and on
the mixed-radix splits, odd R among them, with the plain pad, drop and
fold around it; a numpy model of the kernel doing those steps itself
(emulate_phim: the fetch's pad and insert, the store's drop, the fold's
two passes) equals the plain phim-wide transforms, and its divisions,
fold rule and shared memory are checked.  The shape rule the wrappers
check before a launch is in test_torch_context.py.  The kernel itself runs only on a card
(tests/test_torch_cuda.py, chip_smoke.py)."""
import numpy as np
import pytest
import torch

from fhe_si_tpu_torch import DeviceContext, FheContext
from fhe_si_tpu_torch.hostmath import numbth
from fhe_si_tpu_torch.ops import cuda_build, ntt_ct, ntt_ct_cuda as nc

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


def fold_diagonals(D, consts):
    """The kernel's fold_diagonals(): D [5, ...] s32 diagonals (as
    uint64), consts one prime's row of prime_consts.  D_0 plus the four
    products D_d c_d, less q times the sum of their Shoup quotients, all
    mod 2^32: the same number as the four Shoup products added one by
    one, which stays below 2^32 (the header's s < 2^31 + 8q)."""
    k = _u32(consts)
    q, c, cp = k[0], k[2:6], k[6:10]
    s, hi = D[0].copy(), np.zeros_like(D[0])
    for d in range(4):
        s = (s + D[d + 1] * c[d]) & np.uint64(M32)
        hi = (hi + ((D[d + 1] * cp[d]) >> np.uint64(32))) & np.uint64(M32)
    s = (s - hi * q) & np.uint64(M32)
    one_by_one = D[0] + sum(_shoup(D[d + 1], c[d], cp[d], q) for d in range(4))
    assert (one_by_one < 1 << 32).all()
    assert np.array_equal(s, one_by_one)
    return s


def reduce_diagonals(D, consts):
    """The kernel's reduce_diagonals(): the folded sum, canonical."""
    k = _u32(consts)
    return _csub(_shoup(fold_diagonals(D, consts), 1, k[1], k[0]), k[0])


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


@pytest.mark.parametrize("q", PRIMES)
def test_twiddle_reduces_the_folded_sum(q):
    """The ping-pong schedule's stage 1 multiplies the folded diagonals
    (below 2^32, not reduced) by the twiddle with one Shoup product:
    csub(shoup(s, w, w')) is s w mod q for every s < 2^32 and w < q, the
    extremes included."""
    rng = np.random.default_rng(q + 1)
    s = np.concatenate([rng.integers(0, 1 << 32, size=20000, dtype=np.int64),
                        np.array([0, 1, q - 1, q, (1 << 32) - 1,
                                  (1 << 31) + 8 * q - 1], dtype=np.int64)])
    w = np.concatenate([rng.integers(0, q, size=20000, dtype=np.int64),
                        np.array([0, 1, q - 1, q - 1, q - 1, q - 1],
                                 dtype=np.int64)])
    wp = nc._reciprocal(w, q)
    got = _csub(_shoup(s.astype(np.uint64), w, wp, q), np.uint64(q))
    want = [int(a) * int(b) % q for a, b in zip(s, w)]
    assert got.tolist() == want


def _check_recombine(ct, kt):
    q = ct['q'].astype(np.int64)
    for name in ('t1', 't2', 't1i', 't2i', 't2i_crt'):
        if name not in ct:
            continue
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
        # rows of whole 16-byte words, at least 16 words of zero padding
        assert nc.tw_stride(R) % 4 == 0 and nc.tw_stride(R) >= 2 * R + 16
        assert pairs.shape == tw.shape[:2] + (nc.tw_stride(R),)
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


@pytest.mark.parametrize("mp", CONFIGS)
def test_kernel_tables_recombine(mp):
    """Planes, twiddle pairs and constants give back the tables."""
    m, p, bits = mp
    ctx = FheContext(m=m, log_q=80, p=p, generator=3, prime_bits=bits)
    meta, ct = ntt_ct.ct_tables(ctx.m, ctx.primes, ctx.roots)
    ct = ntt_ct.with_crt_premultiplier(ct, ctx.fast_crt_tables['binv'])
    _check_recombine(ct, nc.kernel_tables(ct))


def _planes_of(x):
    x = np.asarray(x, np.int64)
    return [(x >> (8 * p)) & 255 for p in range(3)]


def _stage(planes, B, consts, K, kp=None):
    """One stage of the kernel: C = A @ B from byte planes per diagonal,
    reduced as the kernel does.  planes uint8 [3, Mp, Ks] of A [K, K]
    (as the kernel reads it: K padded to 32 with zeros, or cut at kp, a
    multiple of 32, past which B is zero), B [K, n] < 2^24."""
    A = [planes[p].astype(np.int64)[:K, :-16] for p in range(3)]
    if kp is not None:
        assert kp % 32 == 0 and not B[kp:].any()
        A, B = [a[:, :kp] for a in A], B[:kp]
    # the kernel never writes the operand's padding rows: take the worst
    # bytes there, which the table planes' zero columns must cancel
    Bp = [np.pad(b, ((0, A[0].shape[1] - len(B)), (0, 0)),
                 constant_values=255) for b in _planes_of(B)]
    D = np.zeros((5, K, B.shape[1]), np.int64)
    for a in range(3):
        for b in range(3):
            D[a + b] += A[a] @ Bp[b]
    assert D.max() < 1 << 31
    return reduce_diagonals(D.astype(np.uint64), consts).astype(np.int64)


def _twiddle_loads(kt, key, l, S, R):
    """The stage-1 epilogue's twiddle reads: for row m < S and even column
    n < R, one 16-byte load of words m*tws + 2n .. + 3 past prime l's base
    l*S*tws in the flat table, (w, w') of column n and of column n + 1
    (column R, past an odd R, reads the row's padding).  Returns w, w'
    [S, R rounded up to even]."""
    flat = kt[key].view(np.uint32).reshape(-1).astype(np.uint64)
    tws = nc.tw_stride(R)
    assert kt[key].shape[1:] == (S, tws)
    o = (l * S * tws + np.arange(S)[:, None] * tws
         + 2 * np.arange(0, R, 2)[None, :])
    assert not (o % 4).any()                   # every load 16-byte aligned
    words = flat[o[..., None] + np.arange(4)]  # [S, pairs of columns, 4]
    w = words[..., 0::2].reshape(S, -1)
    wp = words[..., 1::2].reshape(S, -1)
    return w, wp


def emulate(kt, a1, a2, tw, rows, S, R):
    """ct_mma_kernel on rows [n_rows, L, S*R] (each row [S][R]) ->
    [n_rows, L, R*S] ([R][S] row-major)."""
    n_rows, L, _ = rows.shape
    out = np.empty((n_rows, L, S * R), np.int64)
    for l in range(L):
        consts = kt['k_consts'][l]
        q = np.uint64(consts.view(np.uint32)[0])
        w, wp = _twiddle_loads(kt, tw, l, S, R)
        for r in range(n_rows):
            # fetch() zeroes the input columns past R (to the 8-column tile)
            x = np.zeros((S, w.shape[1]), np.int64)
            x[:, :R] = rows[r, l].reshape(S, R)
            y = _stage(kt[a1][l], x, consts, S)
            y = _csub(_shoup(y, w, wp, q), q).astype(np.int64)
            # column R of an odd R lands in B2's K padding as zero
            assert not y[:, R:].any()
            out[r, l] = _stage(kt[a2][l], y[:, :R].T, consts, R).reshape(-1)
    return out


def _i32(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.int32)


def _emulate_fwd(kt, T, meta, res):
    """res [rows, L, phim]: the kernel on the padded rows equals the plain
    N-point transform, and with the wrapper's drop, the plain ct_fwd."""
    x = ntt_ct.pad_to_N(_i32(res), meta)
    got = emulate(kt, 'k_t2', 'k_t1', 'k_tw', x.numpy(), meta.N2, meta.N1)
    assert np.array_equal(got, ntt_ct.ct_fwd_n(T, x, meta).numpy())
    assert torch.equal(ntt_ct.drop_excluded(_i32(got), meta),
                       ntt_ct.ct_fwd(T, _i32(res), meta))


def _emulate_fwd_digits(kt, T, meta, digits):
    L = len(kt['q'])
    d = ntt_ct.pad_to_N(_i32(digits), meta)
    got = emulate(kt, 'k_t2', 'k_t1', 'k_tw',
                  np.repeat(d.numpy()[:, None], L, axis=1), meta.N2, meta.N1)
    assert np.array_equal(got, ntt_ct.ct_fwd_digits_n(T, d, meta, 24).numpy())
    assert torch.equal(ntt_ct.drop_excluded(_i32(got), meta),
                       ntt_ct.ct_fwd_digits(T, _i32(digits), meta, 24))


def _emulate_inv(kt, T, meta, ev, key):
    """ev [rows, L, phim]: with the wrapper's insert and fold."""
    e = ntt_ct.insert_excluded(_i32(ev), meta)
    got = emulate(kt, 'k_t1i', 'k_' + key, 'k_twi', e.numpy(), meta.N1,
                  meta.N2)
    assert np.array_equal(got, ntt_ct.ct_inv_n(T, e, meta, key).numpy())
    assert torch.equal(ntt_ct.fold_mod_phim(_i32(got), T['q'], meta),
                       ntt_ct.ct_inv(T, _i32(ev), meta, key))


def _operands(rng, q, n_rows, phim):
    """Residue rows (row 0 all at q - 1) and 24-bit digit rows (row 0
    with every byte at 255)."""
    res = rng.integers(0, q[:, None], size=(n_rows, len(q), phim))
    res[0] = q[:, None] - 1
    digits = rng.integers(0, 1 << 24, size=(n_rows, phim))
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
        res, digits = _operands(rng, kt['q'].astype(np.int64), 3, meta.phim)
        _emulate_fwd(kt, T, meta, res)
        _emulate_fwd_digits(kt, T, meta, digits)
        for key in ('t2i', 't2i_crt'):
            _emulate_inv(kt, T, meta, res, key)


def _prime_tables(m, qs):
    meta, ct = ntt_ct.ct_tables(
        m, qs, [numbth.find_element_of_order(q, m) for q in qs])
    kt = dict(ct, **nc.kernel_tables(ct))
    return meta, ct, kt, {k: torch.as_tensor(v) for k, v in kt.items()}


@pytest.mark.parametrize("bad", [pytest.param(1 << 23, id="2^23"),
                                 pytest.param(1, id="1")])
def test_kernel_tables_refuse_primes_outside_the_kernel(bad):
    """kernel_tables, without whose tables no launch runs, refuses a prime
    outside [2, 2^23) on the host primes, with the basis' shape."""
    _, ct, _, _ = _prime_tables(32, [97, 8257537])
    ct = dict(ct, q=np.array([[97], [bad]], dtype=ct['q'].dtype))
    with pytest.raises(ValueError, match=r"kernel_tables: input \(2,\): "
                       r"the kernel takes primes in \[2, 2\^23\) only"):
        nc.kernel_tables(ct)


@pytest.mark.parametrize("transform", ["ct_fwd", "ct_fwd_digits", "ct_inv"])
def test_emulated_kernel_equals_plain_m32768(transform):
    """m = 2^15 (N1 = N2 = 128, K = 128 on both stages), the largest
    power of two the kernel takes, on one narrow and one wide prime."""
    qs = [786433, 8257537]    # 3 * 2^18 + 1, 63 * 2^17 + 1
    meta, ct, kt, T = _prime_tables(1 << 15, qs)
    res, digits = _operands(np.random.default_rng(15), ct['q'].astype(np.int64),
                            2, meta.phim)
    if transform == "ct_fwd":
        _emulate_fwd(kt, T, meta, res)
    elif transform == "ct_fwd_digits":
        _emulate_fwd_digits(kt, T, meta, digits)
    else:
        _emulate_inv(kt, T, meta, res, 't2i')


# mixed-radix splits N1 x N2 (forward R = N1, inverse R = N2), on a narrow
# prime and a wide one (below 2^23) with m | q - 1
MIXED = [pytest.param((40, [1048361, 8387921]), id="m40-5x4"),
         pytest.param((18, [1048573, 8388451]), id="m18-3x3"),
         pytest.param((54, [1048573, 8388091]), id="m54-9x3"),
         pytest.param((13122, [997273]), id="m13122-81x81"),
         pytest.param((20480, [962561, 8273921]), id="m20480-128x80")]


@pytest.mark.parametrize("mq", MIXED)
def test_emulated_kernel_equals_plain_mixed_radix(mq):
    """The mixed-radix splits, odd R (5, 3, 9, 81) among them: the
    twiddle rows at the rounded stride, the kernel's arithmetic, and the
    wrappers' pad, drop, insert and fold around it, against the plain
    transforms; both inverse tables."""
    m, qs = mq
    meta, ct, _, _ = _prime_tables(m, qs)
    binv = np.random.default_rng(m).integers(1, min(qs), size=len(qs))
    ct = ntt_ct.with_crt_premultiplier(ct, binv)
    kt = dict(ct, **nc.kernel_tables(ct))
    _check_recombine(ct, kt)
    T = {k: torch.as_tensor(v) for k, v in kt.items()}
    assert meta.q_odd > 1 and meta.phim < meta.N
    res, digits = _operands(np.random.default_rng(m),
                            ct['q'].astype(np.int64), 2, meta.phim)
    _emulate_fwd(kt, T, meta, res)
    _emulate_fwd_digits(kt, T, meta, digits)
    for key in ('t2i', 't2i_crt'):
        _emulate_inv(kt, T, meta, res, key)


def _divide(a, d: int):
    """ct_ntt.cu divide: floor(a / d) as the high word of a * ceil(2^32/d)."""
    return ((np.asarray(a, np.uint64) * np.uint64(M32 // d + 1))
            >> np.uint64(32)).astype(np.int64)


def _compact(u, meta):
    """ct_ntt.cu compact: evaluation u's index in a phim-wide row, -1
    where u mod q = u0."""
    q, u0 = meta.q_odd, meta.u0
    qd = _divide(u, q)
    r = np.asarray(u) - qd * q
    return np.where(r == u0, -1, qd * (q - 1) + r - (r > u0))


def _fold_passes(S: int, R: int, phim: int):
    """sync_rows' two fold passes over stage 2's 16 x 16 tiles of the
    output [R][S] (c = n + S m): (u_tail, u_head, tiles, the entries c of
    tile u); the first pass runs the tiles [u_tail, tiles), the second
    [0, u_head)."""
    nu2 = -(-S // 16)
    tiles = -(-R // 16) * nu2

    def entries(u):
        m0, n0 = u // nu2 * 16, u % nu2 * 16
        return [m * S + n for m in range(m0, min(m0 + 16, R))
                for n in range(n0, min(n0 + 16, S))]
    u_tail = next((u for u in range(tiles) if max(entries(u)) >= phim), tiles)
    u_head = next((u for u in range(tiles) if min(entries(u)) >= phim), tiles)
    return u_tail, u_head, tiles, entries


def emulate_phim(kt, a1, a2, tw, rows, meta, fwd: bool):
    """ct_mma_kernel with the phim <-> N steps (ct_ntt.cu, "the phim <-> N
    steps"; kPhimFwd when fwd, else kPhimInv) on phim-wide rows
    [n_rows, L, phim] -> [n_rows, L, phim], each index as the kernel
    computes it: the fetch's pad or insert, stage 1 cut at the rows pad
    leaves, the store's drop, or the fold's two passes through the tail
    staged in shared memory.  Every output word is written once."""
    S, R = (meta.N2, meta.N1) if fwd else (meta.N1, meta.N2)
    P, N, s = meta.phim, meta.N, meta.N // meta.q_odd
    n_rows, L, _ = rows.shape
    i = np.arange(N)                          # i = kk R + n of the row [S][R]
    src = np.where(i < P, i, -1) if fwd else _compact(i, meta)
    kp = -(-min(S, -(-P // R)) // 32) * 32 if fwd else None
    u_tail, u_head, tiles, entries = _fold_passes(S, R, P)
    out = np.full((n_rows, L, P), -1, np.int64)
    for l in range(L):
        consts = kt['k_consts'][l]
        q = np.uint64(consts.view(np.uint32)[0])
        w, wp = _twiddle_loads(kt, tw, l, S, R)
        for r in range(n_rows):
            x = np.zeros((S, w.shape[1]), np.int64)
            x[:, :R] = np.where(src >= 0, rows[r, l][np.maximum(src, 0)],
                                0).reshape(S, R)
            y = _stage(kt[a1][l], x, consts, S, kp)
            y = _csub(_shoup(y, w, wp, q), q).astype(np.int64)
            y = _stage(kt[a2][l], y[:, :R].T, consts, R).reshape(-1)  # c or u
            o = out[r, l]
            if fwd:                           # drop
                at = _compact(np.arange(N), meta)
                assert (o[at[at >= 0]] == -1).all()
                o[at[at >= 0]] = y[at >= 0]
                continue
            tail = np.full(s, -1, np.int64)   # the first pass
            for u in range(u_tail, tiles):
                for c in entries(u):
                    if c >= P:
                        tail[c - P] = y[c]
            assert (tail >= 0).all()
            for u in range(u_head):           # the second
                for c in entries(u):
                    if c < P:
                        blk = int(_divide(c, s))
                        t = int(tail[c - blk * s])
                        assert o[c] == -1
                        o[c] = (y[c] + (t if blk & 1 else int(q) - t)) % int(q)
    assert (out >= 0).all()
    return out


# mixed-radix splits the kernel does the phim <-> N steps on: those of
# MIXED, S = 6 (m = 96 forward, stage 1 cut past S) and m = 12288
# (96 x 64: the fold's head and tail share tiles)
FUSED = MIXED + [pytest.param((96, [1048129]), id="m96-8x6"),
                 pytest.param((12288, [786433]), id="m12288-96x64")]


@pytest.mark.parametrize("mq", FUSED)
def test_emulated_phim_steps_equal_plain(mq):
    """The kernel's pad, drop, insert and fold (emulate_phim) on
    phim-wide rows equal the plain ct_fwd, ct_fwd_digits and ct_inv of
    ops/ntt_ct.py, both inverse tables, on random rows and rows at the
    extremes (residues q - 1, digits 2^24 - 1)."""
    m, qs = mq
    meta, ct, _, _ = _prime_tables(m, qs)
    ct = ntt_ct.with_crt_premultiplier(ct, np.arange(2, 2 + len(qs)))
    kt = dict(ct, **nc.kernel_tables(ct))
    T = {k: torch.as_tensor(v) for k, v in kt.items()}
    assert meta.phim < meta.N and nc.folds_in_kernel(meta)
    res, digits = _operands(np.random.default_rng(m),
                            ct['q'].astype(np.int64), 2, meta.phim)
    L = len(qs)
    got = emulate_phim(kt, 'k_t2', 'k_t1', 'k_tw', res, meta, True)
    assert np.array_equal(got, ntt_ct.ct_fwd(T, _i32(res), meta).numpy())
    got = emulate_phim(kt, 'k_t2', 'k_t1', 'k_tw',
                       np.repeat(digits[:, None], L, axis=1), meta, True)
    assert np.array_equal(
        got, ntt_ct.ct_fwd_digits(T, _i32(digits), meta, 24).numpy())
    for key in ('t2i', 't2i_crt'):
        got = emulate_phim(kt, 'k_t1i', 'k_' + key, 'k_twi', res, meta, False)
        assert np.array_equal(got, ntt_ct.ct_inv(T, _i32(res), meta,
                                                 key).numpy())


def _mixed_rings(limit=nc.SMEM_MAX):
    """Every split of a ring m = 2^a q^b, q odd, phim > 2048 (the
    Cooley-Tukey family's mixed rings) up to m = 2^18 that the kernel
    takes: [CtMeta]."""
    out = []
    for q in (3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53):
        for a in range(1, 18):
            for b in range(1, 12):
                m = 2 ** a * q ** b
                if m > 1 << 18:
                    break
                N = m // 2
                meta = ntt_ct.CtMeta(*ntt_ct._split(N), N // q * (q - 1), q)
                if meta.phim > 2048 and nc.kernel_takes(meta, limit):
                    out.append(meta)
    return out


def test_divide_exact_on_every_fused_split():
    """divide's quotient by q and by s = N/q is exact for every index
    below N on every mixed split the kernel takes (N < 2^16: launch_phim
    refuses more)."""
    metas = _mixed_rings()
    assert len(metas) > 100
    for meta in metas:
        assert meta.N < 1 << 16
        a = np.arange(meta.N)
        for d in (meta.q_odd, meta.N // meta.q_odd):
            assert np.array_equal(_divide(a, d), a // d)


def test_fold_rule_and_shared_memory():
    """folds_in_kernel, the Python side of the fold's shared memory (Geo's
    fold: s words, rounded up to 16 bytes, after B2): m = 20480's inverse
    128 x 80 takes 159,744 bytes of planes and 2048 x 4 of tail (its
    90,112-byte twiddle stays in global memory), its forward 80 x 128
    159,744; m = 13122's 81 x 81 takes 129,024 of planes, 8,752 of tail
    (2187 words) and its 58,320-byte twiddle.  Of the mixed splits the
    kernel takes, only 125 x 125 and 128 x 125 leave no room for the
    tail; their ct_inv keeps the plain insert and fold.  m = 2^k folds
    nothing."""
    assert nc.kernel_smem(128, 80, 2048) == 159744 + 8192 == 167936
    assert nc.kernel_smem(80, 128) == 159744
    assert nc.kernel_smem(81, 81, 2187) == 129024 + 8752 + 58320 == 196096
    assert nc.kernel_smem(81, 81) == 129024 + 58320
    # the tail may push the twiddle out, never the planes past the limit
    assert nc.kernel_smem(128, 80, 2048) - nc.kernel_smem(128, 80) == 8192
    for m, want in ((20480, 2048), (13122, 2187), (12288, 2048), (8192, 0)):
        meta, _, _, _ = _prime_tables(m, [next(
            q for q in range(m + 1, 1 << 23, m) if numbth.is_prime(q))])
        assert nc.fold_words(meta) == want
        assert nc.folds_in_kernel(meta) == (want > 0)
    left = [(meta.N1, meta.N2) for meta in _mixed_rings()
            if not nc.folds_in_kernel(meta)]
    assert left == [(125, 125), (128, 125)]
    for S, R in left:
        assert nc._fits(S, R, nc.SMEM_MAX)
        assert not nc._fits(S, R, nc.SMEM_MAX, S * R // 5)


def test_phim_fused_counts_launches_only():
    """PHIM_FUSED has one key a transform, reset_phim_fused zeroes it, and
    the plain versions that CPU tensors take count nothing there (they
    count their steps in ntt_ct.PHIM_STEPS)."""
    assert set(nc.PHIM_FUSED) == {"ct_fwd", "ct_fwd_digits", "ct_inv"}
    nc.PHIM_FUSED["ct_inv"] += 2
    nc.reset_phim_fused()
    assert set(nc.PHIM_FUSED.values()) == {0}
    meta, ct, _, T = _prime_tables(40, [1048361])
    x = torch.zeros((2, 1, meta.phim), dtype=torch.int32)
    ntt_ct.reset_phim_steps()
    nc.ct_inv(T, nc.ct_fwd(T, x, meta), meta)
    assert set(nc.PHIM_FUSED.values()) == {0}
    assert ntt_ct.PHIM_STEPS == dict.fromkeys(ntt_ct.PHIM_STEPS, 1)
    ntt_ct.reset_phim_steps()


# (S, R) -> the schedule ct_mma_kernel runs the row on and its shared
# memory: ct_ntt.cu pingpong_takes with PGeo (the prime's A1 and A2, two
# warpgroups' B1 and B2, unpadded), rowsplit_takes with rowsplit_bytes
# (A1, A2 and one row's B1 and B2, unpadded), Geo on every other split
SCHEDULE_RULE = [
    pytest.param((64, 64, "pingpong", 110592), id="m8192-64x64"),
    pytest.param((64, 128, "pingpong", 229376), id="m16384-fwd-64x128"),
    pytest.param((128, 64, "pingpong", 159744), id="m16384-inv-128x64"),
    pytest.param((128, 128, "rowsplit", 196608), id="m32768-128x128"),
    pytest.param((80, 128, "sync", 159744), id="m20480-fwd-80x128"),
    pytest.param((128, 80, "sync", 159744), id="m20480-inv-128x80"),
    pytest.param((81, 81, "sync", 187344), id="m13122-81x81"),
    pytest.param((32, 64, "sync", 55296), id="m4096-fwd-32x64"),
    pytest.param((64, 32, "sync", 57344), id="m4096-inv-64x32"),
    pytest.param((192, 64, "sync", 221184), id="sides-of-64-past-8192"),
    pytest.param((4, 5, "sync", 9664), id="m40-4x5")]


@pytest.mark.parametrize("rule", SCHEDULE_RULE)
def test_schedule_rule(rule):
    """kernel_schedule and kernel_smem, the Python mirror of the rule that
    launch_mma applies in C (tests/test_torch_cuda.py holds the mirror
    equal to fsi_ct_schedule and fsi_ct_mma_smem on the card): the
    ping-pong takes sides that are multiples of 64 with at most 8192
    entries a row whose two-row planes fit; the ping-pong's 64 x 64 layout
    is 73,728 bytes of planes and the 36,864-byte twiddle, 128 x 64 leaves
    its twiddle in global memory as m = 2^15 does; the rowsplit schedule
    takes 128 x 128, one row's planes alone."""
    S, R, schedule, smem = rule
    assert nc.kernel_schedule(S, R) == schedule
    assert nc.kernel_smem(S, R) == smem
    assert smem <= nc.SMEM_MAX
    if schedule == "pingpong":
        planes = 3 * (S * S + R * R) + 12 * S * R
        assert smem in (planes, planes + S * nc.tw_stride(R) * 4)
    if schedule == "rowsplit":
        assert smem == 3 * (S * S + R * R) + 6 * S * R


# (S, R) -> the schedule of the rowsplit rule's neighbourhood: 128 x 128
# alone takes it (sides multiples of 64, N a power of two above 8192, one
# row's planes inside SMEM_MAX); the ping-pong keeps its splits, the sync
# schedule the rest, and no split past 128 x 128 fits one row's planes
ROWSPLIT_RULE = [
    pytest.param((128, 128, "rowsplit"), id="128x128"),
    pytest.param((64, 64, "pingpong"), id="64x64"),
    pytest.param((64, 128, "pingpong"), id="64x128"),
    pytest.param((128, 64, "pingpong"), id="128x64"),
    pytest.param((192, 64, "sync"), id="192x64-not-a-power-of-two"),
    pytest.param((128, 80, "sync"), id="128x80"),
    pytest.param((80, 128, "sync"), id="80x128"),
    pytest.param((81, 81, "sync"), id="81x81"),
    pytest.param((64, 256, "sync"), id="64x256-past-smem"),
    pytest.param((256, 64, "sync"), id="256x64-past-smem"),
    pytest.param((256, 128, "sync"), id="256x128-past-smem"),
    pytest.param((192, 128, "sync"), id="192x128-not-a-power-of-two")]


@pytest.mark.parametrize("rule", ROWSPLIT_RULE)
def test_rowsplit_rule(rule):
    """The rowsplit rule at its edges: kernel_schedule, and the one-row
    planes 3 (S^2 + R^2) + 6 S R against SMEM_MAX; at 128 x 128 the
    layout is 196,608 bytes with the twiddle pairs in global memory (they
    would need 139,264 more), so TWIDDLE_GLOBAL still counts there."""
    S, R, schedule = rule
    assert nc.kernel_schedule(S, R) == schedule
    planes = 3 * (S * S + R * R) + 6 * S * R
    rowsplit = (S % 64 == 0 and R % 64 == 0 and S * R > 8192
                and S * R & (S * R - 1) == 0 and planes <= nc.SMEM_MAX)
    assert (schedule == "rowsplit") == rowsplit
    if schedule == "rowsplit":
        assert nc.kernel_smem(S, R) == planes == 196608
        assert nc.twiddle_in_global(S, R)
        assert S * nc.tw_stride(R) * 4 == 139264


@pytest.mark.parametrize("m,schedule", [
    (8192, "pingpong"), (1 << 14, "pingpong"), (1 << 15, "rowsplit"),
    (4096, "sync"), (20480, "sync"), (13122, "sync"), (32, "sync")])
def test_schedule_of_every_transform(m, schedule):
    """Both orientations of a ring's split take one schedule: the forward
    transforms' row [N2][N1] and the inverse's [N1][N2].  m = 8192, the
    benchmark's ring, and m = 2^14 run the ping-pong; m = 2^15 the
    rowsplit schedule; the mixed-radix splits and m <= 4096 the sync
    schedule."""
    N1, N2 = ntt_ct._split(m // 2)
    assert nc.kernel_schedule(N2, N1) == nc.kernel_schedule(N1, N2) == schedule


def test_schedules_count_launches_only():
    """SCHEDULES has one key a schedule, reset_launches zeroes it with
    LAUNCHES, and the plain versions that CPU tensors take count in
    neither."""
    assert set(cuda_build.SCHEDULES) == {"pingpong", "sync", "rowsplit"}
    cuda_build.SCHEDULES["sync"] += 3
    cuda_build.SCHEDULES["rowsplit"] += 4
    cuda_build.reset_launches()
    assert cuda_build.SCHEDULES == {"pingpong": 0, "sync": 0, "rowsplit": 0}
    meta, ct, _, _ = _prime_tables(32, [97])
    T = {k: torch.as_tensor(v) for k, v in ct.items()}
    x = torch.zeros((2, 1, meta.phim), dtype=torch.int32)
    nc.ct_inv(T, nc.ct_fwd(T, x, meta), meta)
    assert cuda_build.SCHEDULES == {"pingpong": 0, "sync": 0, "rowsplit": 0}
    assert not any(cuda_build.LAUNCHES.values())
