"""The port on a CUDA card: the three transform kernels against their
plain PyTorch versions on both residue lanes, on power-of-two and
mixed-radix rings (odd N1 among them), the splits the kernel refuses and
the matmul route that takes them (its boundary kernels, ops/route_cuda.py,
against their plain versions at the route cell's shapes), the two
limb/CRT kernels
(ops/crt_cuda.py) in every mode against their plain versions and the
shapes they refuse, the two evaluation-domain kernels
(ops/modular_cuda.py: the tensor product, the keyswitch dot) against
their plain versions and the shapes they refuse, the digit kernel
(ops/digits_cuda.py byte_decomp: digits and per-prime residues) against
its plain version and what it refuses, the dense transform
family against the same function on the CPU, the multiply + relinearize
slice (on the
Cooley-Tukey rings, decompSize 4 included, and on dense rings) and the
two applications on the card against the same runs on the CPU (which
test_torch_slice.py, test_torch_dense*.py and test_torch_apps*.py hold
equal to fhe_si_tpu).  Every test skips without a card.

This file imports neither JAX nor fhe_si_tpu, so it also runs where JAX
is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import functools
import re
from collections import Counter

import numpy as np
import pytest
import torch

from bench_port import cell as bench_cell
from fhe_si_tpu_torch import DeviceContext, FheContext, sampling, scheme
from fhe_si_tpu_torch.hostmath import oracle
from fhe_si_tpu_torch.ops import (crt, crt_cuda, cuda_build, digits_cuda,
                                  modular_cuda, ntt_ct, ntt_ct_cuda)

torch.set_num_threads(1)

RAGGED = 37     # rows: no row tile of the tensor-core kernel divides it
CONFIGS = [pytest.param((256, 257, None), id="m256"),
           pytest.param((32, 97, None), id="m32"),
           pytest.param((256, 257, 23), id="m256-wide"),
           pytest.param((32, 97, 23), id="m32-wide")]
KERNEL_CONFIGS = CONFIGS + [pytest.param((8192, 40961, None), id="m8192"),
                            pytest.param((8192, 40961, 23), id="m8192-wide")]
WIDE_CELL = bench_cell.load("ct32768_q220w.b64").config["context"]

# dense-family rings (m, log_q, p, generator, prime_bits)
DENSE = [pytest.param((22, 80, 23, 7, None), id="m22"),
         pytest.param((22, 80, 23, 7, 23), id="m22-wide"),
         pytest.param((46, 96, 47, 5, None), id="m46"),
         pytest.param((46, 96, 47, 5, 23), id="m46-wide")]

# the wrappers of each kernel source, as cuda_build.LAUNCHES counts them
NTT = ("ct_fwd", "ct_fwd_digits", "ct_inv")
CRT = ("crt_to_limbs", "limbs_to_residues")
MODULAR = ("tensor_product", "keyswitch_dot")


def _launched(keys) -> dict:
    return {k: cuda_build.LAUNCHES[k] for k in keys}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _ctx(m, p, prime_bits):
    return FheContext(m=m, log_q=80, p=p, generator=3, prime_bits=prime_bits)


@pytest.mark.cuda
@pytest.mark.parametrize("mp", KERNEL_CONFIGS)
def test_kernels_match_plain(cuda, mp):
    dc = DeviceContext(_ctx(*mp), cuda)
    meta = dc.ct_meta
    rng = np.random.default_rng(8)
    cuda_build.reset_launches()
    for T in (dc.full, dc.ksw, dc.lin):
        q = T["primes_np"]
        x = torch.as_tensor(rng.integers(0, q[:, None], size=(
            RAGGED, len(q), meta.phim)).astype(np.int32), device=cuda)
        d = torch.as_tensor(rng.integers(0, 1 << 24, size=(
            RAGGED, meta.phim)).astype(np.int32), device=cuda)
        ev = ntt_ct_cuda.ct_fwd(T["ct"], x, meta)
        assert torch.equal(ev, ntt_ct.ct_fwd(T["ct"], x, meta))
        for key in ("t2i", "t2i_crt"):
            assert torch.equal(ntt_ct_cuda.ct_inv(T["ct"], ev, meta, key),
                               ntt_ct.ct_inv(T["ct"], ev, meta, key))
        assert torch.equal(ntt_ct_cuda.ct_inv(T["ct"], ev, meta), x)
        assert torch.equal(ntt_ct_cuda.ct_fwd_digits(T["ct"], d, meta, 24),
                           ntt_ct.ct_fwd_digits(T["ct"], d, meta, 24))
    torch.cuda.synchronize()
    assert all(n > 0 for n in _launched(NTT).values())


def _kernel_tables(cuda, m, qs):
    from fhe_si_tpu_torch.hostmath import numbth
    meta, ct = ntt_ct.ct_tables(
        m, qs, [numbth.find_element_of_order(q, m) for q in qs])
    return meta, {k: torch.as_tensor(v, device=cuda)
                  for k, v in dict(ct, **ntt_ct_cuda.kernel_tables(ct)).items()}


def _operands(cuda, rng, q, rows, phim, worst):
    """Residues [rows, L, phim] and 24-bit digits [rows, phim]: random, or
    every residue q - 1 and every digit 2^24 - 1."""
    shape = (rows, len(q), phim)
    x = np.broadcast_to(q[:, None] - 1, shape) if worst else \
        rng.integers(0, q[:, None], size=shape)
    d = np.full((rows, phim), (1 << 24) - 1) if worst else \
        rng.integers(0, 1 << 24, size=(rows, phim))
    return (torch.as_tensor(np.ascontiguousarray(x, np.int32), device=cuda),
            torch.as_tensor(d.astype(np.int32), device=cuda))


def _all_transforms_match_plain(cuda, meta, T, seed, schedule="sync",
                                rows=(RAGGED,)):
    """The three kernels against their plain versions on each row count
    of `rows`, random and at the extremes, and the round trip, every
    launch on `schedule`; on a mixed-radix ring with the phim <-> N steps
    in the kernel (PHIM_FUSED; the inverse's plain insert and fold where
    the fold does not fit, PHIM_STEPS)."""
    rng = np.random.default_rng(seed)
    q = T["q"].cpu().numpy().astype(np.int64)
    cuda_build.reset_launches()
    ntt_ct_cuda.reset_phim_fused()
    ntt_ct_cuda.reset_twiddle_global()
    ntt_ct.reset_phim_steps()
    n = 0
    for count in rows:
        for worst in (False, True):
            x, d = _operands(cuda, rng, q, count, meta.phim, worst)
            ev = ntt_ct_cuda.ct_fwd(T, x, meta)
            assert torch.equal(ev, ntt_ct.ct_fwd(T, x, meta))
            assert torch.equal(ntt_ct_cuda.ct_inv(T, ev, meta), x)
            ev = ntt_ct_cuda.ct_fwd_digits(T, d, meta, 24)
            assert torch.equal(ev, ntt_ct.ct_fwd_digits(T, d, meta, 24))
            assert torch.equal(ntt_ct_cuda.ct_inv(T, ev, meta),
                               ntt_ct.ct_inv(T, ev, meta))
            n += 1
    torch.cuda.synchronize()
    assert _launched(NTT) == {"ct_fwd": n, "ct_fwd_digits": n, "ct_inv": 2 * n}
    assert cuda_build.SCHEDULES == {k: 4 * n * (k == schedule)
                                    for k in cuda_build.SCHEDULES}
    mixed = n if meta.q_odd > 1 else 0
    fold = ntt_ct_cuda.folds_in_kernel(meta)
    assert ntt_ct_cuda.PHIM_FUSED == {"ct_fwd": mixed, "ct_fwd_digits": mixed,
                                      "ct_inv": 2 * mixed if fold else 0}
    # the forward row [N2][N1], the inverse's [N1][N2] with the fold's tail
    fwd = ntt_ct_cuda.twiddle_in_global(meta.N2, meta.N1)
    inv = ntt_ct_cuda.twiddle_in_global(
        meta.N1, meta.N2, ntt_ct_cuda.fold_words(meta) if fold else 0)
    assert ntt_ct_cuda.TWIDDLE_GLOBAL == {"ct_fwd": n * fwd,
                                          "ct_fwd_digits": n * fwd,
                                          "ct_inv": 2 * n * inv}
    # the plain versions count their own steps: two forward transforms
    # and one inverse a round
    plain = {"pad_to_N": 2, "drop_excluded": 2, "insert_excluded": 1,
             "fold_mod_phim": 1}
    if mixed and not fold:
        plain = {k: v + 2 * (k in ("insert_excluded", "fold_mod_phim"))
                 for k, v in plain.items()}
    assert ntt_ct.PHIM_STEPS == {k: v * mixed for k, v in plain.items()}


@pytest.mark.cuda
def test_tensor_core_kernel_m16384(cuda):
    """m = 2^14 (N1 x N2 = 128 x 64: the ping-pong schedule, forward
    64 x 128 with the twiddle in shared memory, inverse 128 x 64 with it
    in global memory), on tables of three primes of both lanes."""
    meta, T = _kernel_tables(cuda, 1 << 14, [786433, 1032193, 8257537])
    _all_transforms_match_plain(cuda, meta, T, 14, "pingpong")


@pytest.mark.cuda
def test_tensor_core_kernel_m32768(cuda):
    """The largest ring the kernel takes (N1 x N2 = 128 x 128: the rowsplit
    schedule, the twiddle in global memory), on one narrow and one wide
    prime."""
    meta, T = _kernel_tables(cuda, 1 << 15, [786433, 8257537])
    _all_transforms_match_plain(cuda, meta, T, 15, "rowsplit")


@pytest.mark.cuda
def test_tensor_core_kernel_refusals(cuda):
    """At m = 2^16 (N1 x N2 = 256 x 128) the tensor-core kernel's tables
    exceed shared memory: the wrappers raise with the shape.  Tables
    without the kernel's byte planes raise too."""
    meta, T = _kernel_tables(cuda, 1 << 16, [786433])   # q = 3 * 2^18 + 1
    d = torch.zeros((2, meta.N), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match=r"\(2, 32768\).*shared memory"):
        ntt_ct_cuda.ct_fwd_digits(T, d, meta, 24)
    for fn in (ntt_ct_cuda.ct_fwd, ntt_ct_cuda.ct_inv):
        with pytest.raises(ValueError,
                           match=r"\(2, 1, 32768\).*256 x 128.*shared memory"):
            fn(T, d[:, None], meta)
    dc = DeviceContext(_ctx(32, 97, None), cuda)
    bare = {k: v for k, v in dc.full["ct"].items() if not k.startswith("k_")}
    x = torch.zeros((1, len(dc.full["primes_np"]), 16), dtype=torch.int32,
                    device=cuda)
    for fn in (ntt_ct_cuda.ct_fwd, ntt_ct_cuda.ct_inv):
        with pytest.raises(ValueError, match="kernel_tables"):
            fn(bare, x, dc.ct_meta)


# mixed-radix splits N1 x N2 (forward R = N1, inverse R = N2) on a narrow
# and a wide prime with m | q - 1: odd R at 5 x 4, 3 x 3, 9 x 3, 81 x 81;
# 125 x 125, whose fold does not fit beside its layout
MIXED = [pytest.param((40, [1048361, 8387921]), id="m40-5x4"),
         pytest.param((96, [1048129, 8387809]), id="m96-8x6"),
         pytest.param((160, [1047841, 8385761]), id="m160-10x8"),
         pytest.param((18, [1048573, 8388451]), id="m18-3x3"),
         pytest.param((54, [1048573, 8388091]), id="m54-9x3"),
         pytest.param((13122, [997273, 8306227]), id="m13122-81x81"),
         pytest.param((20480, [962561, 8273921]), id="m20480-128x80"),
         pytest.param((31250, [812501, 8312501]), id="m31250-125x125")]


@pytest.mark.cuda
@pytest.mark.parametrize("mq", MIXED)
def test_tensor_core_kernel_mixed_radix(cuda, mq):
    """The mixed-radix rings: the kernel with the pad, drop, insert and
    fold in its loads and stores, against the plain versions, phim wide
    in and out, on random rows and rows at the extremes; m = 31250 keeps
    the plain insert and fold around its inverse."""
    meta, T = _kernel_tables(cuda, *mq)
    assert meta.q_odd > 1
    assert ntt_ct_cuda.folds_in_kernel(meta) == (mq[0] != 31250)
    _all_transforms_match_plain(cuda, meta, T, mq[0], "sync")


@pytest.mark.cuda
def test_mixed_radix_at_the_cells_bases(cuda):
    """m = 20480 on the benchmark cell's bases (L = 12 and 8, both
    narrow), on 1 row, a count no row tile divides and one past a tile
    a block, random and at the extremes."""
    dc = DeviceContext(FheContext(m=20480, log_q=80, p=40961, generator=3),
                       cuda)
    assert (dc.full["ct"]["q"].shape[0], dc.ksw["ct"]["q"].shape[0]) == (12, 8)
    for T in (dc.full, dc.ksw):
        _all_transforms_match_plain(cuda, dc.ct_meta, T["ct"], 20480,
                                    rows=(1, RAGGED, 300))


@pytest.mark.cuda
def test_kernel_shape_rule_matches_card(cuda):
    """check_kernel_shape's shared-memory formula is the kernel's (Geo):
    equal to fsi_ct_mma_smem for every split the tests run, odd sides
    included, and with the fold's tail of each mixed split's inverse."""
    lib = cuda_build.library("ct_ntt")
    for S, R in ((2, 2), (4, 5), (5, 4), (3, 3), (3, 9), (9, 3), (8, 10),
                 (81, 81), (80, 128), (128, 80), (64, 64), (64, 128),
                 (128, 64), (128, 128), (128, 256), (1, 11)):
        assert ntt_ct_cuda.kernel_smem(S, R) == lib.fsi_ct_mma_smem(S, R, 0)
    for m, _ in (p.values[0] for p in MIXED):
        N1, N2 = ntt_ct._split(m // 2)
        q_odd = ntt_ct._odd_prime(m)
        fold = N1 * N2 // q_odd
        assert ntt_ct_cuda.kernel_smem(N1, N2, fold) == \
            lib.fsi_ct_mma_smem(N1, N2, fold), m
    assert lib.fsi_ct_mma_smem(128, 80, 2048) == 167936
    assert lib.fsi_ct_mma_smem(81, 81, 2187) == 196096
    assert lib.fsi_ct_mma_smem(128, 128, 0) == \
        ntt_ct_cuda.kernel_smem(128, 128) == 196608


@pytest.mark.cuda
def test_twiddle_layout_matches_card(cuda):
    """twiddle_in_global, the rule TWIDDLE_GLOBAL counts by, is the
    kernel's layout: fsi_ct_mma_smem is the byte planes (and the fold's
    tail) alone exactly where the rule leaves the twiddle pairs in global
    memory, and the planes with S * tw_stride(R) * 4 bytes of twiddle
    elsewhere; 128 x 128 (m = 2^15) and both orientations of m = 20480
    read the twiddle from global memory, 64 x 64 (m = 8192) does not."""
    lib = cuda_build.library("ct_ntt")
    splits = [(S, R, 0) for S, R in ((64, 64), (64, 128), (128, 64),
                                     (128, 128), (80, 128), (128, 80),
                                     (81, 81), (32, 64), (4, 5))]
    for m, _ in (p.values[0] for p in MIXED):
        N1, N2 = ntt_ct._split(m // 2)
        splits.append((N1, N2, N1 * N2 // ntt_ct._odd_prime(m)))
    for S, R, fold in splits:
        tw = S * ntt_ct_cuda.tw_stride(R) * 4
        glob = ntt_ct_cuda.twiddle_in_global(S, R, fold)
        assert lib.fsi_ct_mma_smem(S, R, fold) == \
            ntt_ct_cuda._planes(S, R, fold) + (0 if glob else tw), (S, R, fold)
    assert [ntt_ct_cuda.twiddle_in_global(*s) for s in (
        (128, 128), (80, 128), (128, 80, 2048), (64, 64))] == [
        True, True, True, False]


@pytest.mark.cuda
def test_schedule_rule_matches_card(cuda):
    """kernel_schedule, the Python mirror, is the rule launch_mma applies
    (fsi_ct_schedule), on the splits of every ring the kernel takes and
    around the rule's edges."""
    lib = cuda_build.library("ct_ntt")
    splits = [(S, R) for S in (2, 3, 32, 64, 80, 81, 128, 192, 256)
              for R in (2, 5, 32, 64, 80, 81, 128, 192)]
    for S, R in splits:
        want = ntt_ct_cuda.kernel_schedule(S, R)
        assert ntt_ct_cuda._SCHEDULE_CODES[lib.fsi_ct_schedule(S, R)] == \
            want, (S, R)
    assert ntt_ct_cuda.kernel_schedule(64, 64) == "pingpong"
    assert lib.fsi_ct_schedule(128, 128) == 2
    assert ntt_ct_cuda.kernel_schedule(128, 128) == "rowsplit"


# (m, N1, N2, phim, q_odd) of the rings whose launches the grid tests
# ask about: m = 2^15 (128 x 128), m = 20480 (forward 80 x 128, inverse
# 128 x 80 with the fold), m = 4096 (forward 32 x 64), all on the sync
# schedule, and m = 8192 on the ping-pong
GRID_RINGS = {32768: (128, 128, 16384, 1), 20480: (128, 80, 8192, 5),
              4096: (64, 32, 2048, 1), 8192: (64, 64, 4096, 1)}


@pytest.mark.cuda
def test_grid_rule_matches_card(cuda):
    """fsi_ct_tiles is sync_tiles (the mirror) of the card's slots on the
    sync schedule, SMs x resident blocks an SM: one block at 128 x 128,
    80 x 128 and 128 x 80, so the slots are the SMs; at m = 8192 the
    ping-pong keeps floor(slots / L).  launch_grid reads the same."""
    lib = cuda_build.library("ct_ntt")
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for m, (N1, N2, phim, q_odd) in GRID_RINGS.items():
        for kind in (0, 1, 2):
            slots = lib.fsi_ct_slots(kind, N1, N2, phim, q_odd)
            assert slots > 0 and slots % sms == 0, (m, kind, slots)
            if m in (32768, 20480):
                assert slots == sms, (m, kind)
            for rows in (1, RAGGED, 128, 192, 256, 768, 1920):
                for L in (1, 8, 12, 13, 23):
                    args = (rows, L, N1, N2, phim, q_odd)
                    got = lib.fsi_ct_tiles(kind, *args)
                    want = (max(slots // L, 1) if m == 8192 else
                            ntt_ct_cuda.sync_tiles(rows, L, slots))
                    assert got == ntt_ct_cuda.tile_grid(rows, want)[0], \
                        (m, kind, args)
                    name = ("ct_fwd", "ct_fwd_digits", "ct_inv")[kind]
                    assert ntt_ct_cuda.launch_grid(name, args, cuda) == (
                        got, -(-rows // got), slots)


def _rebalanced(rows, L, slots) -> bool:
    """The mirror's word on one sync launch: sync_tiles' grid is not the
    one of ceil(slots / L) tiles a prime."""
    new = ntt_ct_cuda.tile_grid(rows, ntt_ct_cuda.sync_tiles(rows, L, slots))
    return new != ntt_ct_cuda.tile_grid(rows, -(-slots // L))


def _transform_launches(monkeypatch) -> list:
    """Record (wrapper, integer arguments, schedule) of every transform
    launch that follows, as ntt_ct_cuda hands it to cuda_build.launch."""
    got, launch = [], ntt_ct_cuda.launch

    def recorded(name, entry, tensors, ints, **kw):
        got.append((name, tuple(ints), kw.get("schedule")))
        return launch(name, entry, tensors, ints, **kw)
    monkeypatch.setattr(ntt_ct_cuda, "launch", recorded)
    return got


def _sync_grids_changed(cuda, launches) -> dict:
    """Each recorded launch runs the sync or the rowsplit schedule on the
    grid of sync_tiles (launch_grid: tiles a prime and rows a tile, as
    ct_ntt.cu launched them); per transform, the launches whose grid that
    differs from ceil(slots / L) tiles a prime."""
    changed = dict.fromkeys(NTT, 0)
    for name, ints, schedule in launches:
        rows, L = ints[:2]
        tiles, per_tile, slots = ntt_ct_cuda.launch_grid(name, ints, cuda)
        assert schedule in ("sync", "rowsplit"), (name, ints)
        assert (tiles, per_tile) == ntt_ct_cuda.tile_grid(
            rows, ntt_ct_cuda.sync_tiles(rows, L, slots)), (name, ints)
        changed[name] += _rebalanced(rows, L, slots)
    return changed


@pytest.mark.cuda
def test_rebalanced_grids_match_plain(cuda, monkeypatch):
    """m = 2^15 on the wide cell's bases (23 primes and 13) at 128 and 192
    rows, row counts whose grid sync_tiles changes on both (on 132 SMs),
    and a count no tile divides: every transform equals its plain version,
    and every launch ran the grid of sync_tiles, which differs from the
    ceil grid on the launches the mirror says."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    dc = DeviceContext(FheContext(**{k: WIDE_CELL[k] for k in (
        "m", "log_q", "p", "generator")}), cuda)
    assert (dc.full["ct"]["q"].shape[0], dc.ksw["ct"]["q"].shape[0]) == (23, 13)
    rows = (128, 192, RAGGED)
    for T in (dc.full, dc.ksw):
        L = T["ct"]["q"].shape[0]
        changed = [_rebalanced(n, L, sms) for n in rows]
        if sms == 132:
            assert changed[:2] == [True, True]
        with monkeypatch.context() as mp:
            launches = _transform_launches(mp)
            _all_transforms_match_plain(cuda, dc.ct_meta, T["ct"], 32768,
                                        "rowsplit", rows=rows)
        # two rounds (random, extremes) a row count, each a forward, a
        # digits and two inverse launches
        n = 2 * sum(changed)
        assert _sync_grids_changed(cuda, launches) == {
            "ct_fwd": n, "ct_fwd_digits": n, "ct_inv": 2 * n}


@pytest.mark.cuda
@pytest.mark.parametrize("ring, want", [
    pytest.param(tuple(WIDE_CELL[k] for k in ("m", "log_q", "p", "generator")),
                 (1, 1, 2), id="m32768-q220"),
    pytest.param((20480, 80, 40961, 3), (0, 1, 0), id="m20480"),
    pytest.param((8192, 80, 40961, 3), (0, 0, 0), id="m8192")])
def test_mul_relin_rebalances_at_the_cells_batch(cuda, monkeypatch, ring,
                                                 want):
    """One mul_relin of the cells' 64 pairs: each sync launch runs the
    grid of sync_tiles, which differs from the ceil grid on the launches
    the mirror predicts from the card's SMs (one block an SM on these
    layouts): on 132 SMs 1, 1, 2 at m = 2^15, 0, 1, 0 at m = 20480 (the
    digits); m = 8192 runs the ping-pong, whose grid is not the rule's;
    still 10 launches a call."""
    m, log_q, p, g = ring
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    ctx = FheContext(m=m, log_q=log_q, p=p, generator=g)
    dev = DeviceContext(ctx, cuda)
    L, Lk = ctx.num_primes, len(ctx.ksw_rows)
    predicted = dict.fromkeys(NTT, 0)
    for name, rows, l in (("ct_fwd", 4 * 64, L),
                          ("ct_fwd_digits", 3 * ctx.ndigits * 64, Lk),
                          ("ct_inv", 3 * 64, L), ("ct_inv", 2 * 64, Lk)):
        predicted[name] += m != 8192 and _rebalanced(rows, l, sms)
    if sms == 132:
        assert tuple(predicted.values()) == want
    gen = torch.Generator().manual_seed(m)
    a, b = (torch.randint(0, 1 << 16, (64, 2, ctx.phim, ctx.n_limbs_ct),
                          generator=gen, dtype=torch.int32).to(cuda)
            for _ in range(2))
    mat = torch.randint(0, 2, (2, 3 * ctx.ndigits, ctx.num_primes, ctx.phim),
                        generator=gen, dtype=torch.int32).to(cuda)
    dev.mul_relin(a, b, mat)
    cuda_build.reset_launches()
    launches = _transform_launches(monkeypatch)
    dev.mul_relin(a, b, mat)
    torch.cuda.synchronize()
    assert [name for name, _, _ in launches] == [
        "ct_fwd", "ct_inv", "ct_fwd_digits", "ct_inv"]
    if m == 8192:
        assert {schedule for _, _, schedule in launches} == {"pingpong"}
    else:
        assert _sync_grids_changed(cuda, launches) == predicted
    assert sum(cuda_build.LAUNCHES.values()) == 10


def _sync_schedule(T, x, meta, which, t2i_key="t2i"):
    """The same transform on the sync schedule (fsi_ct_sync), whatever the
    split: the forward transforms' row [N2][N1], the inverse's [N1][N2]."""
    L = T["q"].shape[0]
    assert x.is_contiguous()
    if which == "inv":
        keys, S, R = ("k_t1i", "k_" + t2i_key, "k_twi", "k_consts"), meta.N1, meta.N2
    else:
        keys, S, R = ("k_t2", "k_t1", "k_tw", "k_consts"), meta.N2, meta.N1
    out = torch.empty(x.shape[:1] + (L, meta.N), dtype=torch.int32,
                      device=x.device)
    err = cuda_build.library("ct_ntt").fsi_ct_sync(
        int(which == "digits"), x.data_ptr(), *(T[k].data_ptr() for k in keys),
        out.data_ptr(), x.shape[0], L, S, R,
        torch.cuda.current_stream().cuda_stream)
    assert err == 0
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("prime_bits", [pytest.param(None, id="narrow"),
                                        pytest.param(23, id="wide")])
def test_pingpong_matches_plain_and_sync(cuda, prime_bits):
    """m = 8192, the benchmark's ring, on the ping-pong schedule: every
    transform (ct_fwd, ct_fwd_digits with digits up to 2^24 - 1, ct_inv
    with t2i and t2i_crt) bit-identical to the plain twin and to the sync
    schedule, on the narrow and the wide lane, on random and worst-case
    operands (every residue q - 1, every digit 2^24 - 1), on 1 row, an odd
    count that no row tile divides and one past a tile a block."""
    dc = DeviceContext(_ctx(8192, 40961, prime_bits), cuda)
    meta = dc.ct_meta
    assert ntt_ct_cuda.kernel_schedule(meta.N2, meta.N1) == "pingpong"
    rng = np.random.default_rng(18)
    cuda_build.reset_launches()
    launches = 0
    for T in (dc.full, dc.ksw):
        ct, q = T["ct"], T["primes_np"].astype(np.int64)
        for rows in (1, RAGGED, 300):
            for worst in (False, True):
                shape = (rows, len(q), meta.phim)
                x = np.broadcast_to(q[:, None] - 1, shape) if worst else \
                    rng.integers(0, q[:, None], size=shape)
                x = torch.as_tensor(np.ascontiguousarray(x, np.int32),
                                    device=cuda)
                d = torch.as_tensor(np.full((rows, meta.phim), (1 << 24) - 1)
                                    if worst else rng.integers(
                                        0, 1 << 24, size=(rows, meta.phim)),
                                    dtype=torch.int32, device=cuda)
                ev = ntt_ct_cuda.ct_fwd(ct, x, meta)
                assert torch.equal(ev, ntt_ct.ct_fwd(ct, x, meta))
                assert torch.equal(ev, _sync_schedule(ct, x, meta, "fwd"))
                for key in ("t2i", "t2i_crt"):
                    z = ntt_ct_cuda.ct_inv(ct, ev, meta, key)
                    assert torch.equal(z, ntt_ct.ct_inv(ct, ev, meta, key))
                    assert torch.equal(z, _sync_schedule(ct, ev, meta, "inv",
                                                         key))
                ed = ntt_ct_cuda.ct_fwd_digits(ct, d, meta, 24)
                assert torch.equal(ed, ntt_ct.ct_fwd_digits(ct, d, meta, 24))
                assert torch.equal(ed, _sync_schedule(ct, d, meta, "digits"))
                launches += 4
    torch.cuda.synchronize()
    assert cuda_build.SCHEDULES == {"pingpong": launches, "sync": 0,
                                    "rowsplit": 0}

# m = 2^15 on the rowsplit schedule: the wide cell's bases (23 and 13
# primes below 2^23) and four narrow primes 1 mod 2^15
ROWSPLIT_BASES = [pytest.param("wide", id="wide-cell"),
                  pytest.param([65537, 163841, 557057, 786433], id="narrow")]


@pytest.mark.cuda
@pytest.mark.parametrize("basis", ROWSPLIT_BASES)
def test_rowsplit_matches_sync(cuda, basis):
    """m = 2^15 (128 x 128) on the rowsplit schedule: every transform
    (ct_fwd, ct_fwd_digits with digits up to 2^24 - 1, ct_inv with t2i
    and, on the cell's bases, t2i_crt) equal limb for limb to the sync
    schedule (fsi_ct_sync)
    on 1, 3, 133 and the cell's 1920 rows, random and, at 133 rows, at the
    extremes (every residue q - 1, every digit 2^24 - 1), and to the plain
    twin on 1 and 3 rows; every wrapper launch ran the rowsplit schedule."""
    if basis == "wide":
        dc = DeviceContext(FheContext(**{k: WIDE_CELL[k] for k in (
            "m", "log_q", "p", "generator")}), cuda)
        meta, tables = dc.ct_meta, [dc.full["ct"], dc.ksw["ct"]]
        assert [t["q"].shape[0] for t in tables] == [23, 13]
    else:
        meta, T = _kernel_tables(cuda, 1 << 15, basis)
        tables = [T]
    assert (meta.N1, meta.N2) == (128, 128)
    assert ntt_ct_cuda.kernel_schedule(128, 128) == "rowsplit"
    rng = np.random.default_rng(26)
    cuda_build.reset_launches()
    launches = 0
    for ct in tables:
        q = ct["q"].cpu().numpy().astype(np.int64)
        # the cell's bases carry t2i_crt, bare tables only t2i
        keys = [k for k in ("t2i", "t2i_crt") if "k_" + k in ct]
        assert len(keys) == (2 if basis == "wide" else 1)
        for rows, worst in ((1, False), (3, False), (133, False),
                            (133, True), (1920, False)):
            x, d = _operands(cuda, rng, q, rows, meta.phim, worst)
            ev = ntt_ct_cuda.ct_fwd(ct, x, meta)
            assert torch.equal(ev, _sync_schedule(ct, x, meta, "fwd"))
            ed = ntt_ct_cuda.ct_fwd_digits(ct, d, meta, 24)
            assert torch.equal(ed, _sync_schedule(ct, d, meta, "digits"))
            for key in keys:
                z = ntt_ct_cuda.ct_inv(ct, ev, meta, key)
                assert torch.equal(z, _sync_schedule(ct, ev, meta, "inv", key))
                if rows <= 3:
                    assert torch.equal(z, ntt_ct.ct_inv(ct, ev, meta, key))
            if rows <= 3:
                assert torch.equal(ev, ntt_ct.ct_fwd(ct, x, meta))
                assert torch.equal(ed, ntt_ct.ct_fwd_digits(ct, d, meta, 24))
            launches += 2 + len(keys)
            del x, d, ev, ed, z
    torch.cuda.synchronize()
    assert cuda_build.SCHEDULES == {"pingpong": 0, "sync": 0,
                                    "rowsplit": launches}


@pytest.mark.cuda
def test_split_with_a_side_of_one_raises(cuda):
    """m = 22 with use_ct forced splits N = 11 as 11 x 1: on the card the
    wrappers raise with the shape and launch nothing; the CPU takes the
    plain version (test_torch_context.py)."""
    ctx = FheContext(m=22, log_q=80, p=23, generator=7)
    ctx.use_ct = True
    dc = DeviceContext(ctx, cuda)
    T, meta = dc.full["ct"], dc.ct_meta
    x = torch.zeros((2, dc.L, dc.phim), dtype=torch.int32, device=cuda)
    cuda_build.reset_launches()
    for fn in (ntt_ct_cuda.ct_fwd, ntt_ct_cuda.ct_inv):
        with pytest.raises(ValueError,
                           match=r"\(2, 10, 10\) \(N1 x N2 = 11 x 1\)"):
            fn(T, x, meta)
    with pytest.raises(ValueError, match=r"\(2, 10\) \(N1 x N2 = 11 x 1\)"):
        ntt_ct_cuda.ct_fwd_digits(dc.ksw["ct"], x[:, 0], meta, 24)
    assert not any(_launched(NTT).values())


# rings whose split the kernel cannot take (N x 1): the matmul route
ROUTE_RINGS = [pytest.param((dict(m=22, log_q=80, p=23, generator=7), True),
                            id="m22-forced"),
               pytest.param((dict(m=4126, log_q=80, p=4127, generator=5),
                             False), id="m4126")]


@pytest.mark.cuda
@pytest.mark.parametrize("ring", ROUTE_RINGS)
def test_matmul_route_on_card_equals_cpu(cuda, ring):
    """m = 22 with use_ct forced (11 x 1) and the reference's m = 4126
    (2063 x 1) ride the matmul route: its transforms of every basis and
    the mul+relin round on the card equal the CPU's, and no transform
    kernel launches."""
    from fhe_si_tpu_torch.ops import ntt_ct_matmul
    kw, force = ring
    ctx = FheContext(**kw)
    ctx.use_ct = ctx.use_ct or force
    gpu, cpu = DeviceContext(ctx, cuda), DeviceContext(ctx, "cpu")
    assert gpu.ct_route == cpu.ct_route == "matmul"
    meta = gpu.ct_meta
    rng = np.random.default_rng(ctx.m)
    cuda_build.reset_launches()
    ntt_ct_matmul.reset_calls()
    for basis in ("full", "ksw", "lin"):
        Tg, Tc = getattr(gpu, basis), getattr(cpu, basis)
        q = Tc["primes_np"]
        x = torch.as_tensor(rng.integers(0, q[:, None], size=(
            RAGGED, len(q), meta.phim)).astype(np.int32))
        d = torch.as_tensor(rng.integers(0, 1 << 24, size=(
            RAGGED, meta.phim)).astype(np.int32))
        ev = gpu._fwd_t(Tg, x.to(cuda))
        assert torch.equal(ev.cpu(), cpu._fwd_t(Tc, x))
        assert torch.equal(gpu._inv_crt_t(Tg, ev).cpu(),
                           cpu._inv_crt_t(Tc, ev.cpu()))
        assert torch.equal(
            ntt_ct_matmul.ct_fwd_digits(Tg["ct"], d.to(cuda), meta, 24).cpu(),
            ntt_ct_matmul.ct_fwd_digits(Tc["ct"], d, meta, 24))
    x = torch.as_tensor(rng.integers(0, ctx.primes[:, None], size=(
        RAGGED, gpu.L, meta.phim)).astype(np.int32), device=cuda)
    assert torch.equal(gpu.ntt_inv(gpu.ntt_fwd(x)), x)
    (cpu_parts, _, _), (parts, _, launched) = (_slice_round(ctx, "cpu"),
                                               _slice_round(ctx, cuda))
    torch.cuda.synchronize()
    assert torch.equal(cpu_parts, parts)
    assert not any(launched[k] for k in NTT)
    assert all(launched[k] for k in CRT + MODULAR)
    assert all(ntt_ct_matmul.CALLS.values())


# the route cell's ring (bench_port/configs/route8146_q188.json): 4073 x 1,
# 23 narrow primes, 13 on the keyswitch basis, 8 digits
ROUTE_CELL = bench_cell.load("route8146_q188.b64").config["context"]
ROUTE = ("route_enter", "route_leave")


@functools.cache
def _route_cell_tables():
    """The route cell's folded twiddles on the host, as
    ntt_ct_matmul.stage_operands makes them (route_cuda.folded_table),
    for the full chain and the keyswitch basis: {basis: (meta, q, tw_t2,
    twi_t2i, twi_t2i_crt)}, numpy."""
    from fhe_si_tpu_torch.ops import route_cuda
    ctx = FheContext(**ROUTE_CELL)
    meta, ct = ntt_ct.ct_tables(ctx.m, ctx.primes, ctx.roots)
    out = {}
    for basis, rows, binv in (
            ("full", np.arange(ctx.num_primes), ctx.fast_crt_tables["binv"]),
            ("ksw", ctx.ksw_rows, ctx.ksw_fast_crt_tables["binv"])):
        tabs = ntt_ct.with_crt_premultiplier(
            {k: v[rows] for k, v in ct.items()}, binv)
        q = tabs["q"].astype(np.int64)
        out[basis] = (meta, q) + tuple(
            route_cuda.folded_table(tabs[tw][..., 0], tabs[k][:, 0, 0], q)
            for tw, k in (("tw", "t2"), ("twi", "t2i"), ("twi", "t2i_crt")))
    return out


# the route cell's four transforms at batch 64: (enter mode, basis, rows)
ROUTE_STEPS = [pytest.param("fwd", "full", 4 * 64, id="fwd-256x23"),
               pytest.param("inv", "full", 3 * 64, id="inv-192x23"),
               pytest.param("inv", "ksw", 2 * 64, id="inv-128x13"),
               pytest.param("fwd_digits", "ksw", 3 * 8 * 64,
                            id="digits-1536x13")]


@pytest.mark.cuda
@pytest.mark.parametrize("mode,basis,rows", ROUTE_STEPS)
def test_route_boundary_kernels_match_plain(cuda, mode, basis, rows):
    """route_enter_kernel and route_leave_kernel (csrc/route.cu) at the
    route cell's shapes against their plain versions on the CPU, bit for
    bit: residues at q - 1 and digits at 2^24 - 1 in row 0, the padded
    column and the excluded evaluation (enter); GEMM outputs random below
    N (q - 1)^2 with row 0 at that top, the dropped evaluation and the
    folded columns with both inverse tables (leave).  One launch each."""
    from fhe_si_tpu_torch.ops import route_cuda
    meta, q, tw, twi, twi_crt = _route_cell_tables()[basis]
    L, N = len(q), meta.N
    rng = np.random.default_rng(rows * L)
    qc = torch.as_tensor(q.astype(np.int32)[:, None])
    if mode == "fwd_digits":
        x = rng.integers(0, 1 << 24, (rows, meta.phim))
        x[0] = (1 << 24) - 1
    else:
        x = rng.integers(0, q[:, None], (rows, L, meta.phim))
        x[0] = q[:, None] - 1
    x = torch.as_tensor(x.astype(np.int32))
    tab = None if mode == "inv" else torch.as_tensor(tw)
    cuda_build.reset_launches()
    y = route_cuda.enter(x.to(cuda), None if tab is None else tab.to(cuda),
                         qc.to(cuda), meta, mode)
    assert torch.equal(y.cpu(), route_cuda.enter_plain(x, tab, qc, meta, mode))
    top = N * (q - 1) ** 2
    z = (rng.random((L, N, rows)) * top[:, None, None]).astype(np.int64)
    z[..., 0] = top[:, None]
    z = torch.as_tensor(z.astype(np.float64))
    leave = "fwd" if mode == "fwd_digits" else mode
    tabs = [None] if leave == "fwd" else [torch.as_tensor(twi),
                                          torch.as_tensor(twi_crt)]
    for t in tabs:
        got = route_cuda.leave(z.to(cuda), None if t is None else t.to(cuda),
                               qc.to(cuda), meta, leave)
        assert torch.equal(got.cpu(),
                           route_cuda.leave_plain(z, t, qc, meta, leave))
    torch.cuda.synchronize()
    assert _launched(ROUTE) == {"route_enter": 1, "route_leave": len(tabs)}


@pytest.mark.cuda
@pytest.mark.parametrize("ring", ROUTE_RINGS)
def test_mul_relin_route_launches_boundary_kernels(cuda, ring):
    """One mul_relin on the route's folded form (11 x 1 forced, 2063 x 1)
    runs each of its four transforms as one route_enter launch, one GEMM
    (PRODUCTS: one a transform) and one route_leave launch, no transform
    kernel, and equals the CPU's step."""
    from fhe_si_tpu_torch.ops import ntt_ct_matmul
    kw, force = ring
    ctx = FheContext(**kw)
    ctx.use_ct = ctx.use_ct or force
    dev, cpu = DeviceContext(ctx, cuda), DeviceContext(ctx, "cpu")
    assert "tw_t2" in dev.full["ct"]
    gen = torch.Generator().manual_seed(ctx.m)
    a, b = (torch.randint(0, 1 << 16, (2, 2, ctx.phim, ctx.n_limbs_ct),
                          generator=gen, dtype=torch.int32) for _ in range(2))
    mat = torch.randint(0, 2, (2, 3 * ctx.ndigits, ctx.num_primes, ctx.phim),
                        generator=gen, dtype=torch.int32)
    cuda_build.reset_launches()
    ntt_ct_matmul.reset_calls()
    ntt_ct_matmul.reset_products()
    got = dev.mul_relin(a.to(cuda), b.to(cuda), mat.to(cuda))
    torch.cuda.synchronize()
    assert _launched(ROUTE) == {"route_enter": 4, "route_leave": 4}
    assert not any(_launched(NTT).values())
    assert ntt_ct_matmul.CALLS == {"ct_fwd": 1, "ct_fwd_digits": 1,
                                   "ct_inv": 2}
    assert ntt_ct_matmul.PRODUCTS == ntt_ct_matmul.CALLS
    assert torch.equal(got.cpu(), cpu.mul_relin(a, b, mat))


@pytest.mark.cuda
def test_route_boundary_kernel_refusals(cuda):
    """The wrappers raise, with the shape, before any launch: a split
    that is not N x 1, an operand of the wrong type or shape, a table of
    the wrong shape, more primes than the kernels take."""
    from fhe_si_tpu_torch.ops import route_cuda
    meta = ntt_ct.CtMeta(11, 1, 10, 11)
    q = torch.full((3, 1), 23, dtype=torch.int32, device=cuda)
    tab = torch.zeros((2, 3, 11), dtype=torch.int32, device=cuda)
    x = torch.zeros((2, 3, 10), dtype=torch.int32, device=cuda)
    z = torch.zeros((3, 11, 2), dtype=torch.float64, device=cuda)
    cuda_build.reset_launches()
    with pytest.raises(ValueError, match=r"route_enter: input \(2, 3, 10\).*"
                       r"N x 1"):
        route_cuda.enter(x, tab, q, ntt_ct.CtMeta(5, 2, 10, 11), "fwd")
    with pytest.raises(ValueError, match=r"route_enter: input \(2, 3, 10\) "
                       r"torch.int64"):
        route_cuda.enter(x.long(), tab, q, meta, "fwd")
    with pytest.raises(ValueError, match=r"route_enter: input \(2, 3, 10\)"):
        route_cuda.enter(x, tab, q, meta, "fwd_digits")
    with pytest.raises(ValueError, match=r"route_leave: table \(2, 3, 10\)"):
        route_cuda.leave(z, tab[..., :10], q, meta, "inv")
    with pytest.raises(ValueError, match=r"route_leave: input \(3, 11, 2\) "
                       r"torch.float32"):
        route_cuda.leave(z.float(), tab, q, meta, "inv")
    wide = torch.full((65, 1), 23, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="65 primes"):
        route_cuda.leave(z, None, wide, meta, "fwd")
    assert not any(_launched(ROUTE).values())


@pytest.mark.cuda
def test_mixed_radix_slice_on_card_equals_cpu(cuda):
    """m = 160 with use_ct forced (tests/test_ct_scheme.py:151-159): the
    mul+relin round on the card launches every kernel and equals the
    CPU's."""
    ctx = FheContext(m=160, log_q=80, p=641, generator=3)
    ctx.use_ct = True
    (cpu_parts, _, _), (parts, _, launched) = (_slice_round(ctx, "cpu"),
                                               _slice_round(ctx, cuda))
    assert all(n > 0 for n in launched.values())
    assert torch.equal(cpu_parts, parts)


def _slice_round(ctx, device):
    """keygen, relinearization key, batched encrypt of 2 pairs, mul+relin
    and decrypt on `device`: (parts on the CPU, decrypts, launches)."""
    dev = DeviceContext(ctx, device)
    src = sampling.RandomSource(5)
    sk, pk = scheme.keygen(dev, src)
    ksw = scheme.KeySwitch.for_relinearization(sk, src)
    msgs = [src.uniform_mod_p(ctx.phim, ctx.p) for _ in range(4)]
    cts = pk.encrypt_batch([scheme.Plaintext(ctx, mm) for mm in msgs], src)
    cuda_build.reset_launches()
    out = scheme.relin_batch(scheme.mul_batch(list(zip(cts[0::2],
                                                       cts[1::2]))), ksw)
    dec = sk.decrypt_batch(out)
    for i in range(2):
        assert np.array_equal(dec[i].message, oracle.plaintext_mul(
            ctx, msgs[2 * i], msgs[2 * i + 1]))
    return (torch.stack([c.parts for c in out]).cpu(), dec,
            _launched(NTT + CRT + MODULAR))


@pytest.mark.cuda
@pytest.mark.parametrize("mp", CONFIGS)
def test_slice_on_card_equals_cpu(cuda, mp):
    ctx = _ctx(*mp)
    (cpu_parts, _, _), (parts, _, launched) = (_slice_round(ctx, "cpu"),
                                               _slice_round(ctx, cuda))
    assert all(n > 0 for n in launched.values())       # the card's run
    assert torch.equal(cpu_parts, parts)


@pytest.mark.cuda
def test_decomp4_on_card_equals_cpu(cuda):
    """decompSize 4 on a Cooley-Tukey ring: the 32-bit digits become
    residues by the plane Horner and take the ct_fwd kernel, not
    ct_fwd_digits."""
    ctx = FheContext(m=256, log_q=80, p=257, generator=3, decomp_size=4)
    (cpu_parts, _, _), (parts, _, launched) = (_slice_round(ctx, "cpu"),
                                               _slice_round(ctx, cuda))
    assert torch.equal(cpu_parts, parts)
    assert launched["ct_fwd_digits"] == 0
    assert launched["ct_fwd"] > 0 and launched["ct_inv"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", DENSE)
def test_dense_on_card_equals_cpu(cuda, cfg):
    """The dense transforms (forward, raw inverse and the prescaled
    inverse of every basis) on the card equal the same function on the
    CPU bit for bit, and so does a mul+relin round, which launches no
    Cooley-Tukey kernel."""
    m, log_q, p, g, prime_bits = cfg
    ctx = FheContext(m=m, log_q=log_q, p=p, generator=g,
                     prime_bits=prime_bits)
    cpu, card = DeviceContext(ctx, "cpu"), DeviceContext(ctx, cuda)
    rng = np.random.default_rng(m)
    for Tc, Tg in ((cpu.full, card.full), (cpu.ksw, card.ksw),
                   (cpu.lin, card.lin)):
        q = Tc["primes_np"]
        x = torch.as_tensor(rng.integers(0, q[:, None], size=(
            RAGGED, len(q), ctx.phim)).astype(np.int32))
        for op_c, op_g in ((cpu._fwd_t, card._fwd_t),
                           (cpu._inv_crt_t, card._inv_crt_t)):
            assert torch.equal(op_g(Tg, x.to(cuda)).cpu(), op_c(Tc, x))
    x = torch.as_tensor(rng.integers(0, ctx.primes[:, None], size=(
        2, 3, ctx.num_primes, ctx.phim)).astype(np.int32))
    assert torch.equal(card.ntt_fwd(x.to(cuda)).cpu(), cpu.ntt_fwd(x))
    assert torch.equal(card.ntt_inv(x.to(cuda)).cpu(), cpu.ntt_inv(x))
    (cpu_parts, _, _), (parts, _, launched) = (_slice_round(ctx, "cpu"),
                                               _slice_round(ctx, cuda))
    assert torch.equal(cpu_parts, parts)
    assert all(launched[k] == 0 for k in NTT)
    assert all(launched[k] > 0 for k in CRT + MODULAR)


@pytest.mark.cuda
@pytest.mark.parametrize("app", ["regression", "statistics"])
def test_app_cli_on_card_matches(cuda, app, tmp_path, capsys):
    """The app CLIs on the card at m = 32 reach MATCH, launching all three
    kernels (the m = 8192 runs are chip_smoke.py's phase 6)."""
    import importlib
    from fhe_si_tpu_torch.cli.gen_data import generate
    cli = importlib.import_module(f"fhe_si_tpu_torch.cli.test_{app}")
    path = str(tmp_path / "data.txt")
    generate(path, 2, 16, seed=5)
    cuda_build.reset_launches()
    assert cli.main(["x", path, "97", "3", "7", "--m=32",
                     f"--device={cuda}"]) == 0
    assert capsys.readouterr().out.rstrip().endswith("MATCH")
    assert all(n > 0 for n in _launched(NTT).values())


def _crt_contexts():
    """The main ring (narrow) and the regression app's context at m = 8192
    (logQ 213, wide: the largest reconstruction width, 35 limbs)."""
    from fhe_si_tpu_torch.apps import regression
    log_q, xi = regression.derive_log_q(256, 4, 40961)
    return [dict(m=8192, log_q=80, p=40961, generator=3),
            dict(m=8192, log_q=log_q, p=40961, generator=3, xi=xi)]


@pytest.mark.cuda
@pytest.mark.parametrize("which", [0, 1], ids=["m8192", "m8192-logq213-wide"])
def test_crt_kernels_match_plain(cuda, which):
    """Both limb/CRT kernels in every mode (partials, finish and to_limbs,
    each reconstruction without a tail, with ScaleDown's and with the
    signed reduction; the lift at the ciphertext and the reconstruction
    widths) against their plain versions on the card, on every basis, on
    random and worst-case inputs (every residue q - 1, every limb
    0xFFFF), bit for bit."""
    dc = DeviceContext(FheContext(**_crt_contexts()[which]), cuda)
    assert dc.wide == bool(which)
    rng = np.random.default_rng(9)
    cuda_build.reset_launches()
    for T in {id(T): T for T in (dc.full, dc.ksw, dc.lin)}.values():
        q, fc = T["primes_np"], T["fast_crt"]
        res = rng.integers(0, q[:, None], size=(RAGGED, len(q), dc.phim))
        res[0] = q[:, None] - 1
        res = torch.as_tensor(res.astype(np.int32), device=cuda)
        part = crt_cuda.crt_partials(res, fc, dc.wide)
        for got, want in zip(part, crt_cuda.crt_partials_plain(res, fc,
                                                               dc.wide)):
            assert torch.equal(got, want)
        for tail in (None, dc.tail("round_down"), dc.tail("reduce_signed")):
            want = crt_cuda.crt_to_limbs_plain(res, fc, dc.wide, tail)
            assert torch.equal(crt_cuda.crt_to_limbs(res, fc, dc.wide, tail),
                               want)
            assert torch.equal(crt_cuda.crt_finish(*part, fc, dc.wide, tail),
                               want)
        for n in (dc.n_ct, fc["B"].shape[-1]):
            poly = rng.integers(0, 1 << 16, size=(RAGGED, dc.phim, n))
            poly[0] = 0xFFFF
            args = (torch.as_tensor(poly.astype(np.int32), device=cuda),
                    T["chunk_tbl"], dc._wrap_const(q, n), T["q"], T["qinv_f"],
                    dc.wide)
            assert torch.equal(crt_cuda.limbs_to_residues(*args),
                               crt.limbs_to_residues(*args))
    torch.cuda.synchronize()
    assert all(n > 0 for n in _launched(CRT).values())


def _synthetic_basis(rows, n, bits, worst, rng, device):
    """Basis tables of `rows` rows (the `rows` largest primes below 2^bits,
    m_r the largest, its row last in er_mask) and n limbs on `device`,
    made as FheContext._fast_crt_for makes them (Bh, P_limbs_sh10: B and
    P << 10 mod 2^16n): every limb of B and P 0xFFFF (worst) or random.
    Returns (primes, tables with k_crt)."""
    from fhe_si_tpu_torch.context import int_to_limbs
    from fhe_si_tpu_torch.hostmath import numbth
    primes, x = [], (1 << bits) - 1
    while len(primes) < rows:
        if numbth.is_prime(x):
            primes.append(x)
        x -= 1
    primes = np.array(primes, np.int64)
    mr, top = int(primes[0]), 1 << (16 * n)
    ints = [top - 1 if worst else int.from_bytes(rng.bytes(2 * n), "little")
            for _ in range(rows + 1)]
    er_mask = np.zeros(rows, np.int64)
    er_mask[-1] = 1
    fc = dict(B=[int_to_limbs(b, n) for b in ints[:rows]],
              Bh=[int_to_limbs((b << 10) % top, n) for b in ints[:rows]],
              Bmodr=(np.full(rows, mr - 1) if worst
                     else rng.integers(0, mr, size=rows)),
              er_mask=er_mask, P_limbs=int_to_limbs(ints[rows], n),
              P_limbs_sh10=int_to_limbs((ints[rows] << 10) % top, n), mr=mr,
              Pinv_r=mr - 1 if worst else int(rng.integers(1, mr)),
              binv=np.ones(rows, np.int64))
    fc = {k: np.asarray(v, np.int64) for k, v in fc.items()}
    t = {k: torch.as_tensor(v.astype(np.int32), device=device)
         for k, v in fc.items()}
    t["mrinv_f"] = torch.as_tensor(np.float32(1.0 / mr), device=device)
    t["k_crt"] = torch.as_tensor(crt_cuda.kernel_table(fc), device=device)
    return primes, t


@pytest.mark.cuda
@pytest.mark.parametrize("n", [17, 48])
@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_crt_pass_kernel_at_its_widths(cuda, wide, n):
    """The one-pass kernel (crt_to_limbs) at 64 residue rows on synthetic
    bases of primes just below 2^20 or 2^23, at n = 17 (odd: one limb in
    the last word) and 48 (the largest), without a tail and with each,
    against its plain version; the partials and the finish against the
    plain partials and finish element for element.  Worst-case tables
    (every limb 0xFFFF) with every residue q - 1, then random ones, at a
    phim that leaves a ragged tile."""
    rng = np.random.default_rng(20)
    rows, width = cuda_build.MAX_ROWS, n - 3
    cuda_build.reset_launches()
    for worst in (True, False):
        primes, t = _synthetic_basis(rows, n, 23 if wide else 20, worst, rng,
                                     cuda)
        res = rng.integers(0, primes[:, None], size=(5, rows, 1000))
        res[0] = primes[:, None] - 1
        res = torch.as_tensor(res.astype(np.int32), device=cuda)
        part = crt_cuda.crt_partials(res, t, wide)
        for got, want in zip(part, crt_cuda.crt_partials_plain(res, t, wide)):
            assert torch.equal(got, want)
        for kind in (None, "round_down", "reduce_signed"):
            tail = crt_cuda.Tail(kind, 16 * width - 5, width) if kind else None
            want = crt_cuda.crt_to_limbs_plain(res, t, wide, tail)
            assert torch.equal(crt_cuda.crt_to_limbs(res, t, wide, tail), want)
            assert torch.equal(crt_cuda.crt_finish(*part, t, wide, tail), want)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["crt_to_limbs"] == 2 * (1 + 2 * 3)


@pytest.mark.cuda
@pytest.mark.parametrize("which", [0, 1], ids=["m8192", "m8192-logq213-wide"])
def test_two_source_lift_on_card(cuda, which):
    """limbs_to_residues with a second limb tensor (the operands of
    _tensor_mul, each read in place) against the plain lift of the two
    joined, at the ciphertext width and the reconstruction width, with
    every limb 0xFFFF in one part and negative values."""
    dc = DeviceContext(FheContext(**_crt_contexts()[which]), cuda)
    rng = np.random.default_rng(21)
    T, q = dc.full, dc.full["primes_np"]
    cuda_build.reset_launches()
    for n in (dc.n_ct, T["fast_crt"]["B"].shape[-1]):
        a = rng.integers(0, 1 << 16, size=(RAGGED, 2, dc.phim, n))
        b = rng.integers(0, 1 << 16, size=(RAGGED, 3, dc.phim, n))
        a[0, 0] = 0xFFFF
        b[1, :, :, -1] |= 0x8000
        a, b = (torch.as_tensor(x.astype(np.int32), device=cuda)
                for x in (a, b))
        args = (T["chunk_tbl"], dc._wrap_const(q, n), T["q"], T["qinv_f"],
                dc.wide)
        assert torch.equal(crt_cuda.limbs_to_residues(a, *args, second=b),
                           crt.limbs_to_residues(torch.cat([a, b], dim=-3),
                                                 *args))
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["limbs_to_residues"] == 2


@pytest.mark.cuda
def test_mul_relin_lifts_two_sources_without_cat(cuda, monkeypatch):
    """DeviceContext.mul_relin on the card lifts both operands with one
    two-source limbs_to_residues, and no torch.cat runs before it (the
    operands are not joined); the output equals the CPU's."""
    ctx = _ctx(256, 257, None)
    events = []
    cat, lift = torch.cat, crt_cuda.limbs_to_residues

    def counted_cat(*args, **kw):
        events.append("cat")
        return cat(*args, **kw)

    def counted_lift(poly, chunk_tbl, wrap, q, qinv_f, wide=False,
                     second=None):
        events.append(("lift", second is not None and poly.is_cuda))
        return lift(poly, chunk_tbl, wrap, q, qinv_f, wide, second)
    outs = []
    for device in ("cpu", cuda):
        dev = DeviceContext(ctx, device)
        src = sampling.RandomSource(7)
        sk, pk = scheme.keygen(dev, src)
        ksw = scheme.KeySwitch.for_relinearization(sk, src)
        cts = pk.encrypt_batch([scheme.Plaintext(ctx, src.uniform_mod_p(
            ctx.phim, ctx.p)) for _ in range(4)], src)
        a = torch.stack([c.parts for c in cts[0::2]])
        b = torch.stack([c.parts for c in cts[1::2]])
        events.clear()
        with monkeypatch.context() as mp:
            mp.setattr(torch, "cat", counted_cat)
            mp.setattr(crt_cuda, "limbs_to_residues", counted_lift)
            outs.append(dev.mul_relin(a, b, ksw.matrix_evals).cpu())
    torch.cuda.synchronize()
    assert events[0] == ("lift", True)
    assert torch.equal(*outs)


@pytest.mark.cuda
@pytest.mark.parametrize("ring", [pytest.param((256, 80, 257, 3), id="m256"),
                                  pytest.param((22, 80, 23, 7), id="m22")])
def test_mul_relin_wrapper_spans_equal_launches(cuda, ring):
    """One mul_relin on the card under profiling.counting(): each kernel
    wrapper's span count equals its LAUNCHES delta, and the step runs 15
    spans on either family."""
    from fhe_si_tpu_torch import profiling
    m, log_q, p, g = ring
    ctx = FheContext(m=m, log_q=log_q, p=p, generator=g)
    dev = DeviceContext(ctx, cuda)
    a, b = (torch.randint(0, 1 << 16, (2, 2, ctx.phim, ctx.n_limbs_ct),
                          dtype=torch.int32, device=cuda) for _ in range(2))
    mat = torch.randint(0, 2, (2, 3 * ctx.ndigits, ctx.num_primes, ctx.phim),
                        dtype=torch.int32, device=cuda)
    dev.mul_relin(a, b, mat)
    cuda_build.reset_launches()
    with profiling.counting() as table:
        dev.mul_relin(a, b, mat)
    torch.cuda.synchronize()
    launched = dict(cuda_build.LAUNCHES)
    assert {k: table.get("fhe." + k, [0])[0] for k in launched} == launched
    assert sum(launched.values()) > 0
    assert sum(n for n, _ in table.values()) == 15


# the hand-written kernels, each with the wrapper spans that launch it
KERNEL_SPANS = {
    "ct_mma_kernel": ("fhe.ct_fwd", "fhe.ct_fwd_digits", "fhe.ct_inv"),
    "crt_pass_kernel": ("fhe.crt_to_limbs",),
    "crt_kernel": ("fhe.crt_to_limbs",),
    "lift_kernel": ("fhe.limbs_to_residues",),
    "tensor_product_kernel": ("fhe.tensor_product",),
    "keyswitch_dot_kernel": ("fhe.keyswitch_dot",),
    "byte_decomp_kernel": ("fhe.byte_decomp",),
    "route_enter_kernel": ("fhe.route_enter",),
    "route_leave_kernel": ("fhe.route_leave",)}
HAND_WRITTEN = re.compile(r"\b(" + "|".join(KERNEL_SPANS) + r")\b")


@pytest.mark.cuda
@pytest.mark.parametrize("ring, use_ct", [
    pytest.param((256, 80, 257, 3), None, id="m256-ct"),
    pytest.param((22, 80, 23, 7), None, id="m22-dense"),
    pytest.param((22, 80, 23, 7), True, id="m22-route")])
def test_mul_relin_kernels_carry_their_wrapper_span(cuda, ring, use_ct):
    """One mul_relin on the card under a capture, parsed as the benchmark
    parses it (bench_port.trace): every hand-written kernel's op is the
    fhe.* span of the wrapper that launched it, and each wrapper's span
    tags as many device operations as cuda_build.LAUNCHES counts for it,
    on the Cooley-Tukey kernel (m = 256), the dense family (m = 22) and
    the matmul route (m = 22 with use_ct forced)."""
    from bench_port import trace as bench_trace
    m, log_q, p, g = ring
    ctx = FheContext(m=m, log_q=log_q, p=p, generator=g)
    if use_ct is not None:
        ctx.use_ct = use_ct
    dev = DeviceContext(ctx, cuda)
    if use_ct:
        assert dev.ct_route == "matmul"
    a, b = (torch.randint(0, 1 << 16, (2, 2, ctx.phim, ctx.n_limbs_ct),
                          dtype=torch.int32, device=cuda) for _ in range(2))
    mat = torch.randint(0, 2, (2, 3 * ctx.ndigits, ctx.num_primes, ctx.phim),
                        dtype=torch.int32, device=cuda)
    dev.mul_relin(a, b, mat)
    torch.cuda.synchronize()
    cuda_build.reset_launches()

    def call(_):
        with torch.profiler.record_function(bench_trace.CALL):
            dev.mul_relin(a, b, mat)
            torch.cuda.synchronize()
    tr = bench_trace.capture(call, 1)
    launched = {"fhe." + k: n for k, n in cuda_build.LAUNCHES.items() if n}
    hand = [o for o in tr.ops if HAND_WRITTEN.search(o.name)]
    assert hand
    for o in hand:
        kernel = HAND_WRITTEN.search(o.name).group(1)
        assert o.op in KERNEL_SPANS[kernel], (o.name, o.op)
    assert Counter(o.op for o in hand) == launched
    assert Counter(o.op for o in tr.ops if o.op.startswith("fhe.")) == launched


@pytest.mark.cuda
@pytest.mark.parametrize("ring, fused, tw_global, schedule", [
    pytest.param((20480, 80, 40961, 3), 1, 1, "sync", id="m20480"),
    pytest.param((8192, 80, 40961, 3), 0, 0, "pingpong", id="m8192"),
    pytest.param(tuple(WIDE_CELL[k] for k in ("m", "log_q", "p", "generator")),
                 0, 1, "rowsplit", id="m32768-q220")])
def test_mul_relin_does_the_phim_steps_in_the_kernel(cuda, ring, fused,
                                                     tw_global, schedule):
    """One mul_relin on the card on the mixed cell's ring: no plain
    phim <-> N step runs (PHIM_STEPS all 0), the transforms' four
    launches did them (PHIM_FUSED 1, 1 and 2), and the call is 11 device
    operations (launches_per_step), as on m = 8192, where PHIM_FUSED
    reads 0, and on the wide cell's ring m = 2^15 at logQ 220 (23 wide
    primes, 10 digits).  TWIDDLE_GLOBAL counts the four transform launches
    (1, 1 and 2) on the rings whose layouts leave the twiddle in global
    memory (m = 20480, m = 2^15) and none at m = 8192; every transform
    runs the ring's one schedule.  The output equals the CPU's."""
    from bench_port import trace as bench_trace
    m, log_q, p, g = ring
    ctx = FheContext(m=m, log_q=log_q, p=p, generator=g)
    dev, cpu = DeviceContext(ctx, cuda), DeviceContext(ctx, "cpu")
    gen = torch.Generator().manual_seed(m)
    a, b = (torch.randint(0, 1 << 16, (2, 2, ctx.phim, ctx.n_limbs_ct),
                          generator=gen, dtype=torch.int32) for _ in range(2))
    mat = torch.randint(0, 2, (2, 3 * ctx.ndigits, ctx.num_primes, ctx.phim),
                        generator=gen, dtype=torch.int32)
    ac, bc, mc = a.to(cuda), b.to(cuda), mat.to(cuda)
    dev.mul_relin(ac, bc, mc)
    ntt_ct.reset_phim_steps()
    ntt_ct_cuda.reset_phim_fused()
    ntt_ct_cuda.reset_twiddle_global()
    cuda_build.reset_launches()

    def call(_):
        with torch.profiler.record_function(bench_trace.CALL):
            out = dev.mul_relin(ac, bc, mc)
            torch.cuda.synchronize()
        return out
    tr = bench_trace.capture(call, 1)
    assert set(ntt_ct.PHIM_STEPS.values()) == {0}
    assert ntt_ct_cuda.PHIM_FUSED == {"ct_fwd": fused, "ct_fwd_digits": fused,
                                      "ct_inv": 2 * fused}
    assert ntt_ct_cuda.TWIDDLE_GLOBAL == {
        "ct_fwd": tw_global, "ct_fwd_digits": tw_global,
        "ct_inv": 2 * tw_global}
    assert cuda_build.SCHEDULES == {k: 4 * (k == schedule)
                                    for k in cuda_build.SCHEDULES}
    assert sum(cuda_build.LAUNCHES.values()) == 10
    assert tr.calls == 1 and len(tr.ops) == 11, [o.name for o in tr.ops]
    assert torch.equal(dev.mul_relin(ac, bc, mc).cpu(),
                       cpu.mul_relin(a, b, mat))


@pytest.mark.cuda
@pytest.mark.parametrize("ring", [pytest.param((256, 80, 257, 3), id="m256"),
                                  pytest.param((22, 80, 23, 7), id="m22"),
                                  pytest.param((8192, 80, 40961, 3),
                                               id="m8192")])
def test_mul_relin_launches_byte_decomp_once(cuda, ring):
    """One mul_relin on the card, on either family, splits its digits with
    one byte_decomp launch, and its output equals the CPU's."""
    m, log_q, p, g = ring
    ctx = FheContext(m=m, log_q=log_q, p=p, generator=g)
    dev, cpu = DeviceContext(ctx, cuda), DeviceContext(ctx, "cpu")
    gen = torch.Generator().manual_seed(m)
    a, b = (torch.randint(0, 1 << 16, (2, 2, ctx.phim, ctx.n_limbs_ct),
                          generator=gen, dtype=torch.int32) for _ in range(2))
    mat = torch.randint(0, 2, (2, 3 * ctx.ndigits, ctx.num_primes, ctx.phim),
                        generator=gen, dtype=torch.int32)
    cuda_build.reset_launches()
    got = dev.mul_relin(a.to(cuda), b.to(cuda), mat.to(cuda))
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["byte_decomp"] == 1
    assert torch.equal(got.cpu(), cpu.mul_relin(a, b, mat))


# (log_q, decompSize, limbs n, phim): logQ a multiple of 16 or not; n the
# ciphertext width or wider (automorph outputs); phim a multiple of the
# kernel's 512-coefficient tile, the dense ring's 2002 and ragged widths
DIGIT_CASES = [pytest.param(80, 3, 6, 4096, id="q80-d3-n6-4096"),
               pytest.param(80, 2, 6, 4096, id="q80-d2-n6-4096"),
               pytest.param(80, 1, 6, 4096, id="q80-d1-n6-4096"),
               pytest.param(80, 3, 17, 4096, id="q80-d3-wide17-4096"),
               pytest.param(77, 3, 5, 1000, id="q77-d3-n5-1000"),
               pytest.param(77, 1, 9, 37, id="q77-d1-wide9-37"),
               pytest.param(170, 3, 11, 2002, id="q170-d3-n11-2002"),
               pytest.param(170, 2, 11, 2002, id="q170-d2-n11-2002"),
               pytest.param(213, 3, 14, 513, id="q213-d3-n14-513"),
               pytest.param(760, 3, 48, 300, id="q760-d3-n48-300")]
NARROW_Q = [786433, 1032193, 974849, 737281, 786433, 1032193, 974849, 737281,
            786433, 1032193, 974849, 737281]
WIDE_Q = [8257537, 7340033, 6684673, 5767169, 8257537, 7340033, 6684673,
          5767169, 8257537, 7340033, 6684673, 5767169]


def _digit_limbs(rng, shape, offset=0):
    """Random 16-bit limbs of `shape` (every bit above logQ at random, the
    first coefficient all ones, the second all zeros) on the CPU, and the
    same on the card `offset` words into a buffer (a contiguous tensor
    whose first word is not at a 16-byte boundary)."""
    x = rng.integers(0, 1 << 16, size=shape)
    x[..., 0, :] = (1 << 16) - 1
    x[..., 1, :] = 0
    cpu = torch.as_tensor(x.astype(np.int32))
    buf = torch.zeros(offset + cpu.numel(), dtype=torch.int32, device="cuda")
    buf[offset:] = cpu.reshape(-1).cuda()
    return cpu, buf[offset:].view(shape)


@pytest.mark.cuda
@pytest.mark.parametrize("lead", [pytest.param((), id="lead0"),
                                  pytest.param((3,), id="lead1"),
                                  pytest.param((2, 2), id="lead2")])
@pytest.mark.parametrize("log_q, decomp, n, phim", DIGIT_CASES)
def test_byte_decomp_matches_plain(cuda, log_q, decomp, n, phim, lead):
    """byte_decomp_kernel against its plain version, bit for bit: the
    digits of every row, one launch each, also from a buffer one word
    off a 16-byte boundary."""
    rng = np.random.default_rng([11, log_q, decomp, n, phim, len(lead)])
    nd = -(-log_q // (8 * decomp))
    for offset in (0, 1):
        cpu, dev = _digit_limbs(rng, lead + (phim, n), offset)
        cuda_build.reset_launches()
        got = digits_cuda.byte_decomp(dev, log_q, 8 * decomp, nd)
        torch.cuda.synchronize()
        assert cuda_build.LAUNCHES["byte_decomp"] == 1
        assert got.shape == lead + (nd, phim)
        assert torch.equal(got.cpu(), digits_cuda.byte_decomp_plain(
            cpu, log_q, 8 * decomp, nd))


@pytest.mark.cuda
@pytest.mark.parametrize("primes", [pytest.param(NARROW_Q, id="narrow"),
                                    pytest.param(WIDE_Q, id="wide")])
@pytest.mark.parametrize("log_q, decomp, n, phim", [
    pytest.param(170, 3, 11, 2002, id="q170-d3-n11-2002"),
    pytest.param(77, 2, 9, 1000, id="q77-d2-wide9-1000"),
    pytest.param(80, 1, 6, 4096, id="q80-d1-n6-4096")])
def test_byte_decomp_residues_match_plain(cuda, log_q, decomp, n, phim,
                                          primes):
    """The dense ring's per-prime output, 12 primes on either lane as the
    keyswitch basis holds them ([Lk, 1]), against the plain version."""
    rng = np.random.default_rng([12, log_q, decomp, n, phim, primes[0]])
    nd = -(-log_q // (8 * decomp))
    q = torch.tensor(primes, dtype=torch.int32)[:, None]
    for lead in ((), (3,), (2, 2)):
        cpu, dev = _digit_limbs(rng, lead + (phim, n), len(lead))
        got = digits_cuda.byte_decomp(dev, log_q, 8 * decomp, nd, q.cuda())
        assert got.shape == lead + (nd, len(primes), phim)
        assert torch.equal(got.cpu(), digits_cuda.byte_decomp_plain(
            cpu, log_q, 8 * decomp, nd, q))


@pytest.mark.cuda
def test_byte_decomp_refusals(cuda):
    """What the digit kernel does not take raises on the host, with the
    shape, before any launch: digits above 24 bits, limbs too narrow for
    logQ or wider than 48, a non-contiguous tensor, another dtype."""
    x = torch.zeros((2, 256, 6), dtype=torch.int32, device=cuda)
    cuda_build.reset_launches()
    with pytest.raises(ValueError, match=r"\(2, 256, 6\).*32 bits"):
        digits_cuda.byte_decomp(x, 80, 32, 3)
    with pytest.raises(ValueError, match=r"\(2, 256, 6\) for logQ 97"):
        digits_cuda.byte_decomp(x, 97, 24, 5)
    wide = torch.zeros((2, 256, 49), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match=r"\(2, 256, 49\)"):
        digits_cuda.byte_decomp(wide, 80, 24, 4)
    with pytest.raises(ValueError, match=r"\(256, 2, 6\).*contiguous"):
        digits_cuda.byte_decomp(x.transpose(0, 1), 80, 24, 4)
    with pytest.raises(ValueError, match=r"\(2, 256, 6\) torch.int64"):
        digits_cuda.byte_decomp(x.long(), 80, 24, 4)
    with pytest.raises(ValueError, match="primes"):
        digits_cuda.byte_decomp(x, 80, 24, 4, torch.tensor([97], device=cuda))
    assert cuda_build.LAUNCHES["byte_decomp"] == 0


@pytest.mark.cuda
def test_crt_kernel_refusals(cuda):
    """What the limb/CRT kernels do not take raises on the host, with the
    shape, before any launch: a context whose reconstruction is wider
    than 48 limbs (DeviceContext refuses it on the card and builds it on
    the CPU), limbs wider than 48, a tail wider than the value, tables
    without the kernel's basis table."""
    ctx = FheContext(m=256, log_q=800, p=257, generator=3)
    assert ctx.n_limbs > cuda_build.MAX_LIMBS
    with pytest.raises(ValueError, match="at most"):
        DeviceContext(ctx, cuda)
    DeviceContext(ctx, "cpu")
    dc = DeviceContext(_ctx(256, 257, None), cuda)
    T, fc = dc.full, dc.full["fast_crt"]
    cuda_build.reset_launches()
    wide = torch.zeros((2, dc.phim, cuda_build.MAX_LIMBS + 1),
                       dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match=r"\(2, 128, 49\).*at most"):
        crt_cuda.limbs_to_residues(wide, T["chunk_tbl"],
                                   dc._wrap_const(T["primes_np"], 49), T["q"],
                                   T["qinv_f"])
    res = torch.zeros((2, dc.L, dc.phim), dtype=torch.int32, device=cuda)
    n = fc["B"].shape[-1]
    with pytest.raises(ValueError, match="tail"):
        crt_cuda.crt_to_limbs(res, fc, False,
                              crt_cuda.Tail("round_down", 16 * n, 6))
    with pytest.raises(ValueError, match="k_crt"):
        crt_cuda.crt_to_limbs(res, {k: v for k, v in fc.items()
                                    if k != "k_crt"})
    assert all(v == 0 for v in _launched(CRT).values())


@pytest.mark.cuda
@pytest.mark.parametrize("mp", [pytest.param((256, 257, None), id="m256"),
                                pytest.param((256, 257, 23), id="m256-wide"),
                                pytest.param((8192, 40961, None), id="m8192"),
                                pytest.param((8192, 40961, 23),
                                             id="m8192-wide")])
def test_modular_kernels_match_plain(cuda, mp):
    """tensor_product (the two halves of one lifted tensor, separate
    tensors; 2 x 2, 3 x 2 and 4 x 4 parts) and keyswitch_dot (K = 3 and
    4 times ndigits, a [2, 3] lead shape) against their plain versions on
    the card, on every basis, with a worst-case row (every residue
    q - 1), bit for bit."""
    dc = DeviceContext(_ctx(*mp), cuda)
    rng = np.random.default_rng(10)
    cuda_build.reset_launches()

    def residues(q, *lead):
        x = rng.integers(0, q[:, None], size=lead + (len(q), dc.phim))
        x[0] = q[:, None] - 1
        return torch.as_tensor(x.astype(np.int32), device=cuda)
    for T in {id(T): T for T in (dc.full, dc.ksw, dc.lin)}.values():
        q, args = T["primes_np"], (T["q"], T["qinv_f"], dc.wide)
        ev = residues(q, 5, 4)
        for a, b in ((ev[:, :2], ev[:, 2:]),
                     (residues(q, 5, 3), residues(q, 5, 2)),
                     (residues(q, 2, 4), residues(q, 2, 4))):
            assert torch.equal(
                modular_cuda.tensor_product(a, b, T, dc.wide),
                modular_cuda.tensor_product_plain(a, b, T["p_mod_q"], *args))
        for k in (3, 4):
            K = k * dc.ndigits
            mat, dig = residues(q, 2, K), residues(q, 2, 3, K)
            assert torch.equal(modular_cuda.keyswitch_dot(mat, dig, T, dc.wide),
                               modular_cuda.keyswitch_dot_plain(mat, dig,
                                                                *args))
    torch.cuda.synchronize()
    assert all(n > 0 for n in _launched(MODULAR).values())


@pytest.mark.cuda
def test_mul_relin_on_card_launches_modular_kernels(cuda):
    """DeviceContext.mul_relin at m = 256: both modular kernels launch, no
    plain modular function (ops/modular.py mod_mul, mod_add, mod_dot)
    runs on a CUDA tensor, and the output equals the CPU's."""
    from fhe_si_tpu_torch.ops import modular
    ctx = _ctx(256, 257, None)
    names = ("mod_mul", "mod_add", "mod_dot")
    plain = {n: getattr(modular, n) for n in names}
    calls = []

    def counted(name):
        def call(x, *args, **kw):
            if x.is_cuda:
                calls.append(name)
            return plain[name](x, *args, **kw)
        return call
    outs = []
    for device in ("cpu", cuda):
        dev = DeviceContext(ctx, device)
        src = sampling.RandomSource(6)
        sk, pk = scheme.keygen(dev, src)
        ksw = scheme.KeySwitch.for_relinearization(sk, src)
        cts = pk.encrypt_batch([scheme.Plaintext(ctx, src.uniform_mod_p(
            ctx.phim, ctx.p)) for _ in range(4)], src)
        a = torch.stack([c.parts for c in cts[0::2]])
        b = torch.stack([c.parts for c in cts[1::2]])
        cuda_build.reset_launches()
        for n in names:
            setattr(modular, n, counted(n))
        try:
            outs.append(dev.mul_relin(a, b, ksw.matrix_evals).cpu())
        finally:
            for n in names:
                setattr(modular, n, plain[n])
    torch.cuda.synchronize()
    assert all(n > 0 for n in _launched(MODULAR).values())
    assert not calls
    assert torch.equal(*outs)


@pytest.mark.cuda
def test_modular_kernel_refusals(cuda):
    """What the modular kernels do not take raises on the host, with the
    shape, before any launch: five parts a side, a dot wider than
    MAX_TERMS, tables without the kernel table."""
    dc = DeviceContext(_ctx(256, 257, None), cuda)
    T = dc.full
    cuda_build.reset_launches()
    x = torch.zeros((2, 5, dc.L, dc.phim), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match=r"1 to 4 parts"):
        modular_cuda.tensor_product(x, x[:, :2], T)
    with pytest.raises(ValueError, match="k_mod"):
        modular_cuda.tensor_product(x[:, :2], x[:, :2],
                                    {k: v for k, v in T.items()
                                     if k != "k_mod"})
    K = modular_cuda.MAX_TERMS + 1
    mat = torch.zeros((2, K, dc.L, dc.phim), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="at most 384"):
        modular_cuda.keyswitch_dot(mat, mat[:1], T)
    assert all(v == 0 for v in _launched(MODULAR).values())
