"""The port on a CUDA card: the three kernels against their plain PyTorch
versions on both residue lanes, on power-of-two and mixed-radix rings
(odd N1 among them), the splits the kernel refuses, the dense transform family against the
same function on the CPU, the multiply + relinearize slice (on the
Cooley-Tukey rings, decompSize 4 included, and on dense rings) and the
two applications on the card against the same runs on the CPU (which
test_torch_slice.py, test_torch_dense*.py and test_torch_apps*.py hold
equal to fhe_si_tpu).  Every test skips without a card.

This file imports neither JAX nor fhe_si_tpu, so it also runs where JAX
is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from fhe_si_tpu_torch import DeviceContext, FheContext, sampling, scheme
from fhe_si_tpu_torch.hostmath import oracle
from fhe_si_tpu_torch.ops import ntt_ct, ntt_ct_cuda

torch.set_num_threads(1)

RAGGED = 37     # rows: no row tile of the tensor-core kernel divides it
CONFIGS = [pytest.param((256, 257, None), id="m256"),
           pytest.param((32, 97, None), id="m32"),
           pytest.param((256, 257, 23), id="m256-wide"),
           pytest.param((32, 97, 23), id="m32-wide")]
KERNEL_CONFIGS = CONFIGS + [pytest.param((8192, 40961, None), id="m8192"),
                            pytest.param((8192, 40961, 23), id="m8192-wide")]
# dense-family rings (m, log_q, p, generator, prime_bits)
DENSE = [pytest.param((22, 80, 23, 7, None), id="m22"),
         pytest.param((22, 80, 23, 7, 23), id="m22-wide"),
         pytest.param((46, 96, 47, 5, None), id="m46"),
         pytest.param((46, 96, 47, 5, 23), id="m46-wide")]


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
    ntt_ct_cuda.reset_launches()
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
    assert all(n > 0 for n in ntt_ct_cuda.LAUNCHES.values())


def _kernel_tables(cuda, m, qs):
    from fhe_si_tpu_torch.hostmath import numbth
    meta, ct = ntt_ct.ct_tables(
        m, qs, [numbth.find_element_of_order(q, m) for q in qs])
    return meta, {k: torch.as_tensor(v, device=cuda)
                  for k, v in dict(ct, **ntt_ct_cuda.kernel_tables(ct)).items()}


def _all_transforms_match_plain(cuda, meta, T, seed):
    """The three kernels against their plain versions on 37 rows, and the
    round trip."""
    rng = np.random.default_rng(seed)
    q = T["q"].cpu().numpy().astype(np.int64)
    x = torch.as_tensor(rng.integers(0, q[:, None], size=(
        RAGGED, len(q), meta.phim)).astype(np.int32), device=cuda)
    d = torch.as_tensor(rng.integers(0, 1 << 24, size=(
        RAGGED, meta.phim)).astype(np.int32), device=cuda)
    ntt_ct_cuda.reset_launches()
    ev = ntt_ct_cuda.ct_fwd(T, x, meta)
    assert torch.equal(ev, ntt_ct.ct_fwd(T, x, meta))
    assert torch.equal(ntt_ct_cuda.ct_inv(T, ev, meta), x)
    ev = ntt_ct_cuda.ct_fwd_digits(T, d, meta, 24)
    assert torch.equal(ev, ntt_ct.ct_fwd_digits(T, d, meta, 24))
    assert torch.equal(ntt_ct_cuda.ct_inv(T, ev, meta),
                       ntt_ct.ct_inv(T, ev, meta))
    torch.cuda.synchronize()
    assert ntt_ct_cuda.LAUNCHES == {"ct_fwd": 1, "ct_fwd_digits": 1,
                                    "ct_inv": 2}


@pytest.mark.cuda
def test_tensor_core_kernel_m16384(cuda):
    """m = 2^14 (N1 x N2 = 128 x 64, one block per SM), on tables of three
    primes of both lanes."""
    meta, T = _kernel_tables(cuda, 1 << 14, [786433, 1032193, 8257537])
    _all_transforms_match_plain(cuda, meta, T, 14)


@pytest.mark.cuda
def test_tensor_core_kernel_m32768(cuda):
    """The largest ring the kernel takes (N1 x N2 = 128 x 128: the twiddle
    in global memory, 16 prefetched tiles per warp), on one narrow and one
    wide prime."""
    meta, T = _kernel_tables(cuda, 1 << 15, [786433, 8257537])
    _all_transforms_match_plain(cuda, meta, T, 15)


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
# and a wide prime with m | q - 1: odd R at 5 x 4, 3 x 3, 9 x 3, 81 x 81
MIXED = [pytest.param((40, [1048361, 8387921]), id="m40-5x4"),
         pytest.param((96, [1048129, 8387809]), id="m96-8x6"),
         pytest.param((160, [1047841, 8385761]), id="m160-10x8"),
         pytest.param((18, [1048573, 8388451]), id="m18-3x3"),
         pytest.param((54, [1048573, 8388091]), id="m54-9x3"),
         pytest.param((13122, [997273, 8306227]), id="m13122-81x81"),
         pytest.param((20480, [962561, 8273921]), id="m20480-128x80")]


@pytest.mark.cuda
@pytest.mark.parametrize("mq", MIXED)
def test_tensor_core_kernel_mixed_radix(cuda, mq):
    """The mixed-radix rings: the kernel on the N-point transform, the
    wrappers' pad, drop, insert and fold around it, against the plain
    versions, phim wide in and out."""
    meta, T = _kernel_tables(cuda, *mq)
    assert meta.q_odd > 1
    _all_transforms_match_plain(cuda, meta, T, mq[0])


@pytest.mark.cuda
def test_kernel_shape_rule_matches_card(cuda):
    """check_kernel_shape's shared-memory formula is the kernel's (Geo):
    equal to fsi_ct_mma_smem for every split the tests run, odd sides
    included."""
    lib = ntt_ct_cuda._lib()
    for S, R in ((2, 2), (4, 5), (5, 4), (3, 3), (3, 9), (9, 3), (8, 10),
                 (81, 81), (80, 128), (128, 80), (64, 64), (128, 128),
                 (128, 256), (1, 11)):
        assert ntt_ct_cuda.kernel_smem(S, R) == lib.fsi_ct_mma_smem(S, R)


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
    ntt_ct_cuda.reset_launches()
    for fn in (ntt_ct_cuda.ct_fwd, ntt_ct_cuda.ct_inv):
        with pytest.raises(ValueError,
                           match=r"\(2, 10, 10\) \(N1 x N2 = 11 x 1\)"):
            fn(T, x, meta)
    with pytest.raises(ValueError, match=r"\(2, 10\) \(N1 x N2 = 11 x 1\)"):
        ntt_ct_cuda.ct_fwd_digits(dc.ksw["ct"], x[:, 0], meta, 24)
    assert not any(ntt_ct_cuda.LAUNCHES.values())


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
    ntt_ct_cuda.reset_launches()
    out = scheme.relin_batch(scheme.mul_batch(list(zip(cts[0::2],
                                                       cts[1::2]))), ksw)
    dec = sk.decrypt_batch(out)
    for i in range(2):
        assert np.array_equal(dec[i].message, oracle.plaintext_mul(
            ctx, msgs[2 * i], msgs[2 * i + 1]))
    return (torch.stack([c.parts for c in out]).cpu(), dec,
            dict(ntt_ct_cuda.LAUNCHES))


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
    assert all(n == 0 for n in launched.values())


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
    ntt_ct_cuda.reset_launches()
    assert cli.main(["x", path, "97", "3", "7", "--m=32",
                     f"--device={cuda}"]) == 0
    assert capsys.readouterr().out.rstrip().endswith("MATCH")
    assert all(n > 0 for n in ntt_ct_cuda.LAUNCHES.values())
