"""The port's JAX-free FheContext and its tables against fhe_si_tpu."""
import numpy as np
import pytest
import torch

from fhe_si_tpu.context import FheContext as RefContext
from fhe_si_tpu_torch import DeviceContext, FheContext
from fhe_si_tpu_torch.ops import ntt_ct as tct

torch.set_num_threads(1)

CONFIGS = [
    pytest.param((32, 97), id="m32"),
    pytest.param((256, 257), id="m256"),
    pytest.param((8192, 40961), id="m8192", marks=pytest.mark.slow),
]


def _pair(m, p):
    return (RefContext(m=m, log_q=80, p=p, generator=3),
            FheContext(m=m, log_q=80, p=p, generator=3))


def _same(a, b, path="") -> None:
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    else:
        assert np.array_equal(np.asarray(a), np.asarray(b)), path


def _planes_to_int(planes):
    """JAX int8 digit planes (d0, d1, d2, ...) -> the integer table."""
    p = np.asarray(planes).astype(np.int64)
    return p[0] + (p[1] << 7) + (p[2] << 14)


@pytest.mark.parametrize("mp", CONFIGS)
def test_context_attributes_and_tables(mp):
    ref, ctx = _pair(*mp)
    for name in ("m", "phim", "num_primes", "prime_bits", "n_limbs",
                 "n_limbs_ct", "ndigits", "digit_bits", "use_ct", "wide",
                 "prime_product", "crt_product", "total_slots",
                 "usable_slots", "slot_cycles", "ksw_value_primes",
                 "lin_value_primes"):
        assert getattr(ctx, name) == getattr(ref, name), name
    for name in ("primes", "roots", "zms", "ksw_rows", "lin_rows",
                 "slot_exponents", "q_over_p_limbs"):
        _same(getattr(ctx, name), getattr(ref, name), name)
    _same(ctx.exact_bounds, ref.exact_bounds)
    _same(ctx.residue_tables, ref.residue_tables)
    for name in ("fast_crt_tables", "ksw_fast_crt_tables",
                 "lin_fast_crt_tables"):
        want = dict(getattr(ref, name))
        del want["B_chunks"]
        _same(getattr(ctx, name), want, name)


@pytest.mark.parametrize("mp", CONFIGS)
def test_ct_tables_equal_jax_planes(mp):
    from fhe_si_tpu.ops import ntt_ct
    ref, ctx = _pair(*mp)
    meta, tabs = tct.ct_tables(ctx.m, ctx.primes, ctx.roots)
    ctt = ntt_ct.CtNttTables(ref.m, ref.primes, ref.roots)
    assert tuple(meta) == tuple(ctt.meta)
    pack = ctt.pack()
    for k in ("t1", "t2", "t1i", "t2i"):
        assert np.array_equal(tabs[k], _planes_to_int(pack[k])), k
    for k in ("tw", "twi"):      # JAX layout [N1, L, N2], port [L, N1, N2]
        assert np.array_equal(tabs[k], np.moveaxis(np.asarray(pack[k]), 1, 0))
    assert np.array_equal(tabs["q"], np.asarray(pack["q"])[:, 0])


@pytest.mark.parametrize("mp", CONFIGS[:2])
def test_t2i_crt_equals_jax_device_tables(mp):
    from fhe_si_tpu.device import DeviceContext as RefDevice
    ref, ctx = _pair(*mp)
    jd = RefDevice(ref)
    td = DeviceContext(ctx, "cpu")
    assert jd.C["ksw"] is not None and jd.C["lin"] is not None
    for T, JT in ((td.full, jd.C), (td.ksw, jd.C["ksw"]),
                  (td.lin, jd.C["lin"])):
        for k in ("t2i", "t2i_crt"):
            assert np.array_equal(T["ct"][k].numpy(),
                                  _planes_to_int(JT["ct"][k])), k
        assert np.array_equal(T["q"].numpy(), np.asarray(JT["q"]))
        assert np.array_equal(T["qinv_f"].numpy(), np.asarray(JT["qinv_f"]))
        assert np.array_equal(T["chunk_tbl"].numpy(),
                              np.asarray(JT["chunk_tbl"]))
        for k in ("binv", "Bmodr", "B", "Bh", "er_mask", "P_limbs",
                  "P_limbs_sh10", "mr", "Pinv_r", "mrinv_f"):
            assert np.array_equal(T["fast_crt"][k].numpy(),
                                  np.asarray(JT["fast_crt"][k])), k


def test_unported_configs_raise():
    """The refusals that stay now that the mixed-radix family is ported
    (m = 160 with use_ct forced, as in tests/test_ct_scheme.py:151-159,
    builds): a dense ring past phim = 4096 (context.py:302); a
    Cooley-Tukey split the tensor-core kernel cannot take, which
    ntt_ct_cuda.check_kernel_shape refuses with the shape before any
    launch while the plain versions on the CPU take it (a side of 1, as
    m = 22 with use_ct forced gives, and a layout past shared memory at
    m = 2^16; test_torch_cuda.py shows the wrappers raise on the card);
    and DoubleCrt on a Cooley-Tukey context.  The dense family, the wide
    lane and decompSize >= 4 build (tests/test_torch_dense*.py hold them
    against fhe_si_tpu)."""
    from fhe_si_tpu_torch.doublecrt import DoubleCrt
    from fhe_si_tpu_torch.ops import cuda_build, ntt_ct_cuda as nc
    with pytest.raises(NotImplementedError, match="prime-power odd part"):
        FheContext(m=3 * 5 * 2048, log_q=80, p=61441, generator=7)
    ctx = FheContext(m=160, log_q=80, p=641, generator=3)
    assert not ctx.use_ct
    assert DeviceContext(ctx, "cpu").ct_meta is None       # dense
    ctx.use_ct = True
    assert tuple(DeviceContext(ctx, "cpu").ct_meta) == (10, 8, 64, 5)

    # the kernel's shape rule: S = N2, R = N1 forward, S = N1, R = N2 inverse
    for N1, N2 in ((2, 2), (128, 128), (128, 80), (81, 81), (5, 4), (3, 3),
                   (9, 3), (11, 2)):
        nc.check_kernel_shape("ct_fwd", (1, 1, N1 * N2), N2, N1)
        nc.check_kernel_shape("ct_inv", (1, 1, N1 * N2), N1, N2)
    ctx = FheContext(m=22, log_q=80, p=23, generator=7)
    ctx.use_ct = True                      # N = 11: N1 x N2 = 11 x 1
    dc = DeviceContext(ctx, "cpu")
    assert tuple(dc.ct_meta) == (11, 1, 10, 11)
    shape = (3, dc.L, dc.phim)
    for S, R in ((1, 11), (11, 1)):
        with pytest.raises(ValueError,
                           match=r"\(3, 10, 10\) \(N1 x N2 = 11 x 1\).*>= 2"):
            nc.check_kernel_shape("ct_fwd", shape, S, R)
    with pytest.raises(ValueError, match=r"256 x 128.* 479232 bytes of shared"):
        nc.check_kernel_shape("ct_inv", (2, 1, 32768), 256, 128)
    with pytest.raises(ValueError, match=r"needs 159744 .* allows 100000"):
        nc.check_kernel_shape("ct_fwd", (1, 1, 10240), 80, 128, limit=100000)
    x = torch.as_tensor(np.random.default_rng(0).integers(
        0, ctx.primes[:, None], size=shape).astype(np.int32))
    # DeviceContext takes such a split on the matmul route (its tables are
    # float64 stage operands); the wrappers' plain versions read the
    # integer tables
    assert dc.ct_route == "matmul"
    T = {k: torch.as_tensor(v)
         for k, v in tct.ct_tables(ctx.m, ctx.primes, ctx.roots)[1].items()}
    cuda_build.reset_launches()
    ev = nc.ct_fwd(T, x, dc.ct_meta)                  # CPU: the plain version
    assert torch.equal(nc.ct_inv(T, ev, dc.ct_meta), x)
    assert not any(cuda_build.LAUNCHES.values())
    with pytest.raises(NotImplementedError, match="Cooley-Tukey"):
        DoubleCrt(dc)

    assert not DeviceContext(FheContext(m=22, log_q=80, p=23, generator=7),
                             "cpu").use_ct
    assert DeviceContext(FheContext(m=32, log_q=80, p=97, generator=3,
                                    prime_bits=23), "cpu").wide
    dev = DeviceContext(FheContext(m=32, log_q=80, p=97, generator=3,
                                   decomp_size=4), "cpu")
    out = dev.keyswitch_parts(torch.zeros((2, dev.phim, dev.n_ct),
                                          dtype=torch.int32),
                              torch.zeros((2, 2 * dev.ndigits, dev.L,
                                           dev.phim), dtype=torch.int32))
    assert out.shape == (2, dev.phim, dev.n_ct)
