"""The wide 23-bit residue lane (chain primes below 2^23, where the
narrow chain runs out; forced here with prime_bits = 23): the port's
modular and CRT ops and its plain transforms against fhe_si_tpu on the
same numpy-seeded inputs, the digit-stage split of the plain transform
against Python integers, and the multiply + relinearize slice stage by
stage at m = 256 against fhe_si_tpu.device."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fhe_si_tpu.context import FheContext as RefContext
from fhe_si_tpu.device import DeviceContext as RefDevice
from fhe_si_tpu.ops import crt as jcrt, modular as jmod, ntt_ct as jct
from fhe_si_tpu.ops import ntt_ct_pallas as jctp
from fhe_si_tpu_torch import DeviceContext, FheContext
from fhe_si_tpu_torch.ops import crt as tcrt, modular as tmod
from fhe_si_tpu_torch.ops import ntt_ct as tct, ntt_ct_cuda
from test_torch_slice import (  # noqa: F401  (collected here, with this `run`)
    slice_outputs, test_scheme_api_and_state_round_trip,
    test_slice_equals_oracle, test_stage_equals_jax)

torch.set_num_threads(1)

RAGGED = 37
CONFIGS = [pytest.param((32, 97), id="m32"), pytest.param((256, 257), id="m256")]

xla_fwd = jax.jit(jct.ct_fwd, static_argnums=2)
xla_fwd_digits = jax.jit(jct.ct_fwd_digits, static_argnums=(2, 3))
xla_inv = jax.jit(jct.ct_inv, static_argnums=(2, 3))


@functools.cache
def _devices(m, p):
    kw = dict(m=m, log_q=80, p=p, generator=3, prime_bits=23)
    ref, ctx = RefContext(**kw), FheContext(**kw)
    assert ref.wide and ctx.wide and ctx.prime_bits == 23
    return RefDevice(ref), DeviceContext(ctx, "cpu")


def _bases(jd, td):
    """(port tables, JAX tables) of the full chain and both subset bases."""
    return {"full": (td.full, jd._full_as_subset(jd.C)),
            "ksw": (td.ksw, jd._ksw_tables(jd.C)),
            "lin": (td.lin, jd._lin_tables(jd.C))}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _eq(j, t):
    j, t = _np(j), _np(t)
    assert j.dtype == t.dtype and j.shape == t.shape
    assert np.array_equal(j, t)


@pytest.fixture(scope="module")
def run():
    return slice_outputs(256, 257, prime_bits=23)


# ------------------------------------------------------------------ modular
@pytest.mark.parametrize("op", ["mod_mul", "mod_dot_K27", "mod_dot_K64"])
def test_wide_modular(op):
    _, td = _devices(32, 97)
    qs = td.full["primes_np"]
    q64 = qs[:, None].astype(np.int64)
    q, qi = td.full["q"], td.full["qinv_f"]
    jq, jqi = jnp.asarray(q.numpy()), jnp.asarray(qi.numpy())
    rng = np.random.default_rng(21)
    if op == "mod_mul":
        a = rng.integers(0, q64, size=(4, len(qs), 64)).astype(np.int32)
        b = rng.integers(0, q64, size=(4, len(qs), 64)).astype(np.int32)
        got = tmod.mod_mul(torch.from_numpy(a), torch.from_numpy(b), q, qi,
                           wide=True)
        _eq(jmod.mod_mul(jnp.asarray(a), jnp.asarray(b), jq, jqi, wide=True),
            got)
        assert np.array_equal(got.numpy(), a.astype(np.int64) * b % q64)
        return
    K = int(op.rsplit("K", 1)[1])
    # the keyswitch shape: [2, K, L, n] x [B, 1, K, L, n], axis -3
    mat = rng.integers(0, q64, size=(2, K, len(qs), 64)).astype(np.int32)
    dig = rng.integers(0, q64, size=(3, 1, K, len(qs), 64)).astype(np.int32)
    got = tmod.mod_dot(torch.from_numpy(mat), torch.from_numpy(dig), q, qi,
                       axis=-3, wide=True)
    _eq(jmod.mod_dot(jnp.asarray(mat), jnp.asarray(dig), jq, jqi, axis=-3,
                     wide=True), got)
    exact = (mat.astype(object) * dig.astype(object)).sum(axis=-3) % q64
    assert np.array_equal(got.numpy(), exact.astype(np.int64))


# ---------------------------------------------------------------------- crt
def _as_jax(tables: dict) -> dict:
    return {k: _as_jax(v) if isinstance(v, dict) else jnp.asarray(v.numpy())
            for k, v in tables.items() if isinstance(v, (dict, torch.Tensor))}


@pytest.mark.parametrize("basis", ["full", "ksw", "lin"])
@pytest.mark.parametrize("op", ["limbs_to_residues", "residues_to_limbs_fast",
                                "crt_partials"])
def test_wide_crt(op, basis):
    _, td = _devices(32, 97)
    T = _bases(*_devices(32, 97))[basis][0]
    JT = _as_jax(T)
    primes = T["primes_np"]
    rng = np.random.default_rng(22)
    if op == "limbs_to_residues":
        for n in (td.n_ct, td.n):
            poly = rng.integers(0, 1 << 16, size=(2, 5, td.phim, n)).astype(
                np.int32)
            wrap = td._wrap_const(primes, n)
            _eq(jcrt.limbs_to_residues(jnp.asarray(poly), JT["chunk_tbl"],
                                       jnp.asarray(wrap.numpy()), JT["q"],
                                       JT["qinv_f"], wide=True),
                tcrt.limbs_to_residues(torch.from_numpy(poly),
                                       T["chunk_tbl"], wrap, T["q"],
                                       T["qinv_f"], wide=True))
        return
    res = rng.integers(0, primes[:, None],
                       size=(2, 3, len(primes), td.phim)).astype(np.int32)
    rj, rt = jnp.asarray(res), torch.from_numpy(res)
    if op == "residues_to_limbs_fast":
        for pre in (False, True):
            _eq(jcrt.residues_to_limbs_fast(rj, JT["fast_crt"], JT["q"],
                                            JT["qinv_f"], prescaled=pre,
                                            wide=True),
                tcrt.residues_to_limbs_fast(rt, T["fast_crt"], T["q"],
                                            T["qinv_f"], prescaled=pre,
                                            wide=True))
        return
    want = jcrt.crt_partials(rj, JT["fast_crt"], JT["q"], JT["qinv_f"],
                             wide=True)
    got = tcrt.crt_partials(rt, T["fast_crt"], T["q"], T["qinv_f"],
                            wide=True)
    for w, g in zip(want, got):
        _eq(w, g)
    n = T["fast_crt"]["B"].shape[-1]
    _eq(jcrt.crt_finish(*want, JT["fast_crt"], n, wide=True),
        tcrt.crt_finish(*got, T["fast_crt"], n, wide=True))


# --------------------------------------------------------------- transforms
@pytest.mark.parametrize("basis", ["full", "ksw", "lin"])
@pytest.mark.parametrize("mp", CONFIGS)
def test_wide_plain_transforms_match_xla(mp, basis):
    """On the wide lane the JAX package runs its XLA transforms (the Pallas
    kernels take the narrow lane only), so those are the reference."""
    jd, td = _devices(*mp)
    meta = td.ct_meta
    assert not jctp.supported(jd.ct_meta, wide=True)
    T, JT = _bases(jd, td)[basis]
    q = T["primes_np"]
    rng = np.random.default_rng(23)
    for lead in ((RAGGED,), (2, 3)):
        x = rng.integers(0, q[:, None], size=lead + (len(q), meta.N)).astype(
            np.int32)
        d = rng.integers(0, 1 << 24, size=lead + (meta.N,)).astype(np.int32)
        ev = tct.ct_fwd(T["ct"], torch.from_numpy(x), meta)
        _eq(xla_fwd(JT["ct"], jnp.asarray(x), jd.ct_meta), ev)
        for key in ("t2i", "t2i_crt"):
            _eq(xla_inv(JT["ct"], jnp.asarray(ev.numpy()), jd.ct_meta, key),
                tct.ct_inv(T["ct"], ev, meta, key))
        assert np.array_equal(tct.ct_inv(T["ct"], ev, meta).numpy(), x)
        _eq(xla_fwd_digits(JT["ct"], jnp.asarray(d), jd.ct_meta, 24),
            tct.ct_fwd_digits(T["ct"], torch.from_numpy(d), meta, 24))


@pytest.mark.parametrize("K,y_bits", [(64, 24), (128, 24), (256, 23)])
def test_stage_exact_past_the_float64_bound(K, y_bits):
    """A stage sums K products of a table entry below 2^23 and an operand
    below 2^y_bits.  Past K * 2^23 * 2^y_bits = 2^53 the plain version
    splits the table at 12 bits; either way it is exact."""
    _, td = _devices(32, 97)
    qs = td.full["primes_np"][:3]
    rng = np.random.default_rng(24)
    tab = rng.integers(0, qs[:, None, None], size=(3, 5, K)).astype(np.int32)
    y = rng.integers(0, 1 << y_bits, size=(2, 1, K, 7)).astype(np.int32)
    q = torch.as_tensor(qs[:, None, None])
    got = tct._stage(torch.from_numpy(tab), torch.from_numpy(y), q,
                     (1 << y_bits) - 1)
    want = np.einsum("lok,blkf->blof", tab.astype(object),
                     np.broadcast_to(y, (2, 3, K, 7)).astype(object))
    assert np.array_equal(got.numpy(),
                          (want % qs[:, None, None]).astype(np.int64))


def test_kernel_wrappers_refuse_what_the_kernels_cannot_take():
    """The CUDA wrappers hold the kernels' exactness bounds: primes below
    2^23 and digits of at most 24 bits."""
    _, td = _devices(32, 97)
    meta = td.ct_meta
    T = dict(td.full["ct"])
    x = torch.zeros((1, T["q"].shape[0], meta.N), dtype=torch.int32)
    ntt_ct_cuda._check("ct_fwd", x, tuple(x.shape[1:]), T)
    T["q"] = T["q"].clone()
    T["q"][0] = (1 << 23) + 9
    with pytest.raises(ValueError, match="below 2\\^23"):
        ntt_ct_cuda._check("ct_fwd", x, tuple(x.shape[1:]), T)
    with pytest.raises(NotImplementedError, match="2\\^24"):
        tct.ct_fwd_digits(td.full["ct"], x[:, 0], meta, 25)
