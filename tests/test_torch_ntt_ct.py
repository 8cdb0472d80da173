"""The plain PyTorch Cooley-Tukey transforms against fhe_si_tpu's XLA
path and its Pallas kernels (interpret mode), and the CUDA wrappers' CPU
routing.  The kernels themselves are tested in test_torch_cuda.py."""
import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fhe_si_tpu.context import FheContext as RefContext
from fhe_si_tpu.device import DeviceContext as RefDevice
from fhe_si_tpu.ops import ntt_ct as jct, ntt_ct_pallas as jctp
from fhe_si_tpu_torch import DeviceContext, FheContext
from fhe_si_tpu_torch.hostmath import numbth
from fhe_si_tpu_torch.ops import cuda_build, ntt_ct as tct, ntt_ct_cuda

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RAGGED = 37        # not a multiple of the Pallas row block (BM = 32)
CONFIGS = [pytest.param((32, 97), id="m32"), pytest.param((256, 257), id="m256")]

# the XLA path, jitted whole (op-by-op dispatch dominates it at these sizes)
xla_fwd = jax.jit(jct.ct_fwd, static_argnums=2)
xla_fwd_digits = jax.jit(jct.ct_fwd_digits, static_argnums=(2, 3))
xla_inv = jax.jit(jct.ct_inv, static_argnums=(2, 3))


@functools.cache
def _devices(m, p):
    ref = RefContext(m=m, log_q=80, p=p, generator=3)
    ctx = FheContext(m=m, log_q=80, p=p, generator=3)
    return RefDevice(ref), DeviceContext(ctx, "cpu")


def _inputs(T, meta, lead, seed):
    rng = np.random.default_rng(seed)
    q = T["primes_np"]
    x = rng.integers(0, q[:, None], size=lead + (len(q), meta.N))
    d = rng.integers(0, 1 << 24, size=lead + (meta.N,))
    return x.astype(np.int32), d.astype(np.int32)


@pytest.mark.parametrize("lead,basis", [((RAGGED,), "full"), ((2, 3), "ksw")],
                         ids=["rows37-full", "lead2x3-ksw"])
@pytest.mark.parametrize("mp", CONFIGS)
def test_plain_transforms_match_xla(mp, lead, basis):
    jd, td = _devices(*mp)
    meta = td.ct_meta
    assert tuple(meta) == tuple(jd.ct_meta)
    T, JT = (td.full, jd.C) if basis == "full" else (td.ksw, jd.C["ksw"])
    x, d = _inputs(T, meta, lead, 4)
    ev = tct.ct_fwd(T["ct"], torch.from_numpy(x), meta)
    want = xla_fwd(JT["ct"], jnp.asarray(x), jd.ct_meta)
    assert np.array_equal(ev.numpy(), np.asarray(want))
    for key in ("t2i", "t2i_crt"):
        got = tct.ct_inv(T["ct"], ev, meta, key)
        want = xla_inv(JT["ct"], jnp.asarray(ev.numpy()), jd.ct_meta, key)
        assert np.array_equal(got.numpy(), np.asarray(want)), key
    assert np.array_equal(tct.ct_inv(T["ct"], ev, meta).numpy(), x)
    got = tct.ct_fwd_digits(T["ct"], torch.from_numpy(d), meta, 24)
    want = xla_fwd_digits(JT["ct"], jnp.asarray(d), jd.ct_meta, 24)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_plain_transforms_match_pallas_interpret():
    """The TPU kernels themselves (interpret mode), as
    tests/test_ntt_ct_pallas.py runs them, on a ragged row count."""
    jd, td = _devices(256, 257)
    meta = td.ct_meta
    T, JT = td.ksw, jd.C["ksw"]     # the XLA test covers the full chain
    x, d = _inputs(T, meta, (RAGGED,), 5)
    ev = jctp.ct_fwd(JT["ct"], jnp.asarray(x), jd.ct_meta, interpret=True)
    assert np.array_equal(
        tct.ct_fwd(T["ct"], torch.from_numpy(x), meta).numpy(),
        np.asarray(ev))
    for key in ("t2i", "t2i_crt"):
        want = jctp.ct_inv(JT["ct"], ev, jd.ct_meta, t2i_key=key,
                           interpret=True)
        got = tct.ct_inv(T["ct"], torch.from_numpy(np.array(ev)), meta,
                         key)
        assert np.array_equal(got.numpy(), np.asarray(want)), key
    want = jctp.ct_fwd_digits(JT["ct"], jnp.asarray(d), jd.ct_meta, 24,
                              interpret=True)
    got = tct.ct_fwd_digits(T["ct"], torch.from_numpy(d), meta, 24)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("q,wide", [(786433, False), (8257537, True)],
                         ids=["narrow", "wide"])
def test_plain_transforms_match_xla_m32768(q, wide):
    """m = 2^15 (N1 = N2 = 128), the largest ring the kernels take: the
    plain digit stage splits its table at 12 bits here (ops/ntt_ct.py
    _stage), the residue stages stay one float64 matmul."""
    m = 1 << 15
    root = numbth.find_element_of_order(q, m)
    meta, T = tct.ct_tables(m, [q], [root])
    T = {k: torch.as_tensor(v) for k, v in T.items()}
    jt = jct.CtNttTables(m, [q], [root], wide=wide)
    assert tuple(meta) == tuple(jt.meta)
    JT = jt.pack()
    rng = np.random.default_rng(15)
    x = rng.integers(0, q, size=(2, 1, meta.N)).astype(np.int32)
    d = rng.integers(0, 1 << 24, size=(2, meta.N)).astype(np.int32)
    ev = tct.ct_fwd(T, torch.from_numpy(x), meta)
    assert np.array_equal(ev.numpy(),
                          np.asarray(xla_fwd(JT, jnp.asarray(x), jt.meta)))
    got = tct.ct_inv(T, ev, meta)
    want = xla_inv(JT, jnp.asarray(ev.numpy()), jt.meta, "t2i")
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got.numpy(), x)
    got = tct.ct_fwd_digits(T, torch.from_numpy(d), meta, 24)
    want = xla_fwd_digits(JT, jnp.asarray(d), jt.meta, 24)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_plain_transforms_are_the_ntt():
    """ct_fwd evaluates at the primitive m-th roots in ascending-exponent
    order (the slow DFT), independent of either package."""
    _, td = _devices(32, 97)
    meta, ctx = td.ct_meta, td.ctx
    x, _ = _inputs(td.full, meta, (2,), 6)
    ev = tct.ct_fwd(td.full["ct"], torch.from_numpy(x), meta).numpy()
    for l, (q, w) in enumerate(zip(ctx.primes, ctx.roots)):
        q, w = int(q), int(w)
        for r in range(2):
            want = [sum(int(x[r, l, c]) * pow(w, int(t) * c, q)
                        for c in range(ctx.phim)) % q for t in ctx.zms]
            assert ev[r, l].tolist() == want


def test_wrappers_route_cpu_tensors_to_plain():
    _, td = _devices(256, 257)
    meta, T = td.ct_meta, td.full["ct"]
    x, d = _inputs(td.full, meta, (RAGGED,), 7)
    xt, dt = torch.from_numpy(x), torch.from_numpy(d)
    cuda_build.reset_launches()
    ev = ntt_ct_cuda.ct_fwd(T, xt, meta)
    assert torch.equal(ev, tct.ct_fwd(T, xt, meta))
    assert torch.equal(ntt_ct_cuda.ct_inv(T, ev, meta, "t2i_crt"),
                       tct.ct_inv(T, ev, meta, "t2i_crt"))
    assert torch.equal(ntt_ct_cuda.ct_fwd_digits(T, dt, meta, 24),
                       tct.ct_fwd_digits(T, dt, meta, 24))
    assert {k: cuda_build.LAUNCHES[k] for k in ("ct_fwd", "ct_fwd_digits",
                                                "ct_inv")} == {
        "ct_fwd": 0, "ct_fwd_digits": 0, "ct_inv": 0}
    with pytest.raises(RuntimeError, match="no kernel for device"):
        ntt_ct_cuda.ct_fwd(T, xt.to("meta"), meta)


def test_kernel_module_imports_without_nvcc():
    code = ("import fhe_si_tpu_torch.ops.ntt_ct_cuda, shutil; "
            "from fhe_si_tpu_torch.ops import cuda_build; "
            "assert shutil.which('nvcc') is None; "
            "assert cuda_build.library.cache_info().currsize == 0; "
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env={"PATH": "", "PYTHONPATH": REPO},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
