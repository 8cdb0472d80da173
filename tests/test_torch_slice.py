"""The multiply + relinearize slice, stage by stage: every tensor the port
computes equals fhe_si_tpu.device's on the same randomness, the result
equals hostmath/oracle.py, and the port runs with JAX absent.  This file
runs the ring m = 256; test_torch_slice_m32.py runs the same tests at
m = 32 (a file of its own, so that xdist runs the two in parallel)."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fhe_si_tpu import sampling
from fhe_si_tpu import scheme as jscheme
from fhe_si_tpu.context import FheContext as RefContext, ints_to_limbs, limbs_to_int
from fhe_si_tpu.device import device_context
from fhe_si_tpu.hostmath import oracle
from fhe_si_tpu.ops import modular as jmod
from fhe_si_tpu_torch import DeviceContext, FheContext, scheme, state

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 3      # ciphertext pairs per batch
STAGES = ["keygen", "relin_key", "encrypt", "tensor_mul", "scale_down",
          "digit_evals", "keyswitch", "mul_relin", "decrypt"]


def _stages(d, x, stack, square):
    """The slice through one DeviceContext's stage functions (the JAX
    package's take the table dict C first, the port's do not)."""
    o = {}
    sk, pk, pkl = o["keygen"] = d["keygen"](x["s"], x["c0"], x["c1"])
    mat = d["keyswitch_init"](stack([sk[0], sk[1], square(sk[1])]), sk[1],
                              x["A"], x["e"])
    enc = d["encrypt"](pk, x["msg"], x["r"], x["err"])
    a, b = enc[0::2], enc[1::2]
    tprod = d["tensor_mul"](a, b)
    sd = d["scale_down"](tprod)
    digs = d["digit_evals"](sd)
    ks = d["keyswitch_digits"](mat, digs)
    o.update(relin_key=(mat,), encrypt=(enc,), tensor_mul=(tprod,),
             scale_down=(sd,), digit_evals=(digs,), keyswitch=(ks,),
             decrypt=(d["decrypt"](ks, sk[:2]),))
    return o, (a, b, mat)


def slice_outputs(m, p, prime_bits=None):
    """Both packages through the slice on one draw of randomness; returns
    (jax tensors, port tensors, the draw, JAX context, port context).
    prime_bits=23 puts both on the wide residue lane."""
    kw = dict(m=m, log_q=80, p=p, generator=3, prime_bits=prime_bits)
    ref, ctx = RefContext(**kw), FheContext(**kw)
    jd, td = device_context(ref), DeviceContext(ctx, "cpu")
    src = sampling.RandomSource(m + p)
    kg = sampling.sample_keygen(src, ctx.phim, ctx.stdev, ctx.log_q)
    kr = sampling.sample_keyswitch(src, ctx.phim, ctx.stdev, ctx.log_q, 3,
                                   ctx.ndigits)
    msgs = np.stack([src.uniform_mod_p(ctx.phim, ctx.p) for _ in range(2 * B)])
    plans = [sampling.sample_encrypt(src, ctx.phim, ctx.stdev)
             for _ in range(2 * B)]
    inputs = dict(
        s=kg.s, c0=kg.c0, c1=ints_to_limbs(kg.c1, ctx.n_limbs_ct),
        A=np.stack([ints_to_limbs(a, ctx.n_limbs_ct) for a in kr.A]),
        e=np.stack(kr.e), msg=msgs, r=np.stack([pl.r for pl in plans]),
        err=np.stack([np.stack(pl.errors) for pl in plans]))
    i32 = {k: v.astype(np.int32) for k, v in inputs.items()}
    names = ("keygen", "keyswitch_init", "encrypt", "tensor_mul",
             "scale_down", "digit_evals", "keyswitch_digits", "decrypt")

    def jax_slice(C, x):
        # one jit over the JAX package's stage functions (what its *_op
        # entry points jit one by one): a single compile
        fns = {n: (lambda f: lambda *a: f(C, *a))(getattr(jd, "_" + n))
               for n in names}
        return _stages(fns, x, jnp.stack, lambda e: jmod.mod_mul(
            e, e, C["q"], C["qinv_f"], ref.wide))[0]

    out_j = jax.jit(jax_slice)(jd.C, {k: jnp.asarray(v) for k, v in i32.items()})
    out_j["mul_relin"] = out_j["keyswitch"]   # JAX's _mul_relin composes these
    out_t, (a, b, mat) = _stages(
        {n: getattr(td, "_" + n) for n in names},
        {k: torch.from_numpy(v) for k, v in i32.items()}, torch.stack,
        td.square_evals)
    out_t["mul_relin"] = (td.mul_relin(a, b, mat),)
    return out_j, out_t, inputs, ref, ctx


@pytest.fixture(scope="module")
def run():
    return slice_outputs(256, 257)


@pytest.mark.parametrize("stage", STAGES)
def test_stage_equals_jax(run, stage):
    out_j, out_t = run[:2]
    for j, t in zip(out_j[stage], out_t[stage]):
        j = np.asarray(j)
        assert t.dtype == torch.int32 and tuple(t.shape) == j.shape
        assert np.array_equal(t.numpy(), j), stage


def test_slice_equals_oracle(run):
    """Pair 0 through the pure-Python reference: parts and plaintext."""
    _, out_t, inputs, ref, ctx = run
    # the oracle takes Python ints where the device takes limbs
    sko, pko = oracle.keygen(ctx, sampling.KeyGenRandomness(
        s=inputs["s"], c0=inputs["c0"],
        c1=[limbs_to_int(row) for row in inputs["c1"]]))
    A = [[limbs_to_int(row) for row in poly] for poly in inputs["A"]]
    kswo = oracle.keyswitch_init_s2(sko, sampling.KeySwitchRandomness(
        A=A, e=list(inputs["e"])))
    cts = [oracle.encrypt(pko, inputs["msg"][i], sampling.EncryptRandomness(
        r=inputs["r"][i], errors=list(inputs["err"][i]))) for i in (0, 1)]
    want = oracle.apply_keyswitch(kswo, oracle.mul(cts[0], cts[1]))
    got = scheme.Ciphertext(None, parts=out_t["mul_relin"][0][0])
    assert got.to_python_parts() == want.parts
    assert list(out_t["decrypt"][0][0].numpy()) == list(
        oracle.plaintext_mul(ctx, inputs["msg"][0], inputs["msg"][1]))
    for i in range(B):
        assert np.array_equal(
            out_t["decrypt"][0][i].numpy(),
            oracle.plaintext_mul(ctx, inputs["msg"][2 * i],
                                 inputs["msg"][2 * i + 1]))


def test_scheme_api_and_state_round_trip(run):
    """The port's object layer on the fixture's RandomSource seed (drawn
    in the same canonical order) reproduces the JAX tensors; then keys
    and ciphertexts are carried JAX -> port -> numpy."""
    out_j, _, inputs, ref, ctx = run
    dev = DeviceContext(ctx, "cpu")
    src = sampling.RandomSource(ctx.m + ctx.p)
    sk, pk = scheme.keygen(dev, src)
    ksw = scheme.KeySwitch.for_relinearization(sk, src)
    msgs = [src.uniform_mod_p(ctx.phim, ctx.p) for _ in range(2 * B)]
    cts = pk.encrypt_batch([scheme.Plaintext(ctx, mm) for mm in msgs], src)
    out = scheme.relin_batch(scheme.mul_batch(list(zip(cts[0::2],
                                                       cts[1::2]))), ksw)
    want = np.asarray(out_j["keyswitch"][0])
    for i, c in enumerate(out):
        assert np.array_equal(c.parts.numpy(), want[i])
    single = ksw.apply(cts[0] * cts[1])
    assert torch.equal(single.parts, out[0].parts)
    assert np.array_equal(sk.decrypt(single).message,
                          oracle.plaintext_mul(ctx, msgs[0], msgs[1]))
    dec = sk.decrypt_batch(out)
    assert np.array_equal(np.stack([d.message for d in dec]),
                          np.asarray(out_j["decrypt"][0]))
    with pytest.raises(ValueError, match="relinearize first"):
        sk.decrypt(cts[0] * cts[1])

    # half the circuit in JAX, the rest in the port
    sk_j, pk_j, pkl_j = out_j["keygen"]
    j_objs = (jscheme.FheSecretKey(ref, sk_j),
              jscheme.FhePublicKey(ref, pk_j, pkl_j),
              jscheme.KeySwitch(ref, out_j["relin_key"][0]),
              jscheme.Ciphertext(ref, tprod=out_j["tensor_mul"][0][0]))
    sk_s, pk_s = state.secret_key(dev, j_objs[0]), state.public_key(dev, j_objs[1])
    ksw_s, moved = state.key_switch(dev, j_objs[2]), state.ciphertext(dev, j_objs[3])
    assert moved.scaled_up
    relin = ksw_s.apply(moved)
    assert np.array_equal(relin.parts.numpy(), want[0])
    assert np.array_equal(sk_s.decrypt(relin).message, dec[0].message)
    enc = pk_s.encrypt(scheme.Plaintext(ctx, msgs[0]),
                       sampling.EncryptRandomness(
                           r=inputs["r"][0], errors=list(inputs["err"][0])))
    assert np.array_equal(enc.parts.numpy(), np.asarray(out_j["encrypt"][0][0]))
    for obj, arrays in ((sk_s, dict(sk_evals=sk_j)),
                        (pk_s, dict(pk_evals=pk_j, pk_limbs=pkl_j)),
                        (ksw_s, dict(matrix_evals=out_j["relin_key"][0])),
                        (moved, dict(tprod=out_j["tensor_mul"][0][0]))):
        back = state.to_numpy(obj)
        assert back.keys() == arrays.keys()
        for k, v in arrays.items():
            assert np.array_equal(back[k], np.asarray(v))


def test_runs_without_jax():
    """The port imports neither JAX nor the JAX package: with `jax` and
    `fhe_si_tpu` blocked, the port's modules import (the sharded
    pipelines, the profiler and the codec among them), the m = 256 slice
    runs on the CPU and decrypts
    to the plaintext product, and the regression CLI reaches MATCH at
    m = 32 on --device=cpu."""
    code = textwrap.dedent("""
        import sys
        sys.modules['jax'] = None
        sys.modules['fhe_si_tpu'] = None
        import numpy as np
        from fhe_si_tpu_torch import DeviceContext, FheContext, sampling, scheme
        from fhe_si_tpu_torch import parallel, profiling, refserial
        from fhe_si_tpu_torch.hostmath import oracle
        ctx = FheContext(m=256, log_q=80, p=257, generator=3)
        dev = DeviceContext(ctx, 'cpu')
        src = sampling.RandomSource(3)
        sk, pk = scheme.keygen(dev, src)
        ksw = scheme.KeySwitch.for_relinearization(sk, src)
        m1 = src.uniform_mod_p(ctx.phim, ctx.p)
        m2 = src.uniform_mod_p(ctx.phim, ctx.p)
        c1, c2 = pk.encrypt_batch([scheme.Plaintext(ctx, m1),
                                   scheme.Plaintext(ctx, m2)], src)
        out = scheme.relin_batch(scheme.mul_batch([(c1, c2)]), ksw)
        got = sk.decrypt_batch(out)[0].message
        assert np.array_equal(got, oracle.plaintext_mul(ctx, m1, m2))
        import os, tempfile
        from fhe_si_tpu_torch.cli.gen_data import generate
        from fhe_si_tpu_torch.cli import test_regression
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, 'data.txt')
            generate(path, 2, 16, seed=5)
            assert test_regression.main(['x', path, '97', '3', '1',
                                         '--m=32', '--device=cpu']) == 0
        assert sys.modules['fhe_si_tpu'] is None and sys.modules['jax'] is None
        assert not any(k.startswith(('fhe_si_tpu.', 'jax.'))
                       for k in sys.modules)
        print('ok')
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("MATCH\nok")
