"""The port's sharded pipelines (fhe_si_tpu_torch/parallel) against the
JAX package's, bit for bit, on torch.distributed worlds of CPU processes
(gloo): the mirror of tests/test_sharding.py.

One world of 4 ranks per ring, spawned once (module fixture) with
OMP_NUM_THREADS=1: the ring m = 22 (dense family) and m = 256 (Cooley-
Tukey, N1 x N2 = 16 x 8), both with num_primes_multiple=2.  Each world
runs ShardedPipelines on a dp = 2 x limb = 2 mesh, sharded_mul_relin, the
coefficient-sharded transforms and CoeffShardedPipelines on a coeff mesh
(coeff = 2 at m = 22, so dp = 2; coeff = 4 at m = 256), gathers every
output on rank 0 and writes them to one npz.  The inputs are the port's
keys and ciphertexts drawn from the JAX package's RandomSource; the
references are the JAX package's functions on the same arrays, here in
the test process.

    python tests/test_torch_parallel.py <rank> <world> <init> <in> <out>

runs one rank of such a world (what the fixture starts).
"""
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fhe_si_tpu_torch import DeviceContext, FheContext, parallel, scheme
from fhe_si_tpu_torch.hostmath import oracle

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
RINGS = {
    "dense": dict(kw=dict(m=22, log_q=80, p=23, generator=7), n_coeff=2,
                  seed=7),
    "ct": dict(kw=dict(m=256, log_q=80, p=257, generator=3), n_coeff=4,
               seed=21),
}
PAIRS = 4


def _context(kw):
    return FheContext(**kw, num_primes_multiple=2)


# ----------------------------------------------------------------- the world
def _world(rank, world, init, inp, out):
    """One rank: every sharded function on the inputs of `inp`, the
    gathered outputs into `out` (rank 0)."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=world,
                            rank=rank)
    data = np.load(inp)
    kw = json.loads(str(data["kw"]))
    ctx = _context(kw)
    dev = DeviceContext(ctx, "cpu")
    a, b, mat = data["a"], data["b"], data["matrix"]
    res = {}

    mesh = parallel.make_mesh(2, 2, "cpu")
    sp = parallel.ShardedPipelines(ctx, mesh)
    a_l, b_l = (parallel.shard_batched_parts(mesh, t) for t in (a, b))
    m_l = parallel.shard_matrix(mesh, mat)
    res["batched"] = mesh.all_gather(sp.batched_mul_relin(a_l, b_l, m_l), "dp")
    res["block_reduce"] = sp.mul_relin_block_reduce(a_l, b_l, m_l)
    res["sharded_mul_relin"] = parallel.sharded_mul_relin(dev, mesh)(a, b,
                                                                      mat)

    cm = parallel.make_coeff_mesh(int(data["n_coeff"]), "cpu")
    ntt_fn = parallel.ct_coeff_sharded_ntt if dev.use_ct \
        else parallel.coeff_sharded_ntt
    for key, forward, x in (("ntt_fwd", True, data["x"]),
                            ("ntt_inv", False, data["ev"])):
        got = ntt_fn(dev, cm, forward)(cm.block(x, -1, "coeff"))
        res[key] = cm.all_gather(got, "coeff", dim=-1)
    cp = parallel.CoeffShardedPipelines(dev, cm)
    got = cp.batched_mul_relin(*(parallel.shard_batched_parts(cm, t)
                                 for t in (a, b)),
                               parallel.shard_matrix(cm, mat))
    res["coeff_batched"] = cm.all_gather(cm.all_gather(got, "coeff", dim=-2),
                                         "dp", dim=0)
    if rank == 0:
        np.savez(out, **{k: v.numpy() for k, v in res.items()})
    dist.destroy_process_group()


# ------------------------------------------------------------------ fixtures
@pytest.fixture(scope="module", params=sorted(RINGS))
def world(request, tmp_path_factory):
    """Inputs made here, the world's outputs, and what the test needs to
    compute the JAX references: (name, inputs dict, outputs, port sk,
    messages)."""
    from fhe_si_tpu import sampling as jsampling
    name = request.param
    ring = RINGS[name]
    ctx = _context(ring["kw"])
    dev = DeviceContext(ctx, "cpu")
    src = jsampling.RandomSource(ring["seed"])
    sk, pk = scheme.keygen(dev, src)
    ksw = scheme.KeySwitch.for_relinearization(sk, src)
    msgs = [src.uniform_mod_p(ctx.phim, ctx.p) for _ in range(2 * PAIRS)]
    cts = [pk.encrypt(scheme.Plaintext(ctx, mm), src) for mm in msgs]
    x = np.random.default_rng(9).integers(
        0, ctx.primes[:, None], size=(5, ctx.num_primes, ctx.phim)).astype(
        np.int32)
    inputs = dict(
        a=torch.stack([c.parts for c in cts[:PAIRS]]).numpy(),
        b=torch.stack([c.parts for c in cts[PAIRS:]]).numpy(),
        matrix=ksw.matrix_evals.numpy(), x=x,
        ev=dev.ntt_fwd(torch.as_tensor(x)).numpy())
    tmp = tmp_path_factory.mktemp(f"world_{name}")
    inp, out = str(tmp / "in.npz"), str(tmp / "out.npz")
    np.savez(inp, kw=json.dumps(ring["kw"]), n_coeff=ring["n_coeff"],
             **inputs)
    init = f"file://{tmp / 'store'}"
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(WORLD), init,
         inp, out], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(WORLD)]
    logs = [p.communicate(timeout=240)[0].decode() for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    with np.load(out) as f:
        outputs = dict(f)
    return SimpleNamespace(name=name, ring=ring, inputs=inputs, out=outputs,
                           ctx=ctx, dev=dev, sk=sk, msgs=msgs)


_JAX = {}


def _jax(w):
    """The JAX package's DeviceContext of the world's ring (one per ring)
    and its batched mul+relin of the world's inputs."""
    if w.name not in _JAX:
        from fhe_si_tpu.context import FheContext as JContext
        from fhe_si_tpu.device import device_context
        jdev = device_context(JContext(**w.ring["kw"], num_primes_multiple=2))
        batched = np.asarray(jdev.batched_mul_relin_op(
            w.inputs["a"], w.inputs["b"], w.inputs["matrix"]))
        _JAX[w.name] = (jdev, batched)
    return _JAX[w.name]


def _jax_chained_sum(jdev, batched):
    """The JAX package's sum of the products by iterated reduce_signed
    adds (tests/test_sharding.py)."""
    import jax.numpy as jnp
    from fhe_si_tpu.ops import limbs as jlb
    acc = jnp.asarray(batched[0])
    for i in range(1, len(batched)):
        acc = jdev.reduce_signed(jlb.add(acc, jnp.asarray(batched[i])))
    return np.asarray(acc)


# --------------------------------------------------------------------- tests
def test_batched_mul_relin_equals_jax(world):
    """dp = 2 x limb = 2 ShardedPipelines.batched_mul_relin == the JAX
    package's batched op (itself == its shard_map pipeline)."""
    _, want = _jax(world)
    assert np.array_equal(world.out["batched"], want)


def test_block_reduce_equals_jax_shard_map(world):
    """mul_relin_block_reduce == the JAX package's ShardedPipelines
    block reduce on a dp = 4 x limb = 2 mesh of the 8 virtual devices (m =
    22; at m = 256 the chained JAX sum), and == sharded_mul_relin."""
    jdev, batched = _jax(world)
    if world.name == "dense":
        import jax
        from fhe_si_tpu.parallel import mesh as jmesh
        from fhe_si_tpu.parallel.shard import ShardedPipelines
        m = jmesh.make_mesh(n_dp=4, n_limb=2)
        a, b = (jmesh.shard_batched_parts(m, world.inputs[k])
                for k in ("a", "b"))
        mat = jax.device_put(world.inputs["matrix"],
                             jmesh.limb_sharding(m, 2, 4))
        want = np.asarray(ShardedPipelines(jdev, m).mul_relin_block_reduce()(
            a, b, mat))
    else:
        want = _jax_chained_sum(jdev, batched)
    assert np.array_equal(world.out["block_reduce"], want)
    assert np.array_equal(world.out["sharded_mul_relin"], want)


def test_sharded_mul_relin_equals_chained_sum(world):
    """sharded_mul_relin == the iterated reduce_signed sum of the JAX
    package's products, and decrypts to the oracle's sum of the plaintext
    products."""
    jdev, batched = _jax(world)
    got = world.out["sharded_mul_relin"]
    assert np.array_equal(got, _jax_chained_sum(jdev, batched))
    ctx = world.ctx
    want = np.zeros(ctx.phim, dtype=np.int64)
    for x, y in zip(world.msgs[:PAIRS], world.msgs[PAIRS:]):
        want = (want + oracle.plaintext_mul(ctx, x, y)) % ctx.p
    dec = world.sk.decrypt(scheme.Ciphertext(world.dev,
                                             parts=torch.as_tensor(got)))
    assert np.array_equal(dec.message, want)


def test_coeff_sharded_transforms_equal_jax(world):
    """coeff_sharded_ntt (m = 22, 2 shards: the JAX package's
    ntt.modmatmul on its digit planes) and ct_coeff_sharded_ntt (m = 256,
    4 shards: dev.ntt_fwd / ntt_inv), forward and raw inverse."""
    jdev, _ = _jax(world)
    x, ev = world.inputs["x"], world.inputs["ev"]
    if world.name == "dense":
        from fhe_si_tpu.ops import ntt as jntt
        want_fwd, want_inv = (
            np.asarray(jntt.modmatmul(jdev.C[key], arg, jdev.q, jdev.qinv_f))
            for key, arg in (("fwd_chunks", x), ("inv_chunks", ev)))
    else:
        want_fwd = np.asarray(jdev.ntt_fwd(x))
        want_inv = np.asarray(jdev.ntt_inv(ev))
    assert np.array_equal(world.out["ntt_fwd"], want_fwd)
    assert np.array_equal(world.out["ntt_inv"], want_inv)
    assert np.array_equal(world.out["ntt_inv"], x)


def test_coeff_sharded_pipeline_equals_jax(world):
    """CoeffShardedPipelines (dp = 2 x coeff = 2 at m = 22, coeff = 4 at
    m = 256) == the JAX package's batched op."""
    _, want = _jax(world)
    assert np.array_equal(world.out["coeff_batched"], want)


# ------------------------------------------------------------------ refusals
def _mesh(**shape):
    """A stand-in mesh: the constructors refuse from the axis sizes alone,
    before any collective."""
    return SimpleNamespace(shape=dict(shape))


def test_limb_shards_must_divide_the_chain():
    ctx = FheContext(**RINGS["dense"]["kw"])          # L = 10
    with pytest.raises(ValueError, match="num_primes_multiple=3"):
        parallel.ShardedPipelines(ctx, _mesh(dp=1, limb=3))


@pytest.fixture(scope="module")
def ct_dev():
    return DeviceContext(_context(RINGS["ct"]["kw"]), "cpu")


@pytest.mark.parametrize("S, match", [(16, "must divide both CT factors"),
                                      (3, "does not shard over coeff=3")])
def test_coeff_shards_must_divide_the_split(ct_dev, S, match):
    """m = 256: N1 x N2 = 16 x 8; 16 shards do not divide N2, 3 not phim."""
    with pytest.raises(ValueError, match=match):
        parallel.CoeffShardedPipelines(ct_dev, _mesh(dp=1, coeff=S))
    with pytest.raises(ValueError, match=match):
        parallel.ct_coeff_sharded_ntt(ct_dev, _mesh(dp=1, coeff=S))


def test_coeff_partials_must_stay_in_int32(ct_dev):
    """2^12 partials below the narrow primes (about 2^20) could sum past
    2^31."""
    assert ct_dev.ctx.primes.max() > 1 << 19
    with pytest.raises(ValueError, match="leaves int32"):
        parallel.CoeffShardedPipelines(ct_dev, _mesh(dp=1, coeff=1 << 12))


def test_coeff_sharding_refuses_mixed_radix():
    ctx = FheContext(m=160, log_q=80, p=641, generator=3)
    ctx.use_ct = True                      # phim 64: dense unless forced
    dev = DeviceContext(ctx, "cpu")
    assert dev.ct_meta.q_odd == 5 and (dev.ct_meta.N1, dev.ct_meta.N2) == (
        10, 8)
    with pytest.raises(NotImplementedError, match="m = 2\\^k"):
        parallel.CoeffShardedPipelines(dev, _mesh(dp=1, coeff=2))
    with pytest.raises(NotImplementedError, match="m = 2\\^k"):
        parallel.ct_coeff_sharded_ntt(dev, _mesh(dp=1, coeff=2))


def test_coeff_ntt_families_are_not_crossed(ct_dev):
    dense = DeviceContext(_context(RINGS["dense"]["kw"]), "cpu")
    with pytest.raises(ValueError, match="dense ring"):
        parallel.coeff_sharded_ntt(ct_dev, _mesh(dp=1, coeff=2))
    with pytest.raises(ValueError, match="Cooley-Tukey ring"):
        parallel.ct_coeff_sharded_ntt(dense, _mesh(dp=1, coeff=2))


if __name__ == "__main__":
    _world(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
