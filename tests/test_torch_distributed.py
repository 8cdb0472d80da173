"""Multi-process worlds of fhe_si_tpu_torch.parallel.run_distributed on the
CPU (gloo): the mirror of tests/test_distributed.py.  At m = 22, one rank
against a dp = 2 x limb = 2 world of four processes: the block reduce's
sha256 and value must be equal, and equal to the JAX package's
ShardedPipelines block reduce on the same inputs; a dp = 2 x coeff = 2
world's batched output must equal the single rank's and the unsharded
DeviceContext.mul_relin."""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 8


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(world: int, out: str, *extra: str) -> dict:
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    procs = []
    for rank in range(world):
        cmd = [sys.executable, "-m", "fhe_si_tpu_torch.parallel.run_distributed",
               str(rank), str(world), "--port", str(port), "--m", "22",
               "--batch", str(BATCH), "--device", "cpu", "--backend", "gloo",
               *extra]
        if rank == 0:
            cmd += ["--out", out]
        procs.append(subprocess.Popen(cmd, cwd=ROOT, env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT))
    logs = [p.communicate(timeout=240)[0].decode() for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    with open(out) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def one(tmp_path_factory):
    return _run(1, str(tmp_path_factory.mktemp("one") / "one.json"))


def test_four_ranks_match_one(one, tmp_path):
    four = _run(4, str(tmp_path / "four.json"), "--n-limb", "2")
    assert one["num_processes"] == 1 and four["num_processes"] == 4
    assert four["mesh"] == {"dp": 2, "limb": 2}
    assert one["sha256"] == four["sha256"], \
        "the sharded block reduce differs from the single rank's"
    assert np.array_equal(one["reduce_result"], four["reduce_result"])
    for r in (one, four):
        assert r["batched_sha256"] == r["unsharded_sha256"]
        # on the CPU every wrapper takes its plain version: no launch
        assert r["launches"] == {"ct_fwd": 0, "ct_fwd_digits": 0,
                                 "ct_inv": 0, "crt_to_limbs": 0,
                                 "limbs_to_residues": 0,
                                 "tensor_product": 0, "keyswitch_dot": 0,
                                 "byte_decomp": 0, "route_enter": 0,
                                 "route_leave": 0}

    # the JAX package's shard_map block reduce on the same inputs
    import jax
    from fhe_si_tpu.context import FheContext as JContext
    from fhe_si_tpu.device import device_context
    from fhe_si_tpu.parallel import mesh as jmesh
    from fhe_si_tpu.parallel.shard import ShardedPipelines
    from fhe_si_tpu_torch.parallel.run_distributed import RINGS, setup
    _, _, a, b, matrix = setup(22, 2, BATCH, "cpu")
    m = jmesh.make_mesh(n_dp=4, n_limb=2)
    want = ShardedPipelines(device_context(JContext(
        **RINGS[22], num_primes_multiple=2)), m).mul_relin_block_reduce()(
        jmesh.shard_batched_parts(m, a.numpy()),
        jmesh.shard_batched_parts(m, b.numpy()),
        jax.device_put(matrix.numpy(), jmesh.limb_sharding(m, 2, 4)))
    assert np.array_equal(np.asarray(want), one["reduce_result"])


def test_coeff_world_matches_one(one, tmp_path):
    coeff = _run(4, str(tmp_path / "coeff.json"), "--n-coeff", "2")
    assert coeff["mesh"] == {"dp": 2, "coeff": 2}
    assert coeff["sha256"] is None                  # no block reduce there
    assert coeff["batched_sha256"] == coeff["unsharded_sha256"] \
        == one["batched_sha256"]
