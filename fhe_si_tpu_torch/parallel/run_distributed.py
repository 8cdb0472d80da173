"""One rank of a multi-process mul+relin world (counterpart of the JAX
package's tools/run_distributed.py).

    python -m fhe_si_tpu_torch.parallel.run_distributed <rank> <world>
        [--port 39731] [--n-limb 1 | --n-coeff S] [--batch 8] [--steps 3]
        [--m 22|256|8192] [--device cuda:0|cpu] [--backend nccl|gloo]
        [--out FILE]

Start one invocation per rank, all with the same arguments but the rank;
they meet at tcp://localhost:<port>.  The world forms a ('dp', 'limb')
mesh of world/n_limb x n_limb ranks and runs ShardedPipelines
(mul_relin_block_reduce, the additive block reduce over the whole batch,
then batched_mul_relin timed), or with --n-coeff a ('dp', 'coeff') mesh
running CoeffShardedPipelines.  Every rank makes the same deterministic
set-up (RandomSource(7): keys, two ciphertexts, a batch of distinct rows
made by rolling one of them along phim) and shards it.  The device
defaults to cuda:0 and the backend to nccl; NCCL refuses two ranks on one
card, so such a world takes gloo, and the CPU runs only when asked for.

Rank 0 writes a JSON artifact: the block reduce's sha256 and value, the
sha256 of the gathered batched output and of the unsharded
DeviceContext.mul_relin on the same inputs, the best time of a batched
step, and the first sharded call's kernel launches and time (the block
reduce, or on a coeff mesh the batched step).  Worlds
of every shape give the same numbers (tests/test_torch_distributed.py).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time

import torch
import torch.distributed as dist

from .. import DeviceContext, FheContext, sampling, scheme
from ..ops import cuda_build
from .mesh import (make_coeff_mesh, make_mesh, shard_batched_parts,
                   shard_matrix)
from .shard import CoeffShardedPipelines, ShardedPipelines

# the rings a world runs: the canonical reference config, the CPU tests'
# Cooley-Tukey ring and the card's main path
RINGS = {22: dict(m=22, log_q=80, p=23, generator=7),
         256: dict(m=256, log_q=80, p=257, generator=3),
         8192: dict(m=8192, log_q=80, p=40961, generator=3)}


def setup(m: int, n_limb: int, batch: int, device):
    """The deterministic set-up of every rank: the unsharded DeviceContext
    of ring m (chain padded to a multiple of n_limb), the secret key, the
    whole batch a, b [batch, 2, phim, n_ct] and the relinearization
    matrix [2, K, L, phim]."""
    ctx = FheContext(**RINGS[m], num_primes_multiple=n_limb)
    dev = DeviceContext(ctx, device)
    src = sampling.RandomSource(7)
    sk, pk = scheme.keygen(dev, src)
    ksw = scheme.KeySwitch.for_relinearization(sk, src)
    c1, c2 = (pk.encrypt(scheme.Plaintext(ctx, src.uniform_mod_p(ctx.phim,
                                                                 ctx.p)), src)
              for _ in range(2))
    a = c1.parts.expand(batch, *c1.parts.shape).clone()
    b = c2.parts.expand(batch, *c2.parts.shape).clone()
    # distinct rows (rolled along phim), so the reduce is a real merge
    for i in range(batch):
        a[i] = torch.roll(a[i], i, dims=-2)
    return dev, sk, a, b, ksw.matrix_evals


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def sha256(t) -> str:
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("rank", type=int)
    ap.add_argument("world", type=int)
    ap.add_argument("--port", type=int, default=39731)
    ap.add_argument("--n-limb", type=int, default=1)
    ap.add_argument("--n-coeff", type=int, default=0)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--m", type=int, default=22, choices=sorted(RINGS))
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            print("run_distributed: CUDA is not available; pass "
                  "--device cpu --backend gloo to run on the CPU",
                  file=sys.stderr)
            return 1
        torch.cuda.set_device(device)
    dist.init_process_group(args.backend,
                            init_method=f"tcp://localhost:{args.port}",
                            world_size=args.world, rank=args.rank)
    try:
        if args.n_coeff:
            mesh = make_coeff_mesh(args.n_coeff, device)
        else:
            mesh = make_mesh(args.world // args.n_limb, args.n_limb, device)
        dev, _, a, b, matrix = setup(args.m, args.n_limb, args.batch, device)
        if args.n_coeff:
            pipe = CoeffShardedPipelines(dev, mesh)
        else:
            pipe = ShardedPipelines(dev.ctx, mesh)
        a_loc, b_loc = shard_batched_parts(mesh, a), shard_batched_parts(mesh, b)
        mat_loc = shard_matrix(mesh, matrix)

        step = lambda: pipe.batched_mul_relin(a_loc, b_loc, mat_loc)  # noqa: E731
        reduced = None
        _sync(device)
        cuda_build.reset_launches()
        t0 = time.perf_counter()
        if args.n_coeff:
            out = step()
        else:
            reduced = pipe.mul_relin_block_reduce(a_loc, b_loc, mat_loc)
        _sync(device)
        first = time.perf_counter() - t0
        launches = dict(cuda_build.LAUNCHES)
        if not args.n_coeff:
            out = step()
        best = float("inf")
        for _ in range(args.steps):
            dist.barrier()
            t0 = time.perf_counter()
            step()
            _sync(device)
            best = min(best, time.perf_counter() - t0)
        if args.n_coeff:
            out = mesh.all_gather(out, "coeff", dim=-2)
        out = mesh.all_gather(out, "dp", dim=0)
        digest = None if reduced is None else sha256(reduced)
        print(f"rank {args.rank}/{args.world} mesh {mesh.shape} on {device} "
              f"({args.backend}), m={args.m} L={dev.L} B={args.batch}: "
              f"step {best * 1e3:.3f} ms (first {first:.3f} s), "
              f"{args.batch / best:.1f} mults/s, block reduce sha256 "
              f"{(digest or '-')[:16]}, launches {launches}", flush=True)
        if args.rank == 0 and args.out:
            with open(args.out, "w") as f:
                json.dump(dict(
                    num_processes=args.world, mesh=mesh.shape, m=args.m,
                    num_primes=dev.L, batch=args.batch, device=str(device),
                    backend=args.backend, sha256=digest,
                    reduce_result=(None if reduced is None
                                   else reduced.cpu().tolist()),
                    batched_sha256=sha256(out),
                    unsharded_sha256=sha256(dev.mul_relin(a, b, matrix)),
                    launches=launches, step_s=best,
                    mults_per_s=args.batch / best, first_call_s=first), f)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
