"""The system under test, fhe_si_tpu_torch, set up through its public API
from the benchmark's own draws: a DeviceContext of the configuration, the
keys, the relinearization key, and the pool of encrypted operand batches
that the window multiplies.  This is the only module of the benchmark
that imports the program."""
from __future__ import annotations

from dataclasses import dataclass

from . import inputs


@dataclass
class Program:
    dev: object              # fhe_si_tpu_torch.DeviceContext
    matrix: object           # the relinearization key's evaluations
    a: list                  # pool entries of operand parts [batch, 2, phim, n_ct]
    b: list
    ctx: object              # fhe_si_tpu_torch.FheContext

    def mul_relin(self, k: int):
        """The timed entry: one batched multiply + relinearize of pool
        entry k."""
        return self.dev.mul_relin(self.a[k], self.b[k], self.matrix)


def context(cfg: dict):
    from fhe_si_tpu_torch import FheContext
    c = cfg["context"]
    return FheContext(m=c["m"], log_q=c["log_q"], p=c["p"],
                      generator=c["generator"], decomp_size=c["decomp_size"],
                      stdev=c["stdev"])


def setup(cfg: dict, traffic: dict, seed: int, device) -> Program:
    import torch
    from fhe_si_tpu_torch import DeviceContext, sampling, scheme
    ctx = context(cfg)
    dev = DeviceContext(ctx, device)
    keys = inputs.keys(seed, cfg["context"], ctx.phim, ctx.ndigits)
    sk, pk = scheme.keygen(dev, sampling.KeyGenRandomness(
        s=keys.s, c0=keys.c0, c1=keys.c1))
    ksw = scheme.KeySwitch.for_relinearization(
        sk, sampling.KeySwitchRandomness(A=keys.A, e=keys.e))
    pool = inputs.pool(seed, cfg["context"], ctx.phim, traffic)
    entries, batch = pool.msgs.shape[:2]
    cts = pk.encrypt_batch(
        [scheme.Plaintext(ctx, m) for m in pool.msgs.reshape(-1, ctx.phim)],
        inputs.Replay(pool.r, pool.errors))
    parts = torch.stack([c.parts for c in cts])
    parts = parts.reshape((entries, batch, 2) + parts.shape[1:])
    return Program(dev, ksw.matrix_evals,
                   [parts[k, :, 0].contiguous() for k in range(entries)],
                   [parts[k, :, 1].contiguous() for k in range(entries)], ctx)
