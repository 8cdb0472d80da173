"""CLI mirror of the reference Test_AddMul_x (Test_AddMul.cpp:115-171) on
the port.

usage: python -m fhe_si_tpu_torch.cli.test_addmul logQ p generator [seed]
           [--trials N] [--m M] [--device=cuda:0|cpu]

--m M overrides the ring index (default m = p-1, the reference's only
mode).  --device defaults to cuda:0 and the run refuses to start without
CUDA unless --device=cpu is given.

Without a seed: runs N random trials (default 100; the reference runs
5000) and exits with the number of failures.  With a seed: runs that one
case verbosely.
"""
import argparse
import sys
import time

import numpy as np

from .. import DeviceContext, FheContext, sampling, scheme
from ..hostmath import oracle
from .common import pick_device


def run_test(ctx, keys, seed: int, disp: bool) -> bool:
    sk, pk, ksw = keys
    src = sampling.RandomSource(seed)
    p = ctx.p

    m1 = src.uniform_mod_p(ctx.phim, p)
    m2 = src.uniform_mod_p(ctx.phim, p)

    sum_ = (m1 + m2) % p
    sum_mult = (m2 * 7) % p
    prod = oracle.plaintext_mul(ctx, m1, m2)
    prod2 = oracle.plaintext_mul(ctx, prod, prod)
    sum_quad = (oracle.plaintext_mul(ctx, prod2, prod2) * 9) % p

    c1 = pk.encrypt(scheme.Plaintext(ctx, m1), src)
    c2 = pk.encrypt(scheme.Plaintext(ctx, m2), src)

    c_sum = c1 + c2
    c_sum_mult = c2
    for _ in range(6):
        c_sum_mult = c_sum_mult + c2
    c_prod = ksw.apply(c1 * c2)

    checks = {
        "Add": (c_sum, sum_),
        "Adding multiple times": (c_sum_mult, sum_mult),
        "Multiply": (c_prod, prod),
    }

    c_p2_t = c_prod * c_prod
    c_prod2 = ksw.apply(c_p2_t)
    checks["Squaring"] = (c_prod2, prod2)

    c_sq = c_p2_t
    for _ in range(8):
        c_sq = c_sq + c_p2_t
    c_sq = ksw.apply(c_sq)
    c_sq = ksw.apply(c_sq * c_prod2)
    checks["Sum and quad"] = (c_sq, sum_quad)

    success = True
    for name, (ct, want) in checks.items():
        got = sk.decrypt(ct).message
        if not np.array_equal(got, np.asarray(want) % p):
            success = False
            print(f"{name} failed.")
    if disp or not success:
        print(f"Seed: {seed}")
        print(f"Test {'SUCCEEDED' if success else 'FAILED'}")
    return success


def main(argv):
    ap = argparse.ArgumentParser(
        prog="test_addmul",
        usage="test_addmul logQ p generator [seed] [--trials N] [--m M] "
              "[--device=cuda:0|cpu]")
    ap.add_argument("logQ", type=int)
    ap.add_argument("p", type=int)
    ap.add_argument("generator", type=int)
    ap.add_argument("seed", type=int, nargs="?", default=None)
    ap.add_argument("--trials", type=int, default=100)
    ap.add_argument("--m", type=int, default=None)
    ap.add_argument("--device", default="cuda:0")
    try:
        ns = ap.parse_args(argv[1:])
    except SystemExit:
        return 1
    device = pick_device(ns.device, "test_addmul")
    if device is None:
        return 1
    log_q, p, g, trials = ns.logQ, ns.p, ns.generator, ns.trials

    print("=" * 50)
    print("Running add/multiply tests using Brakerski system.")
    print("=" * 50)
    ctx = FheContext(m=ns.m if ns.m else p - 1, log_q=log_q, p=p,
                     generator=g)
    dev = DeviceContext(ctx, device)
    print("Finished setting up context.")

    key_src = sampling.RandomSource(0xF9E51)
    sk, pk = scheme.keygen(dev, key_src)
    ksw = scheme.KeySwitch.for_relinearization(sk, key_src)
    keys = (sk, pk, ksw)

    if ns.seed is not None:
        ok = run_test(ctx, keys, ns.seed, disp=True)
        return 0 if ok else 1

    start = int(time.time())
    failed = 0
    for it in range(trials):
        if not run_test(ctx, keys, start + it, disp=False):
            failed += 1
        if it % 100 == 0:
            print(".", end="", flush=True)
    print()
    if failed == 0:
        print("All tests SUCCEEDED!")
    else:
        print(f"{failed} of {trials} failed.")
    return failed


if __name__ == "__main__":
    sys.exit(main(sys.argv))
