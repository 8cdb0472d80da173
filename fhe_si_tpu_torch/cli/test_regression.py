"""CLI mirror of Test_Regression_x (Test_Regression.cpp:69-131) on the
port.

usage: python -m fhe_si_tpu_torch.cli.test_regression datafile p generator
           [seed] [--m=M] [--device=cuda:0|cpu] [--trace DIR]

--m=M overrides the ring index (default m = p-1, the reference's only
mode); the port runs power-of-two m.  --device defaults to cuda:0 and
the run refuses to start without CUDA unless --device=cpu is given.
--trace DIR writes a torch.profiler trace of the regression phase into DIR
(profiling.device_trace; the card's kernels by name when it runs on CUDA).
Prints MATCH and exits 0 when every decrypted value equals the
plaintext oracle mod p, else MISMATCH and 1.
"""
import contextlib
import sys

from .. import DeviceContext, FheContext, sampling
from ..apps import regression as reg
from ..profiling import PhaseProfiler, device_trace
from .common import describe, parse


def main(argv):
    args = parse(argv, "test_regression")
    if args is None:
        return 1
    p = args.p
    raw, labels, dim = reg.load_data(args.datafile)
    log_q, xi = reg.derive_log_q(len(labels), dim, p)

    print("=" * 48)
    print("Running regression tests using Brakerski system.")
    print("=" * 48)
    print(f"Parameters:\n  data file: {args.datafile}\n  logQ: {log_q}"
          f"\n  p: {p}\n  generator: {args.g}")

    theta_pt, det_pt = reg.regress_pt(raw, labels)
    print("Expected values:")
    for i, t in enumerate(theta_pt):
        print(f"  theta[{i}] = {t % p}")
    print(f"  Determinant: {det_pt % p}\n")

    prof = PhaseProfiler(args.device)
    with prof.phase("setup"):
        ctx = FheContext(m=args.m or p - 1, log_q=log_q, p=p,
                         generator=args.g, xi=xi)
        model = reg.Regression(DeviceContext(ctx, args.device),
                               sampling.RandomSource(args.seed))
    print(describe(ctx, args.device))
    print(f"Setup time: {prof.times['setup']:.2f}")

    with prof.phase("batch"):
        ptxt_data, ptxt_labels = reg.batch_data(ctx, raw, labels)
    print(f"Batch time: {prof.times['batch']:.2f}")

    with prof.phase("encryption"):
        model.add_data(ptxt_data, ptxt_labels)
    print(f"Encryption time: {prof.times['encryption']:.2f}")

    tr = device_trace(args.trace) if args.trace else contextlib.nullcontext()
    with prof.phase("regression"), tr:
        theta_enc, det_enc = model.regress()
    print(f"Regression time: {prof.times['regression']:.2f}")

    with prof.phase("decryption"):
        print("\nComputed values:")
        ok = True
        pts = model.secret_key.decrypt_batch(list(theta_enc) + [det_enc])
        for i, pt in enumerate(pts[:-1]):
            got = int(pt.decode_slots()[0])
            print(f"  theta[{i}] = {got}")
            ok &= got == theta_pt[i] % p
        det_got = int(pts[-1].decode_slots()[0])
        print(f"  Determinant: {det_got}\n")
        ok &= det_got == det_pt % p
    print(f"Decryption time: {prof.times['decryption']:.2f}")
    print(f"Total time: {prof.total():.2f}")
    print(f"[phases] {prof.as_json()}", file=sys.stderr)
    print("MATCH" if ok else "MISMATCH")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv))
