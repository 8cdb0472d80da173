"""CLI mirror of Test_Statistics_x (Test_Statistics.cpp:178-244) on the
port.

usage: python -m fhe_si_tpu_torch.cli.test_statistics datafile p generator
           [seed] [--m=M] [--device=cuda:0|cpu] [--trace DIR]

Arguments as in test_regression.py.  Prints MATCH and exits 0 when the
decrypted mean, N, covariance and N^2 equal the plaintext oracle mod p,
else MISMATCH and 1.
"""
import contextlib
import sys

from .. import DeviceContext, FheContext, sampling
from ..apps import statistics as st
from ..profiling import PhaseProfiler, device_trace
from .common import describe, parse


def main(argv):
    args = parse(argv, "test_statistics")
    if args is None:
        return 1
    p = args.p
    data, dim = st.load_data(args.datafile)
    n_rows = data.num_rows()
    log_q, xi = st.derive_log_q(n_rows, dim, p)

    print("=" * 48)
    print("Running statistics test using Brakerski system.")
    print("=" * 48)
    print(f"Parameters:\n  data file: {args.datafile}\n  logQ: {log_q}"
          f"\n  p: {p}\n  generator: {args.g}")

    mean_pt = st.compute_nth_moment_pt(data, 1)
    cov_pt = st.compute_covariance_pt(data)
    print("Expected values:")
    print("  Mean:", ", ".join(str(v % p) for v in mean_pt))
    print(f"  N: {n_rows % p}")
    print("  Covariance:")
    for i in range(cov_pt.num_rows()):
        print("   ", " ".join(str(cov_pt.at(i, j) % p)
                              for j in range(cov_pt.num_cols())))
    print(f"  N^2: {(n_rows % p) ** 2 % p}\n")

    prof = PhaseProfiler(args.device)
    with prof.phase("setup"):
        ctx = FheContext(m=args.m or p - 1, log_q=log_q, p=p,
                         generator=args.g, xi=xi)
        stats = st.Statistics(DeviceContext(ctx, args.device),
                              sampling.RandomSource(args.seed))
    print(describe(ctx, args.device))
    print(f"Setup time: {prof.times['setup']:.2f}")

    with prof.phase("batch"):
        blocks, block_sizes = st.batch_data(ctx, data)
    print(f"Batch time: {prof.times['batch']:.2f}")

    with prof.phase("encryption"):
        stats.add_data(blocks, block_sizes)
    print(f"Encryption time: {prof.times['encryption']:.2f}")

    tr = device_trace(args.trace) if args.trace else contextlib.nullcontext()
    with prof.phase("computation"), tr:
        cov_enc, mu_enc, n_enc, n2_enc = stats.compute_covariance()
    print(f"Computation time: {prof.times['computation']:.2f}")

    with prof.phase("decryption"):
        print("\nComputed values:")
        d = cov_enc.num_rows()
        cts = (list(mu_enc) + [n_enc]
               + [cov_enc.at(i, j) for i in range(d) for j in range(d)]
               + [n2_enc])
        vals = [int(pt.decode_slots()[0])
                for pt in stats.secret_key.decrypt_batch(cts)]
        mean_got, rest = vals[:len(mu_enc)], vals[len(mu_enc):]
        n_got, cov_got, n2_got = rest[0], rest[1:1 + d * d], rest[-1]
        print("  Mean:", ", ".join(map(str, mean_got)))
        ok = mean_got == [v % p for v in mean_pt]
        print(f"  N: {n_got}")
        ok &= n_got == n_rows % p
        print("  Covariance:")
        for i in range(d):
            row = cov_got[i * d:(i + 1) * d]
            for j in range(d):
                ok &= row[j] == cov_pt.at(i, j) % p
            print("   ", " ".join(map(str, row)))
        print(f"  N^2: {n2_got}")
        ok &= n2_got == (n_rows % p) ** 2 % p
    print(f"Decryption time: {prof.times['decryption']:.2f}")
    print(f"Total time: {prof.total():.2f}")
    print(f"[phases] {prof.as_json()}", file=sys.stderr)
    print("MATCH" if ok else "MISMATCH")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv))
