"""Random linear-data generator (reference scripts/generateRandomData.py:1-45,
ported from Python 2):  y = sum(c_i * x_i) + N(0, 100), x in [-100, 100],
coefficients in [-20, 20]; optional nFiles split for block-parallel runs.

The port's copy of fhe_si_tpu/cli/gen_data.py: the same seed writes the
same file.

usage: python -m fhe_si_tpu_torch.cli.gen_data filename d N [nFiles]
"""
import random
import sys


def generate(filename: str, dim: int, n: int, n_files: int = 1, seed=None):
    rng = random.Random(seed)
    coeffs = [rng.randint(-20, 20) for _ in range(dim)]
    rows = []
    for _ in range(n):
        xs = [rng.randint(-100, 100) for _ in range(dim)]
        y = sum(c * x for c, x in zip(coeffs, xs)) + int(rng.gauss(0, 100))
        rows.append(xs + [y])

    per = (n + n_files - 1) // n_files
    names = []
    for f in range(n_files):
        chunk = rows[f * per:(f + 1) * per]
        if not chunk:
            break
        name = filename if n_files == 1 else f"{filename}.{f}"
        with open(name, "w") as out:
            out.write(f"{dim} {len(chunk)}\n")
            for row in chunk:
                out.write(" ".join(str(v) for v in row) + "\n")
        names.append(name)
    return coeffs, names


def main(argv):
    if len(argv) < 4:
        print("usage: gen_data filename d N [nFiles]")
        return 1
    filename, dim, n = argv[1], int(argv[2]), int(argv[3])
    n_files = int(argv[4]) if len(argv) > 4 else 1
    coeffs, names = generate(filename, dim, n, n_files)
    print(f"true coefficients: {coeffs}")
    print(f"wrote: {', '.join(names)}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
