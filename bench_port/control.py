#!/usr/bin/env python3
"""The control of the benchmark's check: the plain reference put in the
program's place, computed one precision below what the configurations
state.  They state exact integer arithmetic mod 2^logQ; the control
carries the tensored parts into ScaleDown as float64 (53-bit) numbers,
the step a faster ScaleDown in floating point would take.  Its outputs go
through check.judge exactly as the program's do, and have to come out as
not correct:

    python3 bench_port/control.py --workload ct8192_q80.b64 --seeds 1 2 3

prints, per seed, the number compared (mismatched_limbs) beside its
limit.  No card is needed; the benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_port import cell as cells  # noqa: E402
from bench_port import check, inputs  # noqa: E402
from bench_port.reference import fhe_si  # noqa: E402


class Float64Scheme(fhe_si.Scheme):
    def scale_down(self, t) -> np.ndarray:
        x = np.array([float(v) for v in t])
        return self.reduce([int(v) for v in
                            np.floor((2.0 * x + self.q) / (2.0 * self.q))])


class ControlJudge(check.Judge):
    scheme_class = Float64Scheme


def outputs(config: dict, traffic: dict, seed: int) -> dict:
    """The control's outputs of the run's checked pairs, as the window
    would hold them (first and last call), at the ciphertext width."""
    width = config["context"]["log_q"] // fhe_si.LIMB_BITS + 1
    j = ControlJudge(config, traffic, seed)
    out = {}
    for pair in inputs.checked_pairs(seed, traffic):
        limbs = np.stack([fhe_si.to_limbs(x, width) for x in j.product(pair)])
        out[pair] = [limbs, limbs]
    return out


def reading(config: dict, traffic: dict, seed: int) -> dict:
    return check.judge(config, traffic, seed, outputs(config, traffic, seed))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = cells.load(args.workload)
    for seed in args.seeds:
        got = reading(cell.config, cell.traffic, seed)
        print(f"control {args.workload} seed {seed}: mismatched_limbs "
              f"{got['mismatched_limbs']} of {got['judged_outputs']} outputs "
              f"(limit {check.LIMIT}), correct "
              f"{got['mismatched_limbs'] <= check.LIMIT}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
