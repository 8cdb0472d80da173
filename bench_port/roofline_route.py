"""The yardstick of the matmul route (fhe_si_tpu_torch/ops/ntt_ct_matmul.py):
the least time of each of its transforms on the card, beside roofline.py's
bounds of the other families, from its peaks.

A route transform of an N1 x N2 split is two dense stage products per
prime in float64 on the FP64 tensor cores.  route_bound counts those
products' operations, 2 rows L N (N1 + N2), as roofline.ntt_bound counts
the Cooley-Tukey split's but without its int8 factor of 9; on the
reference's rings m = p - 1 the split is N x 1 (N = m/2 prime), so
nearly all of it is the N x N product.  An algorithm with fewer
operations (a Bluestein or Rader form) is a new yardstick, not this one.
"""
from __future__ import annotations

from bench_port import roofline


def route_bound(name: str, rows: int, L: int, phim: int, N: int, N1: int,
                N2: int) -> tuple[float, str]:
    """Least time (ms) of one route transform and what sets it: the two
    stages' 2 rows L N (N1 + N2) operations over the FP64 rate, or the
    float64 stage tables (8 L (N1^2 + N2^2) bytes) and the int32 input
    and output (phim wide, the digit transform's input once for all
    primes), each once, over HBM."""
    n_in = rows * phim if name == "ct_fwd_digits" else rows * L * phim
    nbytes = 8 * L * (N1 * N1 + N2 * N2) + 4 * (n_in + rows * L * phim)
    ops = 2 * rows * L * N * (N1 + N2)
    return roofline._bound(nbytes, ops, roofline.F64_OPS_PER_S)


def route_ms(step: roofline.Step) -> float:
    """The step's four transforms on the route, with the rows of
    roofline.Step.ntt_ms: 4 lifted parts forward, 3 tensored parts and 2
    keyswitched parts inverse, 3 x ndigits digit rows forward."""
    B, args = step.batch, (step.phim,) + step.split
    return sum(route_bound(name, rows, L, *args)[0] for name, rows, L in (
        ("ct_fwd", 4 * B, step.L), ("ct_inv", 3 * B, step.L),
        ("ct_inv", 2 * B, step.Lk),
        ("ct_fwd_digits", 3 * step.ndigits * B, step.Lk)))
