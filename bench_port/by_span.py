"""What the readers of the program's span tags share.

The program's spans (fhe_si_tpu_torch profiling.annotate, named fhe.*)
are cpu_op events under a capture, and trace.parse gives each device
operation the innermost cpu_op around its launch as its op.  The
wrappers launch their hand-written kernels with no aten op between the
span and the launch, so such a kernel's op is its wrapper's span
(fhe.ct_inv, fhe.keyswitch_dot, ...), and an operation that an aten op
launched keeps that op.  These read a Trace by those tags.  Where no
operation carries a tag (a program whose spans are user_annotation
events, or that has none) each returns None.
"""
from __future__ import annotations

from bench_port.readers import DENSE_OPS, roofline_pct
from bench_port.roofline import modular_bound, ntt_bound

PREFIX = "fhe."
LIFT = "fhe.limbs_to_residues"      # the operands' lift: a call's first launch
KEYSWITCH = "fhe.keyswitch_dot"


def span_roofline(r, span: str, bound_ms: float) -> float | None:
    """roofline_pct of the operations tagged with `span`, against the
    step's bound_ms of their work; None where none carries the tag."""
    return roofline_pct(r, bound_ms, sum(o.dur for o in r.trace.ops
                                         if o.op == span))


def keyswitch_ms(step) -> float:
    """The keyswitch dot's bound: roofline.Step.modular_ms's second term."""
    return modular_bound("keyswitch_dot", step.batch, step.Lk, step.phim,
                         3 * step.ndigits)[0]


def ntt_ms(step) -> dict:
    """roofline.Step.ntt_ms's four terms, grouped by the wrapper span
    that runs them: 4 lifted parts forward, 3 x ndigits digit rows
    forward, 3 tensored and 2 keyswitched parts inverse."""
    B, args = step.batch, (step.phim,) + step.split
    return {"fhe.ct_fwd": ntt_bound("ct_fwd", 4 * B, step.L, *args)[0],
            "fhe.ct_fwd_digits": ntt_bound(
                "ct_fwd_digits", 3 * step.ndigits * B, step.Lk, *args)[0],
            "fhe.ct_inv": ntt_bound("ct_inv", 3 * B, step.L, *args)[0]
            + ntt_bound("ct_inv", 2 * B, step.Lk, *args)[0]}


def ntt_roofline(r, span: str) -> float | None:
    """The share of one transform wrapper's bound; None on a dense step
    (no split) and where no operation carries the span (the matmul
    route's transforms run under fhe.route_*)."""
    if r.step.split is None:
        return None
    return span_roofline(r, span, ntt_ms(r.step)[span])


def call_start_idle_ms(r) -> float | None:
    """Mean device idle (ms) before each call's first launch, the lift
    (LIFT, one launch a call), from the end of the latest operation that
    started before it to its start, over every lift that some operation
    in the window precedes: every call but the first, whose start opens
    the window.  None where no lift has one, or where the trace holds
    more lifts than calls."""
    ops = sorted(r.trace.ops, key=lambda o: o.ts)
    if sum(o.op == LIFT for o in ops) > r.trace.calls:
        return None
    idle, end = [], None
    for o in ops:
        if o.op == LIFT and end is not None:
            idle.append(max(o.ts - end, 0.0))
        end = o.ts + o.dur if end is None else max(end, o.ts + o.dur)
    return sum(idle) / len(idle) / 1e3 if idle else None


def plain_ms(r) -> float | None:
    """Device ms per call of every operation that no fhe.* span tags and
    no GEMM (an op of readers.DENSE_OPS) launched: what aten ops do
    around the hand-written kernels and the GEMMs.  None where no
    operation carries a tag."""
    ops = r.trace.ops
    if not r.trace.calls or not any(o.op.startswith(PREFIX) for o in ops):
        return None
    us = sum(o.dur for o in ops
             if not o.op.startswith(PREFIX) and o.op not in DENSE_OPS)
    return us / r.trace.calls / 1e3
