"""What the per-layer metrics of metrics/ share: each file there names one
metric and reads it with one of these from a run's Readings (run.py)."""
from __future__ import annotations

import re
import statistics

NTT_KERNELS = re.compile(r"\bct_mma_kernel\b")
CRT_KERNELS = re.compile(r"\b(crt_pass_kernel|crt_kernel|lift_kernel)\b")
MODULAR_KERNELS = re.compile(r"\b(tensor_product_kernel|keyswitch_dot_kernel)\b")
DENSE_OPS = ("aten::mm", "aten::matmul", "aten::bmm", "aten::addmm",
             "aten::baddbmm")


def idle_pct(r) -> float | None:
    """Share of the traced window with nothing running on the device."""
    if not r.trace.window_us:
        return None
    return 100.0 * (1.0 - r.trace.busy_us / r.trace.window_us)


def launches_per_step(r) -> float | None:
    """Device operations (kernels, copies, sets) per mul_relin call."""
    if not r.trace.calls:
        return None
    return len(r.trace.ops) / r.trace.calls


def enqueue_ms(r) -> float | None:
    """Median host time for mul_relin to return, before its synchronise."""
    return statistics.median(r.enqueue_s) * 1e3 if r.enqueue_s else None


def roofline_pct(r, bound_ms: float, device_us: float) -> float | None:
    """100 x the step's bound over the device time per call of the
    kernels that do that work; None where the trace holds none."""
    if not device_us or not r.trace.calls:
        return None
    return 100.0 * bound_ms * 1e3 / (device_us / r.trace.calls)


def kernels_roofline(r, pattern, bound) -> float | None:
    """roofline_pct of the kernels whose names match pattern, with the
    step's bound(r.step) of their work."""
    us = r.trace.device_us(pattern.search)
    return roofline_pct(r, bound(r.step), us) if us else None


def dense_roofline(r) -> float | None:
    if r.step.split is not None:
        return None
    us = sum(o.dur for o in r.trace.ops if o.op in DENSE_OPS)
    return roofline_pct(r, r.step.dense_ms(), us)
