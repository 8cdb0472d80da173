"""Median host time (ms) for mul_relin to return, before its synchronise,
over the calls of the measured window (outside the profiler)."""
from bench_port.readers import enqueue_ms as read  # noqa: F401
