"""Structured phase timing and device tracing (SURVEY §5: tracing and
profiling).

Counterpart of fhe_si_tpu/profiling.py.  The reference prints ad-hoc
clock() deltas per phase (Test_Regression.cpp:24-64,
Test_Statistics.cpp:112-173); PhaseProfiler keeps the same phase names
and report.  On a CUDA device a phase ends only when the card's queued
work has finished, so a phase time there is not a launch time.

Usage:
    prof = PhaseProfiler(device)
    with prof.phase("encryption"):
        ...
    print(prof.report())          # human-readable, reference-style
    prof.as_dict()                # structured {phase: seconds}

    with device_trace("/tmp/trace"):   # torch.profiler capture
        with annotate("step"):
            ...

    with counting() as table:          # no profiler: counts and host ns
        ...
    table["fhe.mul_relin"]             # [spans entered, total ns]

The program's spans (annotate, named fhe.<function>) mark mul+relin's
request (fhe.mul_relin), its four stages (fhe.tensor_mul, fhe.scale_down,
fhe.digits, fhe.keyswitch) and each wrapper that launches a hand-written
kernel (fhe.limbs_to_residues, fhe.crt_to_limbs, fhe.ct_fwd,
fhe.byte_decomp, fhe.ct_fwd_digits, fhe.ct_inv, fhe.tensor_product,
fhe.keyswitch_dot) or the dense transform (fhe.modmatmul), around the
whole wrapper; on the matmul route (ops/ntt_ct_matmul.py) its three
transforms (fhe.route_fwd, fhe.route_fwd_digits, fhe.route_inv) and,
inside them, on a split N x 1 the boundary kernels' wrappers
(fhe.route_enter, fhe.route_leave), on any other split each twiddle
(fhe.route_twiddle) and phim <-> N step (fhe.route_reindex); on a
mixed-radix ring each plain phim <-> N step of ops/ntt_ct.py that runs
under its own name (fhe.pad_to_N, fhe.drop_excluded, fhe.insert_excluded,
fhe.fold_mod_phim), inside the transform's span: on the CPU, and on the
card only where the kernel cannot do them itself
(ntt_ct_cuda.folds_in_kernel).  They go to one sink:
an open counting() table, else a recording torch.profiler capture, where
a span is a cpu_op event (RecordFunctionFast, several times cheaper on
the host than record_function's user_annotation) on the clock of the
card's kernels.  A runtime launch is correlated with
the innermost cpu_op around it, and the wrappers launch their
hand-written kernels through ctypes with no aten op between, so each
such kernel carries its wrapper's span name as its op in the Chrome
trace (bench_port/trace.py DeviceOp.op).  With neither sink, a span is
one shared no-op context and costs two global reads.

Beside the spans, module dicts count what the ops did, one increment
each and no device read, each zeroed by a reset function beside it
(LAUNCHES and SCHEDULES by one, reset_launches): ops/cuda_build.py
LAUNCHES and SCHEDULES (every kernel launch, by wrapper and by the
transform kernel's schedule), ops/ntt_ct_cuda.py PHIM_FUSED (transform
launches that did the phim <-> N steps inside) and TWIDDLE_GLOBAL
(transform launches whose layout left the twiddle pairs in global
memory: 1, 1 and 2 a mul+relin at m = 2^15), ops/ntt_ct.py PHIM_STEPS
(the plain phim <-> N steps) and ops/ntt_ct_matmul.py CALLS and
PRODUCTS (the matmul route's transforms and GEMMs).
"""
from __future__ import annotations

import contextlib
import json
import os
import socket
import time
from collections import OrderedDict

import torch
from torch.autograd import profiler as _autograd_profiler


class PhaseProfiler:
    REFERENCE_PHASES = ("setup", "batch", "encryption", "computation",
                        "decryption", "total")

    def __init__(self, device=None):
        self.device = None if device is None else torch.device(device)
        self.times: "OrderedDict[str, float]" = OrderedDict()
        self._t0 = time.perf_counter()

    @contextlib.contextmanager
    def phase(self, name: str):
        start = time.perf_counter()
        try:
            yield
            if self.device is not None and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        finally:
            self.times[name] = self.times.get(name, 0.0) + (
                time.perf_counter() - start)

    def total(self) -> float:
        return time.perf_counter() - self._t0

    def report(self) -> str:
        lines = [f"{name.capitalize()} time: {secs:.2f}"
                 for name, secs in self.times.items()]
        lines.append(f"Total time: {self.total():.2f}")
        return "\n".join(lines)

    def as_dict(self) -> dict:
        d = dict(self.times)
        d["total"] = self.total()
        return d

    def as_json(self) -> str:
        return json.dumps(self.as_dict())


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a torch.profiler trace of the block: host activity, and the
    card's kernels when CUDA is in use in this process.  Writes a Chrome
    trace (chrome://tracing, Perfetto) into log_dir as
    <host>_<pid>.<ms>.pt.trace.json."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        log_dir, f"{socket.gethostname()}_{os.getpid()}."
        f"{time.time_ns() // 1_000_000}.pt.trace.json"))


_OFF = contextlib.nullcontext()   # the span of a run with no sink
_table: dict | None = None        # the open counting() table, if any
_record = torch._C._profiler._RecordFunctionFast  # a span under a capture


class _Counted:
    """A span while a counting() table is open: one more entry and the
    elapsed host ns under its name."""
    __slots__ = ("name", "table", "t0")

    def __init__(self, name: str, table: dict):
        self.name, self.table = name, table

    def __enter__(self):
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        entry = self.table.setdefault(self.name, [0, 0])
        entry[0] += 1
        entry[1] += time.perf_counter_ns() - self.t0


def annotate(name: str):
    """A named span: counted and timed while a counting() table is open,
    else a cpu_op event while a capture records, else the one shared
    no-op context (no record function, no dispatcher call)."""
    if _table is not None:
        return _Counted(name, _table)
    if _autograd_profiler._is_profiler_enabled:
        return _record(name)
    return _OFF


@contextlib.contextmanager
def counting():
    """Count the spans entered in the block, with their host time: yields
    the table {name: [spans entered, total ns]} it fills, nested spans
    each under their own name.  Needs no profiler and writes nothing;
    spans counted here do not reach a capture."""
    global _table
    saved, _table = _table, {}
    try:
        yield _table
    finally:
        _table = saved
