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
"""
from __future__ import annotations

import contextlib
import json
import os
import socket
import time
from collections import OrderedDict

import torch


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


def annotate(name: str):
    """Named region inside a device trace (torch.profiler.record_function)."""
    return torch.profiler.record_function(name)
