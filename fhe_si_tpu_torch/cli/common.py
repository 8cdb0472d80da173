"""What the port's CLIs share: the app CLIs' arguments, the device
choice and phase timing that waits for the card."""
from __future__ import annotations

import contextlib
import json
import sys
import time
from typing import NamedTuple

import torch


class Args(NamedTuple):
    datafile: str
    p: int
    g: int
    seed: int
    m: int | None
    device: torch.device


def parse(argv, name: str) -> Args | None:
    """datafile p generator [seed] [--m=M] [--device=D] [--trace DIR].
    Prints the reason and returns None when the run cannot start."""
    argv = list(argv)
    if "--trace" in argv:
        print(f"{name}: --trace is not ported yet (ROADMAP item 10)",
              file=sys.stderr)
        return None
    m, device = None, "cuda:0"
    for a in list(argv):
        if a.startswith("--m="):
            m = int(a.split("=", 1)[1])
            argv.remove(a)
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
            argv.remove(a)
    if len(argv) < 4:
        print(f"usage: {name} datafile p generator [seed] [--m=M] "
              "[--device=cuda:0|cpu]")
        return None
    device = pick_device(device, name)
    if device is None:
        return None
    seed = int(argv[4]) if len(argv) > 4 else int(time.time())
    return Args(argv[1], int(argv[2]), int(argv[3]), seed, m, device)


def pick_device(spec: str, name: str) -> torch.device | None:
    """The --device value as a torch.device (CUDA by default, the CPU
    only when asked for).  Prints the reason and returns None when the
    run cannot start there."""
    device = torch.device(spec)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"{name}: CUDA is not available; pass --device=cpu to run on "
              "the CPU", file=sys.stderr)
        return None
    if device.type not in ("cuda", "cpu"):
        print(f"{name}: no kernels for device {device}", file=sys.stderr)
        return None
    return device


class Profiler:
    """Phase wall times under the reference's phase names (the
    PhaseProfiler of fhe_si_tpu/profiling.py).  A phase ends only when the
    card's queued work has finished, so a phase time on CUDA is not a
    launch time."""

    def __init__(self, device: torch.device):
        self.device = device
        self.times: dict[str, float] = {}
        self._t0 = time.perf_counter()

    @contextlib.contextmanager
    def phase(self, name: str):
        start = time.perf_counter()
        try:
            yield
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        finally:
            self.times[name] = self.times.get(name, 0.0) + (
                time.perf_counter() - start)

    def total(self) -> float:
        return time.perf_counter() - self._t0

    def as_json(self) -> str:
        return json.dumps(dict(self.times, total=self.total()))


def describe(ctx, device: torch.device) -> str:
    return (f"  m: {ctx.m}\n  primes: {ctx.num_primes} "
            f"({'wide' if ctx.wide else 'narrow'} lane)\n  device: {device}")
