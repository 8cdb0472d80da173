"""What the port's CLIs share: the app CLIs' arguments and the device
choice."""
from __future__ import annotations

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
    trace: str | None


def parse(argv, name: str) -> Args | None:
    """datafile p generator [seed] [--m=M] [--device=D] [--trace DIR].
    Prints the reason and returns None when the run cannot start."""
    argv = list(argv)
    trace = None
    if "--trace" in argv:
        i = argv.index("--trace")
        if i + 1 == len(argv):
            print(f"{name}: --trace needs a directory", file=sys.stderr)
            return None
        trace = argv[i + 1]
        del argv[i:i + 2]
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
              "[--device=cuda:0|cpu] [--trace DIR]")
        return None
    device = pick_device(device, name)
    if device is None:
        return None
    seed = int(argv[4]) if len(argv) > 4 else int(time.time())
    return Args(argv[1], int(argv[2]), int(argv[3]), seed, m, device, trace)


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


def describe(ctx, device: torch.device) -> str:
    return (f"  m: {ctx.m}\n  primes: {ctx.num_primes} "
            f"({'wide' if ctx.wide else 'narrow'} lane)\n  device: {device}")
