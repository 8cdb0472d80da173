#!/usr/bin/env python3
"""One run of one cell of fhe_si_tpu_torch's benchmark on the CUDA cards
of this machine:

    python3 bench_port/run.py --workload ct8192_q80.b64 --seed 7 \\
        --seconds 10 --trace 0

Set-up (counted in setup_s, from the start of this script to the first
timed call): import, kernel load (built into fhe_si_tpu_torch/_build/
in the checkout on a first run), the configuration's contexts and
tables, keys, the relinearization key, the encrypted pool of operand
batches, and two warm-up calls on each pool entry.  Then the window: one
caller issues DeviceContext.mul_relin on the next pool entry, waits for
it (torch.cuda.synchronize) and issues the next, for --seconds.  With
--trace 1 a torch.profiler capture of a few more calls follows, and the
result carries the cell's per-layer metrics instead of its end-to-end
ones.  Last, the plain reference judges the outputs the window produced
(check.py).  The last line of standard output is the result as one JSON
object; the numbers compared, with their limits, are the last lines of
standard error.  Without a CUDA card (or with fewer than the cell asks
for) the run exits 2 and prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_port import cell as cells  # noqa: E402
from bench_port import check, inputs, program, roofline, trace  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "fhe_si_tpu")
TRACE_SECONDS = 0.3          # the profiled capture: about this long,
TRACE_CALLS = (10, 300)      # and between these many calls


@dataclass
class Readings:
    """What a per-layer metric's reader (metrics/<name>.py) reads."""
    cell: object             # cell.Cell
    step: roofline.Step      # the shapes of one call
    trace: trace.Trace       # the profiled calls
    enqueue_s: list          # host seconds for mul_relin to return, per call


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def step_shapes(ctx, batch: int) -> roofline.Step:
    return roofline.Step(
        batch=batch, phim=ctx.phim, L=ctx.num_primes, Lk=len(ctx.ksw_rows),
        n=roofline.recon_limbs(ctx.primes),
        nk=roofline.recon_limbs(ctx.primes[ctx.ksw_rows]),
        n_ct=ctx.n_limbs_ct, ndigits=ctx.ndigits,
        split=roofline.ct_split(ctx.m) if ctx.use_ct else None)


def run_cell(cell, seed: int, seconds: float, traced: bool, device,
             t_start: float) -> dict:
    """Set-up, window, trace and check of one run; returns the result
    line's fields and the check's numbers."""
    import torch
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    prog = program.setup(cell.config, cell.traffic, seed, device)
    entries, batch = len(prog.a), cell.traffic["pairs_per_call"]
    for _ in range(2):
        for k in range(entries):
            prog.mul_relin(k)
    sync()
    setup_s = time.perf_counter() - t_start

    first, last, t0s, t1s = {}, {}, [], []
    start = time.perf_counter()
    k = 0
    while True:
        e = k % entries
        t0 = time.perf_counter()
        out = prog.mul_relin(e)
        t1 = time.perf_counter()
        sync()
        t2 = time.perf_counter()
        t0s.append(t0)
        t1s.append(t1)
        if k < entries:
            first[e] = out
        last[e] = out
        k += 1
        if t2 - start >= seconds:
            break
    wall = t2 - t0s[0]
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    result = {"attempted": k * batch}
    if traced:
        calls = min(max(math.ceil(TRACE_SECONDS * k / wall), TRACE_CALLS[0]),
                    TRACE_CALLS[1])

        def one(i):
            with torch.profiler.record_function(trace.CALL):
                with torch.profiler.record_function(trace.ENQUEUE):
                    prog.mul_relin(i % entries)
                with torch.profiler.record_function(trace.SYNC):
                    sync()
        tr = trace.capture(one, calls)
        got = Readings(cell, step_shapes(prog.ctx, batch), tr,
                       [b - a for a, b in zip(t0s, t1s)])
        metrics = {}
        for m in cell.per_layer:
            value = cell.reader(m["name"])(got)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["metrics"] = metrics
        result["trace"] = {"busy_s": tr.busy_us / 1e6,
                           "window_s": tr.window_us / 1e6}
        result["breakdown"] = trace.breakdown(tr)
    else:
        # a name's part before its first dot is the quantity it reports
        # (mults_per_s.host: mults_per_s in a cell the host paces)
        e2e = {"setup_s": setup_s, "mults_per_s": k * batch / wall}
        result["metrics"] = {m["name"]: {"value": e2e[m["name"].split(".")[0]],
                                         "unit": m["unit"]}
                             for m in cell.end_to_end}
    result["memory_peak_bytes"] = peak

    outputs = {pair: [first[pair[0]][pair[1]].cpu().numpy(),
                      last[pair[0]][pair[1]].cpu().numpy()]
               for pair in inputs.checked_pairs(seed, cell.traffic)}
    del prog, first, last, out
    if on_card:
        torch.cuda.empty_cache()
    result["check"] = check.judge(cell.config, cell.traffic, seed, outputs)
    return result


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi failed: {exc}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = cells.load(args.workload)

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); this machine "
              f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0",
                   T_START)
    found = forbidden_modules()
    if found:
        print(f"loaded in the measuring process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    numbers = res["check"]
    correct = numbers["mismatched_limbs"] <= check.LIMIT
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips, "memory_peak_bytes": res["memory_peak_bytes"],
              "card": card_line()}
    if args.trace:
        device.update(res["trace"])
    line = {"correct": correct, "attempted": res["attempted"],
            "failed": numbers["failed_outputs"], "metrics": res["metrics"],
            "device": device}
    if args.trace:
        line["breakdown"] = res["breakdown"]
    line["checks"] = {"mismatched_limbs": {
        "value": numbers["mismatched_limbs"], "limit": check.LIMIT}}
    print(json.dumps(line))
    sys.stdout.flush()
    print(f"judged {numbers['judged_outputs']} outputs of the window",
          file=sys.stderr)
    print(f"check mismatched_limbs {numbers['mismatched_limbs']} "
          f"limit {check.LIMIT}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
