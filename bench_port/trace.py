"""The traced part of a --trace 1 run: a torch.profiler capture of a few
timed calls, written to a file under TMPDIR, read back and deleted.

The benchmark's own spans mark each call ("bench.call", holding
"bench.mul_relin", the host's enqueue, and "bench.synchronize"); the
window is the first call's start to the last call's end.  What the
readers under metrics/ get (Trace): every device operation (kernel,
copy or set) in the window with the aten op that launched it, the
device's busy time (the union of those operations), and the device's
idle gaps named by what the host was doing in them.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
CALL, ENQUEUE, SYNC = "bench.call", "bench.mul_relin", "bench.synchronize"


@dataclass
class DeviceOp:
    name: str
    op: str          # the innermost aten op that launched it, else its name
    ts: float        # us
    dur: float       # us


@dataclass
class Trace:
    calls: int = 0
    window_us: float = 0.0
    busy_us: float = 0.0
    ops: list = field(default_factory=list)           # [DeviceOp]
    gaps: dict = field(default_factory=dict)          # host activity -> us

    def device_us(self, match) -> float:
        """Device time of the operations whose name satisfies match."""
        return sum(o.dur for o in self.ops if match(o.name))


def short_name(name: str) -> str:
    """A kernel's name without its return type, anonymous namespaces and
    parameter list, at most 120 characters."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("(", 1)[0][:120]


def capture(call, n_calls: int):
    """Run call(k) for k < n_calls under the profiler (CPU and CUDA
    activity); returns the parsed Trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        for k in range(n_calls):
            call(k)
    fd, path = tempfile.mkstemp(suffix=".pt.trace.json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return parse(json.load(f)["traceEvents"])
    finally:
        os.remove(path)


def _union(intervals) -> tuple[float, list]:
    """Total length of the union of (start, end) intervals, and the gaps
    between its pieces."""
    busy, gaps, end = 0.0, [], None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                gaps.append((end, s))
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy, gaps


def parse(events: list) -> Trace:
    calls = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("name") == CALL and "dur" in e]
    if not calls:
        return Trace()
    t0 = min(e["ts"] for e in calls)
    t1 = max(e["ts"] + e["dur"] for e in calls)
    op_of, ext_of = {}, {}
    for e in events:
        args = e.get("args") or {}
        if e.get("cat") == "cpu_op" and "External id" in args:
            op_of[args["External id"]] = e["name"]
        elif e.get("cat") == "cuda_runtime" and "correlation" in args:
            ext_of[args["correlation"]] = args.get("External id")
    ops = []
    for e in events:
        if e.get("cat") not in DEVICE_CATS or "dur" not in e:
            continue
        s, d = max(float(e["ts"]), t0), min(float(e["ts"] + e["dur"]), t1)
        if d <= s:
            continue
        args = e.get("args") or {}
        ext = args.get("External id") or ext_of.get(args.get("correlation"))
        ops.append(DeviceOp(e["name"], op_of.get(ext, e["name"]), s, d - s))
    busy, gaps = _union([(o.ts, o.ts + o.dur) for o in ops])
    if ops:
        first = min(o.ts for o in ops)
        last = max(o.ts + o.dur for o in ops)
        gaps = [(t0, first)] + gaps + [(last, t1)]
    else:
        gaps = [(t0, t1)]
    return Trace(calls=len(calls), window_us=t1 - t0, busy_us=busy, ops=ops,
                 gaps=_name_gaps(events, gaps))


def _name_gaps(events: list, gaps: list) -> dict:
    """Idle time by the host event innermost at each gap's midpoint (the
    latest to start of those that cover it)."""
    host = sorted((float(e["ts"]), float(e["ts"] + e["dur"]), e["name"])
                  for e in events
                  if e.get("cat") in HOST_CATS and "dur" in e)
    starts = [h[0] for h in host]
    out: dict = defaultdict(float)
    for s, e in gaps:
        if e <= s:
            continue
        mid = (s + e) / 2
        name = "host outside any traced event"
        for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            if host[i][1] >= mid:
                name = host[i][2]
                break
        out[name] += e - s
    return dict(out)


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time and the longest idle
    time by host activity, in seconds over the traced window."""
    by: dict = defaultdict(float)
    for o in tr.ops:
        by[short_name(o.name)] += o.dur
    return {"device_ops": [[n, t / 1e6] for n, t in sorted(
                by.items(), key=lambda kv: -kv[1])[:top]],
            "idle_gaps": [[n, t / 1e6] for n, t in sorted(
                tr.gaps.items(), key=lambda kv: -kv[1])[:top]]}
