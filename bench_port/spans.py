"""A cell's calls split by the program's own spans: the fhe.* spans of
fhe_si_tpu_torch (profiling.annotate around mul+relin, its four stages
and each kernel wrapper), read from a profiler capture's events
(attribute) and from the program's counting() tables, which need no
profiler (host_split).  Pure functions of what they are given, for a
per-layer reader; run.py and trace.py do not call them yet.
"""
from __future__ import annotations

import bisect
import statistics
from collections import defaultdict

from bench_port import trace

PREFIX = "fhe."
REQUEST = "fhe.mul_relin"
UNATTRIBUTED = "unattributed"
# the wrappers that launch a hand-written kernel, and the dense transform
WRAPPERS = ("fhe.limbs_to_residues", "fhe.crt_to_limbs", "fhe.ct_fwd",
            "fhe.ct_fwd_digits", "fhe.ct_inv", "fhe.tensor_product",
            "fhe.keyswitch_dot", "fhe.modmatmul")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _innermost(spans, starts, t):
    """The name of the innermost span of spans ((start, end, name), nested,
    by start and outer first where two start together) that holds time t,
    or None."""
    for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
        if spans[i][1] >= t:
            return spans[i][2]
    return None


def attribute(events: list) -> dict:
    """Per fhe.* span name, over the window of the benchmark's calls
    (trace.CALL) and per call: instances, host us, self host us (less its
    fhe.* children), device us and launches of the operations whose host
    launch lies innermost in it (matched by correlation id through the
    cuda_runtime or cuda_driver event), and idle us whose midpoint lies
    innermost in it.  What no span holds is under UNATTRIBUTED."""
    calls = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("name") == trace.CALL and "dur" in e]
    if not calls:
        return {}
    t0 = min(e["ts"] for e in calls)
    t1 = max(e["ts"] + e["dur"] for e in calls)
    spans = sorted(((float(e["ts"]), float(e["ts"] + e["dur"]), e["name"])
                    for e in events if e.get("cat") == "user_annotation"
                    and e.get("name", "").startswith(PREFIX) and "dur" in e
                    and t0 <= e["ts"] < t1), key=lambda s: (s[0], -s[1]))
    starts = [s[0] for s in spans]
    out: dict = defaultdict(lambda: dict.fromkeys(
        ("instances", "host_us", "self_host_us", "device_us", "launches",
         "idle_us"), 0.0))
    open_spans = []                         # the spans around this one
    for s, e, name in spans:
        while open_spans and open_spans[-1][1] < e:
            open_spans.pop()
        out[name]["instances"] += 1
        out[name]["host_us"] += e - s
        out[name]["self_host_us"] += e - s
        if open_spans:
            out[open_spans[-1][2]]["self_host_us"] -= e - s
        open_spans.append((s, e, name))
    launched = {(e.get("args") or {}).get("correlation"): float(e["ts"])
                for e in events if e.get("cat") in LAUNCH_CATS}
    ops = []
    for e in events:
        if e.get("cat") not in trace.DEVICE_CATS or "dur" not in e:
            continue
        s, d = max(float(e["ts"]), t0), min(float(e["ts"] + e["dur"]), t1)
        if d <= s:
            continue
        ops.append((s, d))
        at = launched.get((e.get("args") or {}).get("correlation"))
        name = None if at is None else _innermost(spans, starts, at)
        out[name or UNATTRIBUTED]["device_us"] += d - s
        out[name or UNATTRIBUTED]["launches"] += 1
    _, gaps = trace._union(ops)
    if ops:
        gaps = ([(t0, min(s for s, _ in ops))] + gaps
                + [(max(d for _, d in ops), t1)])
    else:
        gaps = [(t0, t1)]
    for s, e in gaps:
        if e > s:
            name = _innermost(spans, starts, (s + e) / 2)
            out[name or UNATTRIBUTED]["idle_us"] += e - s
    return {name: {k: v / len(calls) for k, v in row.items()}
            for name, row in out.items()}


def host_split(tables: list) -> dict:
    """The counting() tables of single calls -> per call: each span's
    entries and host ms (means), the request's median host ms, and its
    time inside the wrapper spans and outside them."""
    n = len(tables)
    per = defaultdict(lambda: [0, 0])
    for t in tables:
        for name, (count, ns) in t.items():
            per[name][0] += count
            per[name][1] += ns
    out = {"spans": {name: {"per_call": c / n, "ms": ns / n / 1e6}
                     for name, (c, ns) in sorted(per.items())}}
    if REQUEST not in per:
        return out
    wrapper_ms = sum(per[w][1] for w in WRAPPERS if w in per) / n / 1e6
    out.update(
        request_ms_median=statistics.median(
            t[REQUEST][1] for t in tables) / 1e6,
        wrapper_host_ms=wrapper_ms,
        plain_host_ms=per[REQUEST][1] / n / 1e6 - wrapper_ms)
    return out
