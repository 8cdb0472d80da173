"""spans.py: the program's fhe.* spans in a capture and in the counting
table.  Adding the program's spans to a trace changes nothing that
trace.parse gives the benchmark's readers but the names of idle gaps;
attribute puts device operations and idle time down to the innermost
span; a small CPU run splits each call's host time by span."""
import torch

from bench_port import cell as cells
from bench_port import program, spans, trace
from helpers import (SMALL, TINY_MIX, add_cell, add_config, add_traffic,
                     bench_root)

SEED = 3_000_000_019


def _events(with_spans: bool) -> list:
    """Two calls; in the first, fhe.mul_relin holds fhe.digits, which
    holds fhe.ct_fwd_digits.  A kernel launched by the runtime inside
    aten::cat in fhe.digits, one by the driver inside fhe.ct_fwd_digits,
    one with no launch event; a copy in the second call."""
    ev = [
        {"cat": "user_annotation", "name": trace.CALL, "ts": 0, "dur": 50},
        {"cat": "user_annotation", "name": trace.CALL, "ts": 50, "dur": 50},
        {"cat": "user_annotation", "name": trace.ENQUEUE, "ts": 0.5,
         "dur": 29.5},
        {"cat": "cpu_op", "name": "aten::cat", "ts": 2, "dur": 2,
         "args": {"External id": 7}},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 3, "dur": 1,
         "args": {"correlation": 99, "External id": 7}},
        {"cat": "cuda_driver", "name": "cuLaunchKernel", "ts": 12, "dur": 1,
         "args": {"correlation": 100}},
        {"cat": "kernel", "name": "void cat_kernel(int)", "ts": 10, "dur": 10,
         "args": {"correlation": 99}},
        {"cat": "kernel", "name": "void ct_mma_kernel<true>(int)", "ts": 20,
         "dur": 5, "args": {"correlation": 100}},
        {"cat": "kernel", "name": "void lost(int)", "ts": 40, "dur": 2,
         "args": {"correlation": 101}},
        {"cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 60, "dur": 20},
    ]
    if with_spans:
        ev += [
            {"cat": "user_annotation", "name": "fhe.mul_relin", "ts": 1,
             "dur": 28},
            {"cat": "user_annotation", "name": "fhe.digits", "ts": 1.5,
             "dur": 20},
            {"cat": "user_annotation", "name": "fhe.ct_fwd_digits", "ts": 11,
             "dur": 10},
        ]
    return ev


def test_program_spans_leave_the_readers_inputs_alone():
    bare, spanned = trace.parse(_events(False)), trace.parse(_events(True))
    for field in ("calls", "window_us", "busy_us", "ops"):
        assert getattr(bare, field) == getattr(spanned, field), field
    assert sum(bare.gaps.values()) == sum(spanned.gaps.values())
    # the first gap's midpoint (t = 5) lies in fhe.digits, in no aten op
    assert bare.gaps[trace.ENQUEUE] == spanned.gaps["fhe.digits"] == 10


def test_attribute_takes_the_innermost_span():
    got = spans.attribute(_events(True))
    # per call (two calls): the cat kernel's launch (t = 3) lies in
    # fhe.digits, the driver's (t = 12) in fhe.ct_fwd_digits; the kernel
    # with no launch event and the copy in the second call in no span
    assert got["fhe.digits"]["device_us"] == 10 / 2
    assert got["fhe.ct_fwd_digits"]["device_us"] == 5 / 2
    assert got[spans.UNATTRIBUTED]["device_us"] == (2 + 20) / 2
    assert got[spans.UNATTRIBUTED]["launches"] == 2 / 2
    assert "device_us" not in got or got["fhe.mul_relin"]["device_us"] == 0
    # idle (0, 10): midpoint 5 in fhe.digits; (25, 40): 32.5 in no span;
    # (42, 60) and (80, 100): in no span
    assert got["fhe.digits"]["idle_us"] == 10 / 2
    assert got[spans.UNATTRIBUTED]["idle_us"] == (15 + 18 + 20) / 2
    assert got["fhe.mul_relin"]["instances"] == 1 / 2
    assert got["fhe.mul_relin"]["host_us"] == 28 / 2
    assert got["fhe.mul_relin"]["self_host_us"] == (28 - 20) / 2
    assert got["fhe.digits"]["self_host_us"] == (20 - 10) / 2
    assert spans.attribute(_events(False)) == {
        spans.UNATTRIBUTED: {"instances": 0, "host_us": 0, "self_host_us": 0,
                             "device_us": (10 + 5 + 2 + 20) / 2,
                             "launches": 4 / 2, "idle_us": (10 + 15 + 18 + 20)
                             / 2}}


def test_spans_that_start_together_nest():
    ev = _events(False) + [
        {"cat": "user_annotation", "name": "fhe.digits", "ts": 2, "dur": 20},
        {"cat": "user_annotation", "name": "fhe.mul_relin", "ts": 2,
         "dur": 27}]
    got = spans.attribute(ev)
    assert got["fhe.digits"]["device_us"] == (10 + 5) / 2
    assert got["fhe.mul_relin"]["self_host_us"] == 7 / 2


def test_host_split():
    tables = [{"fhe.mul_relin": [1, 900_000], "fhe.digits": [1, 300_000],
               "fhe.ct_fwd_digits": [1, 100_000], "fhe.ct_inv": [2, 150_000]},
              {"fhe.mul_relin": [1, 1_100_000], "fhe.digits": [1, 320_000],
               "fhe.ct_fwd_digits": [1, 110_000], "fhe.ct_inv": [2, 170_000]}]
    got = spans.host_split(tables)
    assert got["request_ms_median"] == 1.0
    assert abs(got["wrapper_host_ms"] - 0.265) < 1e-12
    assert abs(got["plain_host_ms"] - (1.0 - 0.265)) < 1e-12
    assert got["spans"]["fhe.ct_inv"] == {"per_call": 2, "ms": 0.16}
    assert spans.host_split([{}]) == {"spans": {}}


def test_small_cpu_run(tmp_path, monkeypatch):
    """The m = 256 cell on the CPU: each call's host time split by span
    from counting() tables (numbers), and a capture's spans, with no
    device operation to put down to any of them."""
    from fhe_si_tpu_torch import profiling
    root, data = bench_root(tmp_path)
    add_config(data, "ring256", SMALL)
    add_traffic(data, "b4", TINY_MIX)
    add_cell(root, "ring256.b4", "ring256", "b4", like="ct8192_q80.b64")
    c = cells.load("ring256.b4", root=root, data=data)
    prog = program.setup(c.config, c.traffic, SEED, "cpu")
    entries = len(prog.a)
    tables = []
    for k in range(3):
        with profiling.counting() as table:
            prog.mul_relin(k % entries)
        tables.append(table)
    split = spans.host_split(tables)
    assert split["spans"]["fhe.mul_relin"]["per_call"] == 1
    assert split["spans"]["fhe.ct_inv"]["per_call"] == 2
    assert 0 < split["wrapper_host_ms"] < split["request_ms_median"] * 3
    assert split["plain_host_ms"] > 0

    def one(k):
        with torch.profiler.record_function(trace.CALL):
            with torch.profiler.record_function(trace.ENQUEUE):
                prog.mul_relin(k % entries)
    monkeypatch.setattr(trace, "parse", lambda events: events)
    got = spans.attribute(trace.capture(one, 3))
    assert got["fhe.mul_relin"]["instances"] == 1
    assert got["fhe.digits"]["instances"] == 1
    assert not any(row["device_us"] for row in got.values())
