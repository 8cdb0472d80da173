"""The harness is driven by data: a cell from an existing configuration
and mix needs only its BENCHMARK.json entry, a new configuration, mix or
per-layer metric only a new file (and its entry).  A run on the CPU at a
small size goes through set-up, window, trace and check; with the timed
path broken underneath, `correct` comes out false; without a card the
command exits non-zero and prints no result."""
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from bench_port import cell as cells
from bench_port import check, program, run
from helpers import (REPO, SMALL, TINY_MIX, add_cell, add_config, add_traffic,
                     bench_root)

SEED = 3_000_000_017


def test_repo_cells_resolve():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        c = cells.load(w["name"])
        assert c.config["name"] == w["config"]
        assert {"setup_s"} < {m["name"] for m in c.end_to_end}
        assert c.per_layer
        for m in c.per_layer:
            assert callable(c.reader(m["name"]))


def test_new_cell_needs_only_an_entry(tmp_path):
    root, data = bench_root(tmp_path)
    add_cell(root, "dense4006_q170.b512", "dense4006_q170", "b512")
    c = cells.load("dense4006_q170.b512", root=root, data=data)
    assert c.config["context"]["m"] == 4006
    assert c.traffic["pairs_per_call"] == 512
    assert "mults_per_s" in {m["name"] for m in c.end_to_end}


@pytest.fixture(params=["ct8192_q80.b512", "ct8192_q80.b64"],
                ids=["like_b512", "like_b64"])
def small_cell(tmp_path, request):
    """A new configuration (m = 256), a new mix and a new per-layer metric,
    each one new file, and their entries; the cell reports what a cell of
    the benchmark reports (the device-paced b512's metrics, or the
    host-paced b64's)."""
    root, data = bench_root(tmp_path)
    add_config(data, "ring256", SMALL)
    add_traffic(data, "b4", TINY_MIX)
    (data / "metrics" / "traced_calls.py").write_text(
        "def read(r):\n    return float(r.trace.calls)\n")
    add_cell(root, "ring256.b4", "ring256", "b4", like=request.param)
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["per_layer"].append({"name": "traced_calls", "unit": "count",
                           "better": "higher", "source": "device_trace",
                           "layer": "device",
                           "moves": [m["name"] for m in b["end_to_end"]
                                     if "ring256.b4" in m.get("workloads", ())][0],
                           "workloads": ["ring256.b4"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    return cells.load("ring256.b4", root=root, data=data)


@pytest.mark.parametrize("traced", [False, True])
def test_small_run(small_cell, traced):
    res = run.run_cell(small_cell, SEED, 0.3, traced, "cpu",
                       time.perf_counter())
    assert res["check"]["mismatched_limbs"] == 0
    assert res["check"]["judged_outputs"] == 4
    assert res["attempted"] % TINY_MIX["pairs_per_call"] == 0
    if traced:
        assert res["metrics"]["traced_calls"]["value"] >= run.TRACE_CALLS[0]
        assert {m["name"] for m in small_cell.per_layer
                if m["name"].startswith("enqueue_ms")} <= set(res["metrics"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(res["metrics"]) == {m["name"] for m in small_cell.end_to_end}
        assert len(res["metrics"]) == 2


def _unchanged(self, k):
    return self.a[k]


def _half_batch(self, k):
    out = self.dev.mul_relin(self.a[k], self.b[k], self.matrix)
    half = out.shape[0] // 2
    return torch.cat([out[:half], self.a[k][half:]])


def _answer_altered(self, k):
    out = self.dev.mul_relin(self.a[k], self.b[k], self.matrix).clone()
    out[:, 1, 7, 0] ^= 1
    return out


def _last_call_altered(self, k):
    """Right in the warm-up (4 calls) and the window's first round on the
    pool (2), altered after."""
    self.calls = getattr(self, "calls", 0) + 1
    if self.calls <= 6:
        return self.dev.mul_relin(self.a[k], self.b[k], self.matrix)
    return _answer_altered(self, k)


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _answer_altered,
                                   _last_call_altered],
                         ids=lambda f: f.__name__.strip("_"))
def test_broken_timed_path_is_not_correct(small_cell, monkeypatch, fault):
    monkeypatch.setattr(program.Program, "mul_relin", fault)
    res = run.run_cell(small_cell, SEED, 1.0, False, "cpu",
                       time.perf_counter())
    assert res["attempted"] > 2 * TINY_MIX["pool"] * TINY_MIX["pairs_per_call"]
    assert res["check"]["mismatched_limbs"] > check.LIMIT


def test_no_card_exits_nonzero_without_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "bench_port/run.py", "--workload",
                        "ct8192_q80.b64", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA card" in p.stderr


def test_card_run(card, small_cell):
    """On a card: the same small cell through the kernels, traced."""
    res = run.run_cell(small_cell, SEED, 1.0, True, card, time.perf_counter())
    assert res["check"]["mismatched_limbs"] == 0
    for name in ("ntt_roofline", "crt_roofline", "modular_roofline",
                 "device_idle_pct.tput", "launches_per_step.tput"):
        assert name in res["metrics"], name
    assert 0 < res["trace"]["busy_s"] <= res["trace"]["window_s"]


def test_kernel_short_names():
    from bench_port.trace import short_name
    assert short_name("void (anonymous namespace)::ct_mma_kernel<false>(int "
                      "const*, int*)") == "ct_mma_kernel<false>"
    assert short_name("void at::native::(anonymous namespace)::cat_kernel<"
                      "int>(int*)") == "at::native::cat_kernel<int>"
    assert short_name("Memcpy DtoH (Device -> Pageable)") == "Memcpy DtoH "


def test_trace_parse():
    """Two calls; three kernels (two overlapping), one launched by aten::mm;
    the idle gaps named by the innermost host event over them."""
    from bench_port import trace as t
    ev = [
        {"cat": "user_annotation", "name": t.CALL, "ts": 0, "dur": 50},
        {"cat": "user_annotation", "name": t.CALL, "ts": 50, "dur": 50},
        {"cat": "user_annotation", "name": t.ENQUEUE, "ts": 0, "dur": 30},
        {"cat": "cpu_op", "name": "aten::mm", "ts": 1, "dur": 4,
         "args": {"External id": 7}},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 2, "dur": 2,
         "args": {"correlation": 99, "External id": 7}},
        {"cat": "kernel", "name": "void gemm(int)", "ts": 10, "dur": 10,
         "args": {"correlation": 99}},
        {"cat": "kernel", "name": "void (anonymous namespace)::crt_kernel<2>"
         "(int)", "ts": 15, "dur": 10, "args": {}},
        {"cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 60, "dur": 20},
    ]
    tr = t.parse(ev)
    assert (tr.calls, tr.window_us, tr.busy_us) == (2, 100, 35)
    assert [o.op for o in tr.ops] == ["aten::mm", "void (anonymous namespace)"
                                      "::crt_kernel<2>(int)", "Memcpy HtoD"]
    # gaps (0, 10), (25, 60), (80, 100): midpoints inside aten::mm, after
    # the enqueue span in the first call, and in the second call
    assert tr.gaps == {"aten::mm": 10, t.CALL: 35 + 20}
    b = t.breakdown(tr)
    assert b["device_ops"][0] == ["Memcpy HtoD", 20e-6]
    assert b["idle_gaps"][0] == [t.CALL, 55e-6]
