"""fhe_si_tpu_torch/profiling.py against fhe_si_tpu/profiling.py: the
same report for the same phase times, and a torch.profiler trace on the
CPU that holds the annotated region."""
import json
import time

import pytest
import torch

from fhe_si_tpu import profiling as jprofiling
from fhe_si_tpu_torch import profiling


@pytest.fixture
def clock(monkeypatch):
    """time.perf_counter as a clock that moves only when the test moves
    it, for both modules (they read it through the time module)."""
    now = [100.0]

    def tick():
        return now[0]

    monkeypatch.setattr(time, "perf_counter", tick)
    return now


def _drive(prof, now):
    for name, secs in (("setup", 1.234), ("batch", 0.005),
                       ("encryption", 2.5), ("computation", 10.125),
                       ("decryption", 0.999), ("batch", 0.01)):
        with prof.phase(name):
            now[0] += secs
    now[0] += 0.5


def test_report_matches_jax(clock):
    """Same phases, same order, same text and dictionary."""
    jax_prof = jprofiling.PhaseProfiler()
    _drive(jax_prof, clock)
    clock[0] = 100.0
    port = profiling.PhaseProfiler("cpu")
    _drive(port, clock)
    assert port.REFERENCE_PHASES == jax_prof.REFERENCE_PHASES
    assert port.report() == jax_prof.report()
    assert port.as_dict() == jax_prof.as_dict()
    assert json.loads(port.as_json()) == json.loads(jax_prof.as_json())
    assert list(port.times) == ["setup", "batch", "encryption",
                                "computation", "decryption"]


def test_device_trace_holds_the_annotation(tmp_path):
    """device_trace on the CPU writes one Chrome trace; the annotate()
    region and the ops inside it are events of it."""
    x = torch.arange(4096, dtype=torch.int64)
    with profiling.device_trace(str(tmp_path)):
        with profiling.annotate("fsi_step"):
            (x * x % 40961).sum()
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())[
        "traceEvents"]}
    assert "fsi_step" in names
    assert any(n and n.startswith("aten::") for n in names)
