"""fhe_si_tpu_torch/profiling.py against fhe_si_tpu/profiling.py: the
same report for the same phase times, and a torch.profiler trace on the
CPU that holds the annotated region.  The spans (annotate): one shared
no-op with no sink, nested cpu_op events under the profiler,
counts and host time under counting(), and the fhe.* spans of
mul+relin on both transform families."""
import json
import time

import pytest
import torch

from fhe_si_tpu import profiling as jprofiling
from fhe_si_tpu_torch import DeviceContext, FheContext, profiling
from fhe_si_tpu_torch.ops import ntt_ct_matmul

STAGES = ("fhe.mul_relin", "fhe.tensor_mul", "fhe.scale_down", "fhe.digits",
          "fhe.keyswitch")


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


def _events(tmp_path):
    """The Chrome trace device_trace wrote into tmp_path."""
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    return json.loads(files[0].read_text())["traceEvents"]


def _raise(*args, **kwargs):
    raise AssertionError("a record function made with no sink active")


def _no_record_function(mp):
    """Make the span under a capture raise: the fast record function, as
    torch has it and as profiling bound it."""
    mp.setattr(torch._C._profiler, "_RecordFunctionFast", _raise)
    mp.setattr(profiling, "_record", _raise)


def test_annotate_off_is_one_shared_noop(monkeypatch):
    """With no profiler recording and no counting() table, every span is
    the same module-level no-op: no record function is ever made."""
    _no_record_function(monkeypatch)
    spans = {id(profiling.annotate(name)) for name in STAGES}
    assert spans == {id(profiling._OFF)}
    with profiling.annotate("fhe.outer"):
        with profiling.annotate("fhe.inner"):
            pass


def test_counting_counts_and_times_nested_spans(monkeypatch):
    """Each span adds one and its elapsed perf_counter_ns under its name,
    nested spans each under their own; the table closes with the block,
    and an inner counting() block keeps its own table."""
    now = [0]

    def tick():
        return now[0]

    monkeypatch.setattr(time, "perf_counter_ns", tick)
    with profiling.counting() as table:
        for _ in range(2):
            with profiling.annotate("fhe.outer"):
                now[0] += 5
                with profiling.annotate("fhe.inner"):
                    now[0] += 7
                with profiling.annotate("fhe.inner"):
                    now[0] += 11
                with profiling.counting() as inner_table:
                    with profiling.annotate("fhe.inner"):
                        now[0] += 100
        assert inner_table == {"fhe.inner": [1, 100]}
    assert table == {"fhe.outer": [2, 2 * (5 + 7 + 11 + 100)],
                     "fhe.inner": [4, 2 * (7 + 11)]}
    assert profiling.annotate("fhe.after") is profiling._OFF


def _step(m, log_q, p, generator, use_ct=None):
    """A DeviceContext on the CPU and one batched mul_relin's operands
    (limbs and a key matrix of the right shapes; the spans do not read
    the values); use_ct=True forces the Cooley-Tukey family."""
    ctx = FheContext(m=m, log_q=log_q, p=p, generator=generator)
    if use_ct is not None:
        ctx.use_ct = use_ct
    dev = DeviceContext(ctx, "cpu")
    gen = torch.Generator().manual_seed(m)
    a, b = (torch.randint(0, 1 << 16, (2, 2, ctx.phim, ctx.n_limbs_ct),
                          generator=gen, dtype=torch.int32)
            for _ in range(2))
    mat = torch.randint(0, 2, (2, 3 * ctx.ndigits, ctx.num_primes, ctx.phim),
                        generator=gen, dtype=torch.int32)
    return dev, a, b, mat


# the wrapper spans of one mul_relin on each family
CT_WRAPPERS = {"fhe.limbs_to_residues": 1, "fhe.ct_fwd": 1,
               "fhe.tensor_product": 1, "fhe.ct_inv": 2, "fhe.crt_to_limbs": 2,
               "fhe.byte_decomp": 1, "fhe.ct_fwd_digits": 1,
               "fhe.keyswitch_dot": 1}
DENSE_WRAPPERS = {"fhe.limbs_to_residues": 1, "fhe.modmatmul": 4,
                  "fhe.tensor_product": 1, "fhe.crt_to_limbs": 2,
                  "fhe.byte_decomp": 1, "fhe.keyswitch_dot": 1}


@pytest.mark.parametrize("ring, wrappers", [
    pytest.param((256, 80, 257, 3), CT_WRAPPERS, id="m256-ct"),
    pytest.param((22, 80, 23, 7), DENSE_WRAPPERS, id="m22-dense")])
def test_mul_relin_spans(ring, wrappers):
    """One CPU mul_relin under counting(): the request and each stage
    once, the wrappers of the path it takes (15 spans on either family),
    each stage inside the request's time; the result is unchanged."""
    dev, a, b, mat = _step(*ring)
    plain = dev.mul_relin(a, b, mat)
    with profiling.counting() as table:
        out = dev.mul_relin(a, b, mat)
    assert torch.equal(out, plain)
    counts = {name: n for name, (n, _) in table.items()}
    assert counts == dict(dict.fromkeys(STAGES, 1), **wrappers)
    assert sum(counts.values()) == 15
    ns = {name: t for name, (_, t) in table.items()}
    assert sum(ns[s] for s in STAGES[1:]) <= ns["fhe.mul_relin"]
    assert ns["fhe.ct_fwd_digits" if "fhe.ct_fwd" in wrappers
              else "fhe.modmatmul"] > 0


def test_mul_relin_spans_nest_in_device_trace(tmp_path):
    """The m = 256 step's spans in a Chrome trace: each stage inside the
    request, each wrapper inside the stage that calls it."""
    dev, a, b, mat = _step(256, 80, 257, 3)
    with profiling.device_trace(str(tmp_path)):
        dev.mul_relin(a, b, mat)
    spans = [e for e in _events(tmp_path) if e.get("cat") == "cpu_op"
             and e["name"].startswith("fhe.")]
    assert len(spans) == 15

    def parent(e):
        around = [o for o in spans if o is not e and o["ts"] <= e["ts"]
                  and e["ts"] + e["dur"] <= o["ts"] + o["dur"]]
        return min(around, key=lambda o: o["dur"])["name"] if around else None

    assert profiling.annotate("fhe.after") is profiling._OFF
    got = sorted((e["name"], parent(e)) for e in spans)
    want = sorted([("fhe.mul_relin", None)]
                  + [(s, "fhe.mul_relin") for s in STAGES[1:]]
                  + [("fhe.limbs_to_residues", "fhe.tensor_mul"),
                     ("fhe.ct_fwd", "fhe.tensor_mul"),
                     ("fhe.tensor_product", "fhe.tensor_mul"),
                     ("fhe.ct_inv", "fhe.scale_down"),
                     ("fhe.crt_to_limbs", "fhe.scale_down"),
                     ("fhe.byte_decomp", "fhe.digits"),
                     ("fhe.ct_fwd_digits", "fhe.digits"),
                     ("fhe.keyswitch_dot", "fhe.keyswitch"),
                     ("fhe.ct_inv", "fhe.keyswitch"),
                     ("fhe.crt_to_limbs", "fhe.keyswitch")])
    assert got == want


# the spans of one mul_relin on the matmul route's folded form (11 x 1):
# its four transforms (1 forward, 2 inverse, 1 of the digits), each an
# enter (fhe.route_enter), one GEMM (no span of its own) and a leave
# (fhe.route_leave)
ROUTE_WRAPPERS = {"fhe.limbs_to_residues": 1, "fhe.route_fwd": 1,
                  "fhe.tensor_product": 1, "fhe.route_inv": 2,
                  "fhe.crt_to_limbs": 2, "fhe.byte_decomp": 1,
                  "fhe.route_fwd_digits": 1, "fhe.keyswitch_dot": 1,
                  "fhe.route_enter": 4, "fhe.route_leave": 4}
M22_ROUTE = (22, 80, 23, 7, True)       # use_ct forced: 11 x 1
# m = 22 has an odd part (phim 10, N 11), so the plain enter and leave of
# the CPU run each phim <-> N step of ops/ntt_ct.py under its own span:
# the forward and digit enters pad and their leaves drop, the two
# inverses' enters insert and their leaves fold
ROUTE_PHIM_STEPS = {"fhe.pad_to_N": 2, "fhe.drop_excluded": 2,
                    "fhe.insert_excluded": 2, "fhe.fold_mod_phim": 2}
# the transform spans of one route step, one entry per call
ROUTE_TRANSFORMS = ("fhe.route_fwd", "fhe.route_inv", "fhe.route_fwd_digits",
                    "fhe.route_inv")


def test_mul_relin_route_spans(monkeypatch):
    """m = 22 on the matmul route (use_ct forced, as
    tests/test_torch_ct_matmul.py does): with no sink no record function
    is made and the call counts its transforms and stage products; under
    counting() each route span is counted as the code calls it, none of
    the kernel wrappers' fhe.ct_*, and the result is the untraced one."""
    dev, a, b, mat = _step(*M22_ROUTE)
    assert dev.ct_route == "matmul"
    ntt_ct_matmul.reset_calls()
    ntt_ct_matmul.reset_products()
    with monkeypatch.context() as mp:
        _no_record_function(mp)
        plain = dev.mul_relin(a, b, mat)
    assert ntt_ct_matmul.CALLS == {"ct_fwd": 1, "ct_fwd_digits": 1,
                                   "ct_inv": 2}
    assert ntt_ct_matmul.PRODUCTS == {"ct_fwd": 1, "ct_fwd_digits": 1,
                                      "ct_inv": 2}
    with profiling.counting() as table:
        out = dev.mul_relin(a, b, mat)
    assert torch.equal(out, plain)
    counts = {name: n for name, (n, _) in table.items()}
    assert counts == dict(dict.fromkeys(STAGES, 1), **ROUTE_WRAPPERS,
                          **ROUTE_PHIM_STEPS)
    assert ntt_ct_matmul.PRODUCTS == {"ct_fwd": 2, "ct_fwd_digits": 2,
                                      "ct_inv": 4}
    ns = {name: t for name, (_, t) in table.items()}
    for route in ("fhe.route_fwd", "fhe.route_fwd_digits", "fhe.route_inv"):
        assert 0 < ns[route] <= ns["fhe.mul_relin"]
    ntt_ct_matmul.reset_products()
    assert set(ntt_ct_matmul.PRODUCTS.values()) == {0}


def test_mul_relin_route_spans_nest_in_device_trace(tmp_path):
    """The route step's spans in a Chrome trace: each transform inside
    the stage that calls it, each enter and leave inside a transform."""
    dev, a, b, mat = _step(*M22_ROUTE)
    with profiling.device_trace(str(tmp_path)):
        dev.mul_relin(a, b, mat)
    spans = [e for e in _events(tmp_path) if e.get("cat") == "cpu_op"
             and e["name"].startswith("fhe.")]
    assert len(spans) == (5 + sum(ROUTE_WRAPPERS.values())
                          + sum(ROUTE_PHIM_STEPS.values()))

    def parent(e):
        around = [o for o in spans if o is not e and o["ts"] <= e["ts"]
                  and e["ts"] + e["dur"] <= o["ts"] + o["dur"]]
        return min(around, key=lambda o: o["dur"])["name"] if around else None

    got = sorted((e["name"], parent(e)) for e in spans)
    inner = [(s, t) for t in ROUTE_TRANSFORMS
             for s in ("fhe.route_enter", "fhe.route_leave")]
    inner += 2 * [("fhe.pad_to_N", "fhe.route_enter"),
                  ("fhe.drop_excluded", "fhe.route_leave"),
                  ("fhe.insert_excluded", "fhe.route_enter"),
                  ("fhe.fold_mod_phim", "fhe.route_leave")]
    want = sorted([("fhe.mul_relin", None)]
                  + [(s, "fhe.mul_relin") for s in STAGES[1:]]
                  + [("fhe.limbs_to_residues", "fhe.tensor_mul"),
                     ("fhe.route_fwd", "fhe.tensor_mul"),
                     ("fhe.tensor_product", "fhe.tensor_mul"),
                     ("fhe.route_inv", "fhe.scale_down"),
                     ("fhe.crt_to_limbs", "fhe.scale_down"),
                     ("fhe.byte_decomp", "fhe.digits"),
                     ("fhe.route_fwd_digits", "fhe.digits"),
                     ("fhe.keyswitch_dot", "fhe.keyswitch"),
                     ("fhe.route_inv", "fhe.keyswitch"),
                     ("fhe.crt_to_limbs", "fhe.keyswitch")] + inner)
    assert got == want


# the route's spans of one mul_relin on a split with two non-trivial
# stages (m = 256, 16 x 8, forced onto the route): each transform two
# stage products (fhe.modmatmul), one twiddle and two phim <-> N steps
TWO_STAGE_ROUTE = dict(ROUTE_WRAPPERS, **{
    "fhe.route_enter": 0, "fhe.route_leave": 0, "fhe.modmatmul": 8,
    "fhe.route_twiddle": 4, "fhe.route_reindex": 8})


def test_mul_relin_two_stage_route_spans(monkeypatch):
    """m = 256 on the matmul route (ntt_ct_cuda.kernel_takes refused, as
    tests/test_torch_ct_matmul.py forces it): no 1 x 1 stage to fold, so
    each transform runs two stage products, counted in PRODUCTS, under
    the route's fhe.modmatmul, fhe.route_twiddle and fhe.route_reindex
    spans, and no fhe.route_enter or fhe.route_leave."""
    from fhe_si_tpu_torch.ops import ntt_ct_cuda
    monkeypatch.setattr(ntt_ct_cuda, "kernel_takes", lambda meta: False)
    dev, a, b, mat = _step(256, 80, 257, 3)
    assert dev.ct_route == "matmul" and "tw_t2" not in dev.full["ct"]
    ntt_ct_matmul.reset_calls()
    ntt_ct_matmul.reset_products()
    with profiling.counting() as table:
        dev.mul_relin(a, b, mat)
    assert ntt_ct_matmul.CALLS == {"ct_fwd": 1, "ct_fwd_digits": 1,
                                   "ct_inv": 2}
    assert ntt_ct_matmul.PRODUCTS == {"ct_fwd": 2, "ct_fwd_digits": 2,
                                      "ct_inv": 4}
    counts = {name: n for name, (n, _) in table.items()}
    want = {k: n for k, n in TWO_STAGE_ROUTE.items() if n}
    assert counts == dict(dict.fromkeys(STAGES, 1), **want)
