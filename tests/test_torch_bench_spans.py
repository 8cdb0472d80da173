"""The benchmark's readers of the program's span tags (bench_port/by_span.py
and the metrics that use it) on synthetic Chrome traces passed through
bench_port.trace.parse: each reading against one worked out by hand, None
where the spans are user_annotation events (a program whose spans the
parser does not link to launches) and on shapes a reader does not cover,
the three transform readings recombined into ntt_roofline's, the first
call left out of the call-start idle, and plain_ms leaving out GEMMs and
tagged operations."""
from types import SimpleNamespace

import pytest

from bench_port import by_span, readers, trace
from bench_port import cell as cells
from bench_port.roofline import Step

# ct8192_q80 at 64 pairs: phim 4096, 12 primes (8 keyswitch), 4 digits
CT_STEP = Step(batch=64, phim=4096, L=12, Lk=8, n=11, nk=8, n_ct=6,
               ndigits=4, split=(4096, 64, 64))
DENSE_STEP = Step(batch=64, phim=2002, L=21, Lk=12, n=22, nk=13, n_ct=11,
                  ndigits=8, split=None)

# one call's device operations in launch order: (span or aten op that
# launched it, kernel, start after the call's start (us), duration (us))
CT_CALL = [("fhe.limbs_to_residues", "lift_kernel<3>", 100, 20),
           ("fhe.ct_fwd", "ct_mma_kernel<false, 8, true, 0>", 130, 40),
           ("fhe.tensor_product", "tensor_product_kernel", 180, 10),
           ("fhe.ct_inv", "ct_mma_kernel<false, 8, true, 0>", 200, 30),
           ("fhe.crt_to_limbs", "crt_pass_kernel<9>", 240, 10),
           ("fhe.byte_decomp", "byte_decomp_kernel<3, false>", 260, 5),
           ("fhe.ct_fwd_digits", "ct_mma_kernel<true, 8, true, 0>", 270, 60),
           ("aten::index_select", "indexSelectSmallIndex<int, long>", 340, 4),
           ("fhe.keyswitch_dot", "keyswitch_dot_kernel", 350, 16),
           ("fhe.ct_inv", "ct_mma_kernel<false, 8, true, 0>", 370, 20),
           ("fhe.crt_to_limbs", "crt_pass_kernel<7>", 400, 8)]
# the dense family: the transform's GEMMs and float64 conversions under
# fhe.modmatmul, the shared kernels under their wrappers
DENSE_CALL = [("fhe.limbs_to_residues", "lift_kernel<6>", 100, 20),
              ("aten::copy_", "direct_copy_kernel", 125, 7),
              ("aten::mm", "sm90_xmma_gemm_f64f64", 135, 90),
              ("aten::remainder", "elementwise_kernel", 230, 6),
              ("fhe.tensor_product", "tensor_product_kernel", 240, 10),
              ("aten::index_select", "indexSelectSmallIndex<int, long>", 255,
               3),
              ("fhe.keyswitch_dot", "keyswitch_dot_kernel", 260, 12)]
CALL_STARTS = (0, 1000, 2500)
CALL_US = 500


def _events(call_ops, starts=CALL_STARTS, span_cat="cpu_op", ext=0):
    """Chrome events of calls at `starts`: the harness's bench.call, each
    operation's launching span (cat span_cat) or aten op (cpu_op) with an
    External id (from ext + 1 on), its cudaLaunchKernel (correlation and
    External id) and its kernel (correlation)."""
    ev = []
    for t in starts:
        ev.append({"cat": "user_annotation", "name": trace.CALL, "ts": t,
                   "dur": CALL_US, "args": {"External id": 0}})
        for i, (op, kernel, at, dur) in enumerate(call_ops):
            ext += 1
            cat = span_cat if op.startswith("fhe.") else "cpu_op"
            host = t + i                   # the host runs ahead of the card
            ev.append({"cat": cat, "name": op, "ts": host, "dur": 0.8,
                       "args": {"External id": ext}})
            ev.append({"cat": "cuda_runtime", "name": "cudaLaunchKernel",
                       "ts": host + 0.1, "dur": 0.5,
                       "args": {"correlation": ext, "External id": ext}})
            ev.append({"cat": "kernel", "name": kernel, "ts": t + at,
                       "dur": dur, "args": {"correlation": ext}})
    return ev


def _readings(call_ops, step, **kw):
    return SimpleNamespace(step=step, trace=trace.parse(_events(call_ops, **kw)),
                           enqueue_s=[])


def _read(metric, r, cell="ct8192_q80.b512"):
    """The metric's reader as the harness loads it for `cell`."""
    return cells.load(cell).reader(metric)(r)


NEW = ("keyswitch_roofline", "ntt_fwd_roofline", "ntt_digits_roofline",
       "ntt_inv_roofline", "call_start_idle_ms.tput", "plain_ms.tput")


def test_parse_tags_each_kernel_with_its_span():
    """A cpu_op span is its kernels' op; an aten op keeps its own."""
    r = _readings(CT_CALL, CT_STEP)
    assert r.trace.calls == 3
    assert [o.op for o in r.trace.ops[:len(CT_CALL)]] == [
        op for op, *_ in CT_CALL]


@pytest.mark.parametrize("metric, want", [
    pytest.param("keyswitch_roofline",
                 lambda s: 100 * by_span.keyswitch_ms(s) * 1e3 / 16, id="ksw"),
    pytest.param("ntt_fwd_roofline",
                 lambda s: 100 * by_span.ntt_ms(s)["fhe.ct_fwd"] * 1e3 / 40,
                 id="fwd"),
    pytest.param("ntt_digits_roofline",
                 lambda s: 100 * by_span.ntt_ms(s)["fhe.ct_fwd_digits"] * 1e3
                 / 60, id="digits"),
    pytest.param("ntt_inv_roofline",
                 lambda s: 100 * by_span.ntt_ms(s)["fhe.ct_inv"] * 1e3
                 / (30 + 20), id="inv"),
    pytest.param("call_start_idle_ms.tput",
                 lambda s: ((1100 - 408) + (2600 - 1408)) / 2 / 1e3,
                 id="call-start"),
    pytest.param("plain_ms.tput", lambda s: 4 / 1e3, id="plain")])
def test_reader_by_hand(metric, want):
    """Each reader on three calls of the m = 8192 step: the bound over the
    tagged device us a call; the idle before the second and third calls'
    lifts (the latest operation before each ended at 408 us into the call
    before); the gather's 4 us a call as plain."""
    r = _readings(CT_CALL, CT_STEP)
    assert _read(metric, r) == pytest.approx(want(CT_STEP), rel=1e-12)


def test_bounds_are_the_steps():
    """The keyswitch bound is modular_ms less the tensor product's; the
    three transform groups sum to ntt_ms."""
    from bench_port.roofline import modular_bound
    tp = modular_bound("tensor_product", CT_STEP.batch, CT_STEP.L,
                       CT_STEP.phim)[0]
    assert by_span.keyswitch_ms(CT_STEP) + tp == pytest.approx(
        CT_STEP.modular_ms(), rel=1e-12)
    assert sum(by_span.ntt_ms(CT_STEP).values()) == pytest.approx(
        CT_STEP.ntt_ms(), rel=1e-12)


@pytest.mark.parametrize("metric", NEW + ("call_start_idle_ms.host",))
def test_none_where_spans_are_user_annotations(metric):
    """Spans as user_annotation events (record_function's form) tag no
    operation: every span reader reads None, while the kernel-name
    readers still read."""
    r = _readings(CT_CALL, CT_STEP, span_cat="user_annotation")
    assert {o.op for o in r.trace.ops} >= {"lift_kernel<3>",
                                           "keyswitch_dot_kernel"}
    cell = "ct8192_q80.b64" if metric.endswith(".host") else "ct8192_q80.b512"
    assert _read(metric, r, cell) is None
    assert _read("ntt_roofline", r) is not None


@pytest.mark.parametrize("metric", ["ntt_fwd_roofline", "ntt_digits_roofline",
                                    "ntt_inv_roofline"])
def test_ntt_readers_none_on_dense_step(metric):
    """A dense step has no split and no fhe.ct_* tag: None, where the
    keyswitch, call-start and plain readers read."""
    r = _readings(DENSE_CALL, DENSE_STEP)
    assert _read(metric, r) is None
    for other in ("keyswitch_roofline", "call_start_idle_ms.tput",
                  "plain_ms.tput"):
        assert _read(other, r, "dense4006_q170.b64") is not None


def test_ntt_readers_none_on_the_route():
    """The matmul route's transforms run under fhe.route_*: a step with a
    split but no fhe.ct_* tag reads None."""
    route = [("fhe.route_enter" if op == "fhe.ct_fwd" else op, k, at, d)
             for op, k, at, d in CT_CALL if op not in ("fhe.ct_inv",
                                                       "fhe.ct_fwd_digits")]
    r = _readings(route, CT_STEP)
    for metric in ("ntt_fwd_roofline", "ntt_digits_roofline",
                   "ntt_inv_roofline"):
        assert _read(metric, r) is None


def test_transform_readings_recombine_to_ntt_roofline():
    """Sum of bounds over the sum of bound_i / reading_i is ntt_roofline's
    reading of the same trace (every ct_mma_kernel carries a fhe.ct_* tag)."""
    r = _readings(CT_CALL, CT_STEP)
    bounds = by_span.ntt_ms(CT_STEP)
    got = {span: _read(metric, r) for span, metric in (
        ("fhe.ct_fwd", "ntt_fwd_roofline"),
        ("fhe.ct_fwd_digits", "ntt_digits_roofline"),
        ("fhe.ct_inv", "ntt_inv_roofline"))}
    whole = sum(bounds.values()) / sum(bounds[s] / got[s] for s in bounds)
    assert whole == pytest.approx(_read("ntt_roofline", r), rel=1e-12)


def test_call_start_idle_skips_the_first_call():
    """The first call's lift is left out, however long the host took to
    reach it from the window's start; with one call there is nothing to
    read; an operation that outlasts the next call's host path leaves no
    idle before its lift."""
    late = [(op, k, at + 300, d) for op, k, at, d in CT_CALL]
    ev = _events(late, starts=(0,)) + _events(CT_CALL, starts=(1000, 2500),
                                              ext=100)
    r = SimpleNamespace(step=CT_STEP, trace=trace.parse(ev), enqueue_s=[])
    want = ((1100 - 708) + (2600 - 1408)) / 2 / 1e3
    assert by_span.call_start_idle_ms(r) == pytest.approx(want, rel=1e-12)
    assert by_span.call_start_idle_ms(
        _readings(CT_CALL, CT_STEP, starts=(0,))) is None
    long_tail = CT_CALL[:-1] + [("fhe.crt_to_limbs", "crt_pass_kernel<7>",
                                 400, 1200)]
    r = _readings(long_tail, CT_STEP, starts=(0, 1000))
    assert by_span.call_start_idle_ms(r) == 0.0


def test_call_start_idle_needs_one_lift_a_call():
    """A trace with two lifts a call does not say which starts the call:
    None."""
    twice = CT_CALL + [("fhe.limbs_to_residues", "lift_kernel<3>", 420, 5)]
    assert by_span.call_start_idle_ms(_readings(twice, CT_STEP)) is None


def test_call_start_idle_without_the_first_calls_lift():
    """Where the trace lacks the first call's lift (on the trace's clock
    it ended before the first call's start, so parse left it out), the
    later calls read as before: the first lift in the window has
    operations of the call before it."""
    ev = _events(CT_CALL[1:], starts=(0,)) + _events(
        CT_CALL, starts=CALL_STARTS[1:], ext=100)
    r = SimpleNamespace(step=CT_STEP, trace=trace.parse(ev), enqueue_s=[])
    assert r.trace.calls == 3
    want = ((1100 - 408) + (2600 - 1408)) / 2 / 1e3
    assert by_span.call_start_idle_ms(r) == pytest.approx(want, rel=1e-12)


def test_plain_ms_leaves_out_gemms_and_tagged_ops():
    """On the dense step: the conversion, the remainder and the gather,
    7 + 6 + 3 us a call; not the GEMM (aten::mm) nor any tagged kernel."""
    r = _readings(DENSE_CALL, DENSE_STEP)
    assert _read("plain_ms.tput", r, "dense4006_q170.b64") == pytest.approx(
        16 / 1e3, rel=1e-12)
    assert any(o.op in readers.DENSE_OPS for o in r.trace.ops)


def test_cells_report_the_new_metrics():
    """Each new metric is declared for the cells whose trace it reads."""
    tput = {"dense4006_q170.b64", "ct8192_q80.b512", "route8146_q188.b64",
            "mixed20480_q80.b64", "ct32768_q220w.b64"}
    kernel = {"ct8192_q80.b512", "mixed20480_q80.b64", "ct32768_q220w.b64"}
    want = {"keyswitch_roofline": tput, "ntt_fwd_roofline": kernel,
            "ntt_digits_roofline": kernel, "ntt_inv_roofline": kernel,
            "call_start_idle_ms.tput": tput,
            "call_start_idle_ms.host": {"ct8192_q80.b64"},
            "plain_ms.tput": tput}
    for name in sorted(tput | {"ct8192_q80.b64"}):
        c = cells.load(name)
        got = {m["name"] for m in c.per_layer} & set(want)
        assert got == {m for m, where in want.items() if name in where}, name
        for m in got:
            assert callable(c.reader(m))
