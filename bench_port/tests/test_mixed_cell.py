"""The cell mixed20480_q80.b64 as the repository's BENCHMARK.json gives
it: the mixed-radix ring m = 20480 = 2^12 * 5 at logQ 80 on the
tensor-core kernel and its phim <-> N steps, the metrics it reports, and
mixed_glue_ms on synthetic traces."""
import pytest

from bench_port import cell as cells
from bench_port import program, roofline, trace
from bench_port.run import Readings, step_shapes

CELL = "mixed20480_q80.b64"


def test_cell_reports_its_metrics():
    c = cells.load(CELL)
    assert c.chips == 1 and c.traffic["pairs_per_call"] == 64
    assert [m["name"] for m in c.end_to_end] == ["setup_s", "mults_per_s"]
    assert {m["name"] for m in c.per_layer} == {
        "device_idle_pct.tput", "launches_per_step.tput", "enqueue_ms.tput",
        "ntt_roofline", "crt_roofline", "modular_roofline", "mixed_glue_ms"}
    for m in c.per_layer:
        assert callable(c.reader(m["name"]))
        assert m["moves"] == "mults_per_s"


def test_config_shape():
    c = cells.load(CELL)
    assert c.config["context"] == {"m": 20480, "log_q": 80, "p": 40961,
                                   "generator": 3, "decomp_size": 3,
                                   "stdev": 3.2}
    assert c.config["reduced"] == []
    ctx = program.context(c.config)
    assert ctx.use_ct and not ctx.wide
    assert (ctx.phim, ctx.num_primes, len(ctx.ksw_rows), ctx.ndigits,
            ctx.n_limbs_ct) == (8192, 12, 8, 4, 6)
    assert step_shapes(ctx, 64).split == (10240, 128, 80)


STEP = roofline.Step(batch=64, phim=8192, L=12, Lk=8, n=14, nk=10, n_ct=6,
                     ndigits=4, split=(10240, 128, 80))


def _op(name, op, dur):
    return trace.DeviceOp(name, op, 0.0, dur)


PAD = _op("void at::native::vectorized_elementwise_kernel<fill>",
          "aten::constant_pad_nd", 300)
CAT = _op("void at::native::CatArrayBatchedCopy<int>", "aten::cat", 500)
WHERE = _op("void at::native::elementwise_kernel<where>", "aten::where", 200)
KERNELS = [_op(f"void {k}<true, 8, false>(int const*)",
               f"void {k}<true, 8, false>(int const*)", 1000)
           for k in ("ct_mma_kernel", "crt_pass_kernel", "crt_kernel",
                     "lift_kernel", "tensor_product_kernel",
                     "keyswitch_dot_kernel", "byte_decomp_kernel",
                     "route_enter_kernel", "route_leave_kernel")]
GATHER = _op("void at::native::indexSelectSmallIndex<int>",
             "aten::index_select", 400)
GEMM = _op("sm90_xmma_gemm_f64f64_f64f64_f64_nn", "aten::matmul", 4000)


def _read(ops, calls=2, step=STEP):
    c = cells.load(CELL)
    tr = trace.Trace(calls=calls, window_us=20000.0, busy_us=8000.0, ops=ops)
    return c.reader("mixed_glue_ms")(Readings(c, step, tr, [0.001]))


def test_mixed_glue_sums_the_plain_operations():
    # 1,000 us of plain operations over 2 calls: 0.5 ms a call
    assert _read([PAD, CAT, WHERE] + KERNELS + [GATHER]) == pytest.approx(
        0.5)
    assert _read([PAD, CAT, WHERE], calls=4) == pytest.approx(0.25)


def test_mixed_glue_leaves_out_kernels_and_the_gather():
    assert _read(KERNELS + [GATHER]) == 0.0
    # a kernel whose name only contains a hand-written kernel's is glue
    other = _op("void my_lift_kernel_v2(int)", "aten::add", 100)
    assert _read(KERNELS + [other]) == pytest.approx(0.05)


def test_mixed_glue_none_off_the_mixed_rings():
    ops = [PAD, CAT] + KERNELS
    pow2 = roofline.Step(**dict(STEP.__dict__, phim=8192,
                                split=(8192, 128, 64)))
    dense = roofline.Step(**dict(STEP.__dict__, split=None))
    assert _read(ops, step=pow2) is None
    assert _read(ops, step=dense) is None
    assert _read(ops + [GEMM]) is None
    assert _read(ops, calls=0) is None
