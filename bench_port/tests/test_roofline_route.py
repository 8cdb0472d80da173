"""roofline_route.py, the matmul route's yardstick, and the two readers
of the route (metrics/route_roofline.py, metrics/route_glue_ms.py) on
synthetic traces."""
import pytest

from bench_port import cell as cells
from bench_port import roofline, roofline_route as rr, trace
from bench_port.run import Readings

# the cell route8146_q188.b64: batch 64, phim 4072, 23 / 13 primes,
# 8 digits, N = 4073 x 1
STEP = roofline.Step(batch=64, phim=4072, L=23, Lk=13, n=27, nk=16, n_ct=12,
                     ndigits=8, split=(4073, 4073, 1))


def test_route_ms_at_the_cell():
    # forward 2.92, inverse 2.19 and 0.82, digits 9.89 ms, each set by
    # operations: 2 rows L N (N1 + N2) over 67 TFLOP/s
    parts = [rr.route_bound(n, rows, L, 4072, 4073, 4073, 1)
             for n, rows, L in (("ct_fwd", 256, 23), ("ct_inv", 192, 23),
                                ("ct_inv", 128, 13),
                                ("ct_fwd_digits", 1536, 13))]
    assert [round(ms, 2) for ms, _ in parts] == [2.92, 2.19, 0.82, 9.89]
    assert {by for _, by in parts} == {"operations"}
    assert rr.route_ms(STEP) == pytest.approx(15.82, abs=0.005)
    assert rr.route_ms(STEP) == pytest.approx(sum(ms for ms, _ in parts))


def test_small_split_by_hand():
    # m = 22 as 11 x 1, phim 10, 2 rows, 1 prime: 2 * 2 * 11 * 12 = 528
    # operations; 8 * (121 + 1) = 976 table bytes and 4 * (20 + 20) = 160
    # input and output bytes
    ms, by = rr.route_bound("ct_fwd", 2, 1, 10, 11, 11, 1)
    assert by == "bytes"
    assert ms == pytest.approx(1136 / roofline.HBM_BYTES_PER_S * 1e3)
    # the digit transform reads its input once for every prime: 4 primes,
    # 8 * 4 * 122 + 4 * (20 + 80) bytes
    ms, by = rr.route_bound("ct_fwd_digits", 2, 4, 10, 11, 11, 1)
    assert ms == pytest.approx((3904 + 400) / roofline.HBM_BYTES_PER_S * 1e3)
    # a 10 x 8 split: 2 * 2 * 1 * 80 * 18 operations
    assert rr.route_bound("ct_inv", 2, 1, 64, 80, 10, 8)[0] == pytest.approx(
        (8 * (100 + 64) + 4 * (128 + 128)) / roofline.HBM_BYTES_PER_S * 1e3)


@pytest.mark.parametrize("rows,by", [(1, "bytes"), (64, "bytes"),
                                     (256, "operations")])
def test_bytes_or_operations(rows, by):
    """The longer of the two times sets the bound: up to about 80 rows
    the N x N float64 tables' 3.05 GB, past that their products (the
    cell's forward transform has 256 rows)."""
    ms, got = rr.route_bound("ct_fwd", rows, 23, 4072, 4073, 4073, 1)
    nbytes = 8 * 23 * (4073 ** 2 + 1) + 4 * 2 * rows * 23 * 4072
    ops = 2 * rows * 23 * 4073 * 4074
    assert got == by
    assert ms == pytest.approx(max(nbytes / roofline.HBM_BYTES_PER_S,
                                   ops / roofline.F64_OPS_PER_S) * 1e3)


def _op(name, op, ts, dur):
    return trace.DeviceOp(name, op, ts, dur)


GEMM = _op("sm90_xmma_gemm_f64f64_f64f64_f64_nn", "aten::bmm", 0, 4000)
CAST = _op("elementwise_kernel<copy>", "aten::copy_", 4000, 500)
REM = _op("elementwise_kernel<remainder>", "aten::remainder", 4500, 300)
KERNELS = [_op(f"void {k}<2>(int const*)", f"void {k}<2>(int const*)",
               5000 + 10 * i, 10)
           for i, k in enumerate(("ct_mma_kernel", "crt_pass_kernel",
                                  "crt_kernel", "lift_kernel",
                                  "tensor_product_kernel",
                                  "keyswitch_dot_kernel",
                                  "byte_decomp_kernel"))]
MM = _op("sm90_xmma_gemm_f64f64", "aten::mm", 6000, 2000)


def _read(metric, ops, calls=2, step=STEP):
    c = cells.load("route8146_q188.b64")
    tr = trace.Trace(calls=calls, window_us=20000.0, busy_us=8000.0, ops=ops)
    return c.reader(metric)(Readings(c, step, tr, [0.001]))


@pytest.mark.parametrize("metric", ["route_roofline", "route_glue_ms"])
def test_readers_none_without_a_gemm(metric):
    assert _read(metric, [CAST, REM] + KERNELS) is None
    assert _read(metric, []) is None
    assert _read(metric, [GEMM, CAST], calls=0) is None


def test_route_roofline_reads_the_gemms_only():
    got = _read("route_roofline", [GEMM, CAST, REM, MM] + KERNELS)
    # 6,000 us of GEMMs over 2 calls: 3 ms a call
    assert got == pytest.approx(100 * rr.route_ms(STEP) / 3.0)
    assert _read("route_roofline", [GEMM, MM]) == got
    dense = roofline.Step(**dict(STEP.__dict__, split=None))
    assert _read("route_roofline", [GEMM], step=dense) is None


def test_route_glue_ms_leaves_out_gemms_and_kernels():
    got = _read("route_glue_ms", [GEMM, CAST, REM, MM] + KERNELS)
    assert got == pytest.approx((500 + 300) / 2 / 1e3)
    assert _read("route_glue_ms", [GEMM, MM] + KERNELS) == 0.0
    # a kernel whose name only contains a hand-written kernel's is glue
    other = _op("void my_lift_kernel_v2(int)", "aten::add", 0, 100)
    assert _read("route_glue_ms", [GEMM, other]) == pytest.approx(0.05)
