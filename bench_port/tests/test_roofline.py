"""The frozen yardstick reproduces chip_smoke.py's bounds at the main
shapes (m = 8192, batch 64), each set by bytes."""
import pytest

from bench_port import roofline as r
from bench_port.run import step_shapes

B, PHIM, N = 64, 4096, (4096, 64, 64)
MAIN_US = [
    (lambda: r.ntt_bound("ct_fwd", 4 * B, 12, PHIM, *N), 30.0),
    (lambda: r.ntt_bound("ct_fwd_digits", 12 * B, 8, PHIM, *N), 33.8),
    (lambda: r.ntt_bound("ct_inv", 3 * B, 12, PHIM, *N), 22.5),
    (lambda: r.crt_bound("crt_to_limbs", 3 * B, 12, 15, 6, PHIM), 16.9),
    (lambda: r.crt_bound("crt_to_limbs", 2 * B, 8, 10, 6, PHIM), 8.8),
    (lambda: r.crt_bound("limbs_to_residues", 4 * B, 12, 6, 6, PHIM), 22.5),
    (lambda: r.modular_bound("tensor_product", B, 12, PHIM), 26.3),
    (lambda: r.modular_bound("keyswitch_dot", B, 8, PHIM, 12), 36.0),
]


@pytest.mark.parametrize("bound,us", MAIN_US)
def test_main_shape_bounds(bound, us):
    ms, by = bound()
    assert by == "bytes" and round(ms * 1e3, 1) == us


def test_peaks_and_derived_rate():
    assert (r.HBM_BYTES_PER_S, r.INT8_OPS_PER_S, r.F64_OPS_PER_S) == (
        3.35e12, 1979e12, 67e12)
    # the one rate no data sheet publishes, and the file says so
    assert r.INT32_OPS_PER_S == pytest.approx(132 * 64 * 1.98e9 * 2, rel=0.01)
    assert "derived, not published" in open(r.__file__).read()


def test_step_of_main_context():
    from bench_port.program import context
    ctx = context({"context": {"m": 8192, "log_q": 80, "p": 40961,
                               "generator": 3, "decomp_size": 3,
                               "stdev": 3.2}})
    s = step_shapes(ctx, B)
    assert (s.L, s.Lk, s.n, s.nk, s.n_ct, s.ndigits, s.split) == (
        12, 8, 15, 10, 6, 4, N)
    # the keyswitch basis' inverse of 2 x 64 parts: 10.0 us
    assert s.ntt_ms() == pytest.approx((30.0 + 22.5 + 10.0 + 33.8) / 1e3,
                                       rel=2e-3)
    assert s.crt_ms() == pytest.approx((16.9 + 8.8 + 22.5) / 1e3, rel=2e-3)
    assert s.modular_ms() == pytest.approx((26.3 + 36.0) / 1e3, rel=2e-3)
