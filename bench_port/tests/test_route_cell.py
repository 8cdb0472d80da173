"""The cell route8146_q188.b64 as the repository's BENCHMARK.json gives
it: the reference's ring m = p - 1 = 8146 at logQ 188 on the matmul
route, and the metrics it reports."""
from bench_port import cell as cells
from bench_port import program
from bench_port.run import step_shapes

CELL = "route8146_q188.b64"


def test_cell_reports_its_metrics():
    c = cells.load(CELL)
    assert c.chips == 1 and c.traffic["pairs_per_call"] == 64
    assert [m["name"] for m in c.end_to_end] == ["setup_s", "mults_per_s"]
    assert {m["name"] for m in c.per_layer} == {
        "device_idle_pct.tput", "launches_per_step.tput", "enqueue_ms.tput",
        "crt_roofline", "modular_roofline", "route_roofline",
        "route_glue_ms"}
    for m in c.per_layer:
        assert callable(c.reader(m["name"]))
        assert m["moves"] == "mults_per_s"


def test_config_shape():
    c = cells.load(CELL)
    assert c.config["context"] == {"m": 8146, "log_q": 188, "p": 8147,
                                   "generator": 3, "decomp_size": 3,
                                   "stdev": 3.2}
    assert c.config["reduced"] == []
    ctx = program.context(c.config)
    assert ctx.use_ct and not ctx.wide
    assert (ctx.phim, ctx.num_primes, len(ctx.ksw_rows), ctx.ndigits,
            ctx.n_limbs_ct) == (4072, 23, 13, 8, 12)
    s = step_shapes(ctx, 64)
    assert s.split == (4073, 4073, 1)
