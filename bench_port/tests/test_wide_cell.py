"""The cell ct32768_q220w.b64 as the repository's BENCHMARK.json gives
it: the power-of-two ring m = 2^15 at the reference's regression logQ
220 (p = 65537) on the wide residue lane, and the metrics it reports."""
from bench_port import cell as cells
from bench_port import program
from bench_port.run import step_shapes

CELL = "ct32768_q220w.b64"


def test_cell_reports_its_metrics():
    c = cells.load(CELL)
    assert c.chips == 1 and c.traffic["pairs_per_call"] == 64
    assert [m["name"] for m in c.end_to_end] == ["setup_s", "mults_per_s"]
    assert {m["name"] for m in c.per_layer} == {
        "device_idle_pct.tput", "launches_per_step.tput", "enqueue_ms.tput",
        "ntt_roofline", "crt_roofline", "modular_roofline"}
    for m in c.per_layer:
        assert callable(c.reader(m["name"]))
        assert m["moves"] == "mults_per_s"


def test_config_shape():
    c = cells.load(CELL)
    assert c.config["context"] == {"m": 32768, "log_q": 220, "p": 65537,
                                   "generator": 3, "decomp_size": 3,
                                   "stdev": 3.2}
    assert c.config["reduced"] == []
    ctx = program.context(c.config)
    assert ctx.use_ct and ctx.wide
    assert (ctx.phim, ctx.num_primes, len(ctx.ksw_rows), ctx.ndigits,
            ctx.n_limbs_ct) == (16384, 23, 13, 10, 14)
    assert step_shapes(ctx, 64).split == (16384, 128, 128)
