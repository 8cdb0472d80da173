"""The port on the wide residue lane (chain primes below 2^23) against the
benchmark's plain reference, and the cell ct32768_q220w.b64 as the
repository's BENCHMARK.json gives it.

The lane test runs m = 256 (p = 257, logQ 80) with prime_bits=23, since
the narrow chain never starves there; it is set up by the same calls as
the benchmark's program.setup (with program.context giving the wide
context) from bench_port's seeded draws, and check.judge compares the
outputs limb for limb, as the benchmark's check does.  The cell's own
ring, m = 2^15 at logQ 220, is held to its shapes and to the
yardstick's bounds; its mul+relin runs on the card (test_torch_cuda.py).
Last, ntt_ct_cuda.TWIDDLE_GLOBAL's rule: which layouts of ct_mma_kernel
leave the twiddle pairs in global memory."""
import numpy as np
import pytest
import torch

from bench_port import cell as cells
from bench_port import check, inputs, program
from bench_port.reference import fhe_si
from bench_port.run import step_shapes
from fhe_si_tpu_torch import FheContext
from fhe_si_tpu_torch.hostmath import numbth
from fhe_si_tpu_torch.ops import ntt_ct, ntt_ct_cuda

CELL = "ct32768_q220w.b64"
SEED = 2**31 + 23
MIX = {"mode": "offline, closed loop", "pairs_per_call": 4, "pool": 2,
       "checked_pairs": 2}
WIDE = {"m": 256, "log_q": 80, "p": 257, "generator": 3, "decomp_size": 3,
        "stdev": 3.2}
TRANSFORMS = ("ct_fwd", "ct_fwd_digits", "ct_inv")


def _wide_context(cfg):
    c = cfg["context"]
    return FheContext(m=c["m"], log_q=c["log_q"], p=c["p"],
                      generator=c["generator"], decomp_size=c["decomp_size"],
                      stdev=c["stdev"], prime_bits=23)


@pytest.fixture(scope="module")
def wide():
    """(config, program, judge, {checked pair: [first, second] output})
    on the wide lane; each checked pair's pool entry multiplied twice, as
    the window's first and last calls on it."""
    config = {"context": WIDE}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(program, "context", _wide_context)
        prog = program.setup(config, MIX, SEED, "cpu")
    ntt_ct_cuda.reset_twiddle_global()
    outs = {}
    for k, i in inputs.checked_pairs(SEED, MIX):
        outs[(k, i)] = [prog.mul_relin(k)[i].numpy() for _ in range(2)]
    return config, prog, check.Judge(config, MIX, SEED), outs


def test_ring_is_on_the_wide_lane(wide):
    ctx = wide[1].ctx
    assert ctx.wide and ctx.use_ct and wide[1].dev.ct_route == "kernel"
    assert all((1 << 20) < q < (1 << 23) for q in map(int, ctx.primes))
    assert (ctx.phim, ctx.num_primes, len(ctx.ksw_rows), ctx.ndigits,
            ctx.n_limbs_ct) == (128, 9, 7, 4, 6)


def test_encryptions_equal(wide):
    _, prog, j, outs = wide
    for k, i in outs:
        for o, parts in enumerate((prog.a[k][i], prog.b[k][i])):
            want = j.ref.encrypt(j.pk, j.pool.msgs[k, i, o],
                                 j.pool.r[k, i, o], j.pool.errors[k, i, o])
            got = parts.numpy()
            assert np.array_equal(got, np.stack(
                [fhe_si.to_limbs(x, got.shape[-1]) for x in want]))


def test_products_equal(wide):
    config, _, j, outs = wide
    got = check.judge(config, MIX, SEED, outs, judge_class=lambda *_: j)
    assert got == {"mismatched_limbs": 0, "failed_outputs": 0,
                   "judged_outputs": 2 * len(outs)}


def test_products_decrypt(wide):
    """The reference's product, which the port's equals limb for limb,
    decrypts to the plaintext product."""
    config, _, j, outs = wide
    keys = inputs.keys(SEED, config["context"], j.ref.phim, j.ref.ndigits)
    for pair in outs:
        want = j.ref.plaintext_mul(j.pool.msgs[pair + (0,)],
                                   j.pool.msgs[pair + (1,)])
        assert np.array_equal(j.ref.decrypt(keys.s, j.product(pair)), want)


def _one_limb(outs):
    pair = next(iter(outs))
    out = outs[pair][0].copy()
    out[1, 77, 3] ^= 1
    return {pair: [out]}, (1, 1, 1)


def _swapped(outs):
    first, second = list(outs)
    return ({first: [outs[second][0]], second: [outs[first][0]]},
            (None, 2, 2))


@pytest.mark.parametrize("plant", [_one_limb, _swapped],
                         ids=["one-limb", "pairs-swapped"])
def test_planted_fault_fails(wide, plant):
    """A single limb changed counts one mismatched limb; two pairs'
    outputs swapped fail both."""
    config, _, j, outs = wide
    planted, (limbs, failed, judged) = plant(outs)
    got = check.judge(config, MIX, SEED, planted, judge_class=lambda *_: j)
    assert (got["failed_outputs"], got["judged_outputs"]) == (failed, judged)
    if limbs is None:
        assert got["mismatched_limbs"] > 1000
    else:
        assert got["mismatched_limbs"] == limbs


def test_cpu_path_counts_no_global_twiddle(wide):
    """The CPU path's mul+relin runs the plain transforms, which count
    nothing in TWIDDLE_GLOBAL."""
    wide[1].mul_relin(0)
    assert ntt_ct_cuda.TWIDDLE_GLOBAL == dict.fromkeys(TRANSFORMS, 0)


def test_cell_context_and_shapes():
    c = cells.load(CELL)
    assert c.chips == 1 and c.traffic["pairs_per_call"] == 64
    assert c.config["context"] == {"m": 32768, "log_q": 220, "p": 65537,
                                   "generator": 3, "decomp_size": 3,
                                   "stdev": 3.2}
    assert c.config["reduced"] == []
    ctx = program.context(c.config)
    assert ctx.use_ct and ctx.wide
    assert (ctx.phim, ctx.num_primes, len(ctx.ksw_rows), ctx.ndigits,
            ctx.n_limbs_ct) == (16384, 23, 13, 10, 14)
    assert all(q < (1 << 23) for q in map(int, ctx.primes))
    step = step_shapes(ctx, 64)
    assert step.split == (16384, 128, 128)
    assert (step.n, step.nk) == (33, 19)
    # the yardstick's bounds of one call, in microseconds
    assert step.ntt_ms() * 1e3 == pytest.approx(1420.5, abs=0.05)
    assert step.crt_ms() * 1e3 == pytest.approx(420.7, abs=0.05)
    assert step.modular_ms() * 1e3 == pytest.approx(737.7, abs=0.05)


def test_cell_metric_set():
    c = cells.load(CELL)
    assert [m["name"] for m in c.end_to_end] == ["setup_s", "mults_per_s"]
    assert {m["name"] for m in c.per_layer} == {
        "device_idle_pct.tput", "launches_per_step.tput", "enqueue_ms.tput",
        "ntt_roofline", "crt_roofline", "modular_roofline",
        "keyswitch_roofline", "ntt_fwd_roofline", "ntt_digits_roofline",
        "ntt_inv_roofline", "call_start_idle_ms.tput", "plain_ms.tput"}


# (S, R, fold words) -> whether the layout leaves the twiddle in global
# memory, and kernel_smem: m = 2^15's 128 x 128 (the rowsplit schedule's
# one-row planes) and both orientations of m = 20480 (its inverse with
# the fold's 2048-word tail) do; m = 8192's 64 x 64 and m = 2^14's
# forward 64 x 128 keep it in shared memory
TWIDDLE_RULE = [
    pytest.param((128, 128, 0, True, 196608), id="m32768-128x128"),
    pytest.param((80, 128, 0, True, 159744), id="m20480-fwd-80x128"),
    pytest.param((128, 80, 2048, True, 167936), id="m20480-inv-128x80"),
    pytest.param((64, 64, 0, False, 110592), id="m8192-64x64"),
    pytest.param((64, 128, 0, False, 229376), id="m16384-fwd-64x128")]


@pytest.mark.parametrize("rule", TWIDDLE_RULE)
def test_twiddle_global_rule(rule):
    """twiddle_in_global is kernel_smem's rule: the twiddle pairs stay out
    of shared memory exactly where the byte planes (and the fold's tail)
    and S * tw_stride(R) * 4 bytes of twiddle exceed SMEM_MAX, and
    kernel_smem counts the twiddle exactly where it stays in."""
    S, R, fold, want, smem = rule
    tw = S * ntt_ct_cuda.tw_stride(R) * 4
    assert ntt_ct_cuda.twiddle_in_global(S, R, fold) is want
    assert ntt_ct_cuda.kernel_smem(S, R, fold) == smem <= ntt_ct_cuda.SMEM_MAX
    planes = smem if want else smem - tw
    assert (planes + tw > ntt_ct_cuda.SMEM_MAX) is want


def test_twiddle_global_counts_launches_only():
    """TWIDDLE_GLOBAL has one key a transform, reset_twiddle_global zeroes
    it (and no other counter), and the plain versions that CPU tensors
    take at m = 2^15 count nothing there."""
    assert set(ntt_ct_cuda.TWIDDLE_GLOBAL) == set(TRANSFORMS)
    ntt_ct_cuda.TWIDDLE_GLOBAL["ct_inv"] += 2
    ntt_ct_cuda.PHIM_FUSED["ct_fwd"] += 1
    ntt_ct_cuda.reset_twiddle_global()
    assert set(ntt_ct_cuda.TWIDDLE_GLOBAL.values()) == {0}
    assert ntt_ct_cuda.PHIM_FUSED["ct_fwd"] == 1
    ntt_ct_cuda.reset_phim_fused()
    m, qs = 1 << 15, [786433]
    meta, ct = ntt_ct.ct_tables(
        m, qs, [numbth.find_element_of_order(q, m) for q in qs])
    T = {k: torch.as_tensor(v) for k, v in ct.items()}
    x = torch.zeros((1, 1, meta.phim), dtype=torch.int32)
    ntt_ct_cuda.ct_inv(T, ntt_ct_cuda.ct_fwd(T, x, meta), meta)
    assert ntt_ct_cuda.TWIDDLE_GLOBAL == dict.fromkeys(TRANSFORMS, 0)
