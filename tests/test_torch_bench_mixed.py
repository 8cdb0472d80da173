"""The port against the benchmark's plain reference on a mixed-radix ring,
m = 12288 = 2^12 * 3 (p = 12289, logQ 80): phim 4096, which FheContext
puts on the Cooley-Tukey family unforced, split 96 x 64 with q_odd 3, so
every transform of mul+relin runs the phim <-> N steps of ops/ntt_ct.py.
The inputs are bench_port's seeded draws through its program.setup, and
check.judge compares the outputs limb for limb, as the benchmark's check
does.  The steps' counter (ntt_ct.PHIM_STEPS) and spans are held against
a power-of-two ring, m = 256, which has neither."""
import numpy as np
import pytest

from bench_port import check, inputs, program
from bench_port.reference import fhe_si
from fhe_si_tpu_torch import profiling
from fhe_si_tpu_torch.ops import ntt_ct

SEED = 2**31 + 21
MIX = {"mode": "offline, closed loop", "pairs_per_call": 4, "pool": 2,
       "checked_pairs": 2}
MIXED = {"m": 12288, "log_q": 80, "p": 12289, "generator": 5,
         "decomp_size": 3, "stdev": 3.2}
POW2 = {"m": 256, "log_q": 80, "p": 257, "generator": 3, "decomp_size": 3,
        "stdev": 3.2}
STEPS = ("pad_to_N", "drop_excluded", "insert_excluded", "fold_mod_phim")


class _Judge(check.Judge):
    """check.Judge with each pair's product made once: the reference
    takes seconds a pair at phim 4096."""

    def __init__(self, *args):
        super().__init__(*args)
        self._products = {}

    def product(self, pair) -> tuple:
        if pair not in self._products:
            self._products[pair] = super().product(pair)
        return self._products[pair]


@pytest.fixture(scope="module")
def mixed():
    """(config, program, judge, {checked pair: [first, second] output})
    of the mixed ring; each checked pair's pool entry multiplied twice,
    as the window's first and last calls on it."""
    config = {"context": MIXED}
    prog = program.setup(config, MIX, SEED, "cpu")
    outs = {}
    for k, i in inputs.checked_pairs(SEED, MIX):
        outs[(k, i)] = [prog.mul_relin(k)[i].numpy() for _ in range(2)]
    return config, prog, _Judge(config, MIX, SEED), outs


def test_ring_rides_the_kernel_route(mixed):
    _, prog, _, _ = mixed
    ctx = prog.ctx
    assert ctx.use_ct and not ctx.wide and prog.dev.ct_route == "kernel"
    assert tuple(prog.dev.ct_meta) == (96, 64, 4096, 3)


def test_encryptions_equal(mixed):
    config, prog, j, outs = mixed
    for k, i in outs:
        for o, parts in enumerate((prog.a[k][i], prog.b[k][i])):
            want = j.ref.encrypt(j.pk, j.pool.msgs[k, i, o],
                                 j.pool.r[k, i, o], j.pool.errors[k, i, o])
            got = parts.numpy()
            assert np.array_equal(got, np.stack(
                [fhe_si.to_limbs(x, got.shape[-1]) for x in want]))


def test_products_equal(mixed):
    config, _, j, outs = mixed
    got = check.judge(config, MIX, SEED, outs, judge_class=lambda *_: j)
    assert got == {"mismatched_limbs": 0, "failed_outputs": 0,
                   "judged_outputs": 2 * len(outs)}


def test_products_decrypt(mixed):
    """The reference's product, which the port's equals limb for limb,
    decrypts to the plaintext product."""
    config, _, j, outs = mixed
    keys = inputs.keys(SEED, config["context"], j.ref.phim, j.ref.ndigits)
    for pair in outs:
        want = j.ref.plaintext_mul(j.pool.msgs[pair + (0,)],
                                   j.pool.msgs[pair + (1,)])
        assert np.array_equal(j.ref.decrypt(keys.s, j.product(pair)), want)


def test_corrupt_limb_fails(mixed):
    config, _, j, outs = mixed
    pair = next(iter(outs))
    out = outs[pair][0].copy()
    out[0, 4095, 5] ^= 1
    got = check.judge(config, MIX, SEED, {pair: [out]},
                      judge_class=lambda *_: j)
    assert got == {"mismatched_limbs": 1, "failed_outputs": 1,
                   "judged_outputs": 1}


@pytest.mark.parametrize("ring, each", [(MIXED, 2), (POW2, 0)],
                         ids=["m12288", "m256"])
def test_phim_steps_counted_and_spanned_where_they_run(mixed, ring, each):
    """One mul_relin counts each phim <-> N step twice on the mixed ring
    (the forward and digit transforms pad and drop, ScaleDown's and the
    keyswitch's inverses insert and fold) and none on m = 2^k; under
    profiling.counting() each step is a span of its own name, entered as
    often, and the output is the one with no sink."""
    prog = mixed[1] if ring is MIXED else program.setup(
        {"context": ring}, MIX, SEED, "cpu")
    ntt_ct.reset_phim_steps()
    plain = prog.mul_relin(1)
    assert ntt_ct.PHIM_STEPS == dict.fromkeys(STEPS, each)
    with profiling.counting() as table:
        out = prog.mul_relin(1)
    assert np.array_equal(out.numpy(), plain.numpy())
    assert {s: table.get("fhe." + s, [0])[0] for s in STEPS} == dict.fromkeys(
        STEPS, each)
    assert table["fhe.mul_relin"][0] == 1
    ntt_ct.reset_phim_steps()
    assert set(ntt_ct.PHIM_STEPS.values()) == {0}
