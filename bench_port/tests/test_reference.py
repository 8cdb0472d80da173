"""The plain reference against the port's CPU path on the same seeded
inputs, at m = 256 (Cooley-Tukey family) and at the dense ring m = p - 1
= 22; and the comparison it decides with."""
import numpy as np
import pytest

from bench_port import check, inputs, program
from bench_port.reference import fhe_si
from helpers import DENSE, SMALL, TINY_MIX

SEED = 2**31 + 5


@pytest.fixture(params=[SMALL, DENSE], ids=["m256", "m22_dense"],
                scope="module")
def setup(request):
    config = {"context": request.param}
    prog = program.setup(config, TINY_MIX, SEED, "cpu")
    return config, prog


def test_encryptions_equal(setup):
    config, prog = setup
    j = check.Judge(config, TINY_MIX, SEED)
    for k in range(TINY_MIX["pool"]):
        for i in range(TINY_MIX["pairs_per_call"]):
            for o, parts in enumerate((prog.a[k][i], prog.b[k][i])):
                want = j.ref.encrypt(j.pk, j.pool.msgs[k, i, o],
                                     j.pool.r[k, i, o], j.pool.errors[k, i, o])
                got = parts.numpy()
                assert np.array_equal(got, np.stack(
                    [fhe_si.to_limbs(x, got.shape[-1]) for x in want]))


def test_products_equal(setup):
    config, prog = setup
    outs = {(k, i): [prog.mul_relin(k)[i].numpy()]
            for k in range(TINY_MIX["pool"])
            for i in range(TINY_MIX["pairs_per_call"])}
    got = check.judge(config, TINY_MIX, SEED, outs)
    assert got == {"mismatched_limbs": 0, "failed_outputs": 0,
                   "judged_outputs": len(outs)}


def test_products_decrypt(setup):
    """The reference's own product decrypts to the plaintext product."""
    config, _ = setup
    j = check.Judge(config, TINY_MIX, SEED)
    keys = inputs.keys(SEED, config["context"], j.ref.phim, j.ref.ndigits)
    for pair in [(0, 0), (1, 3)]:
        want = j.ref.plaintext_mul(j.pool.msgs[pair + (0,)],
                                   j.pool.msgs[pair + (1,)])
        assert np.array_equal(j.ref.decrypt(keys.s, j.product(pair)), want)


@pytest.mark.parametrize("fault", ["one_limb", "wrong_shape"])
def test_corrupt_output_fails(setup, fault):
    config, prog = setup
    out = prog.mul_relin(1)[2].numpy().copy()
    if fault == "one_limb":
        out[1, 3, 0] ^= 1
        want = 1
    else:
        out = out[:, :-1]
        want = out.size
    got = check.judge(config, TINY_MIX, SEED, {(1, 2): [out]})
    assert got["mismatched_limbs"] == want and got["failed_outputs"] == 1


def test_checked_pairs_cover_each_slice():
    mix = dict(TINY_MIX, pairs_per_call=64)
    for seed in range(20):
        pairs = inputs.checked_pairs(seed, mix)
        assert [i // 32 for _, i in pairs] == [0, 1]
        assert all(0 <= k < mix["pool"] for k, _ in pairs)
    assert inputs.checked_pairs(7, mix) == inputs.checked_pairs(7, mix)
    one = dict(TINY_MIX, pairs_per_call=1, pool=8)
    assert len(set(inputs.checked_pairs(3, one))) == 2


def test_cyclotomic():
    assert fhe_si.cyclotomic(8) == [1, 0, 0, 0, 1]
    assert fhe_si.cyclotomic(12) == [1, 0, -1, 0, 1]
    assert fhe_si.cyclotomic(22) == [(-1) ** i for i in range(11)]
    ring = fhe_si.Ring(12)
    assert list(ring.mul([0, 0, 0, 1], [0, 0, 0, 1])) == [-1, 0, 0, 0]
