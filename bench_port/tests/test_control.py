"""The control (control.py: the reference with ScaleDown in float64, put
in the program's place) comes out as not correct, at a size a test run
can hold; the exact reference in the same place comes out correct."""
import numpy as np
import pytest

from bench_port import check, control, inputs
from bench_port.reference import fhe_si
from helpers import DENSE, SMALL, TINY_MIX

# logQ 120: the tensored parts (about 2^250) are far past float64's 53 bits
WIDE_Q = dict(SMALL, log_q=120)


@pytest.mark.parametrize("ctx", [SMALL, WIDE_Q, DENSE],
                         ids=["m256", "m256_q120", "m22_dense"])
@pytest.mark.parametrize("seed", [1, 2**31 + 77])
def test_control_fails(ctx, seed):
    got = control.reading({"context": ctx}, TINY_MIX, seed)
    assert got["mismatched_limbs"] > check.LIMIT


def test_exact_reference_in_place_passes():
    config, seed = {"context": SMALL}, 5
    j = check.Judge(config, TINY_MIX, seed)
    width = SMALL["log_q"] // fhe_si.LIMB_BITS + 1
    outs = {}
    for pair in inputs.checked_pairs(seed, TINY_MIX):
        limbs = np.stack([fhe_si.to_limbs(x, width) for x in j.product(pair)])
        outs[pair] = [limbs, limbs]
    assert check.judge(config, TINY_MIX, seed, outs)["mismatched_limbs"] == 0
