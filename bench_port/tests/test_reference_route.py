"""test_reference.py's tests of the plain reference against the port's
CPU path, on a third ring: the reference's own m = p - 1 = 4126
(p = 4127, logQ 80), which DeviceContext puts on the matmul route
unforced (N = 2063 prime splits as 2063 x 1): encryptions and products
limb for limb, decryption, and the corrupted outputs."""
import pytest

from bench_port import program
from helpers import TINY_MIX
from test_reference import (SEED, test_corrupt_output_fails,  # noqa: F401
                            test_encryptions_equal, test_products_decrypt,
                            test_products_equal)

ROUTE = {"m": 4126, "log_q": 80, "p": 4127, "generator": 5, "decomp_size": 3,
         "stdev": 3.2}


@pytest.fixture(params=[ROUTE], ids=["m4126_route"], scope="module")
def setup(request):
    config = {"context": request.param}
    prog = program.setup(config, TINY_MIX, SEED, "cpu")
    assert prog.dev.ct_route == "matmul"
    return config, prog
