"""The cases of test_torch_scheme_ops.py on the wide residue lane (chain
primes below 2^23, forced with prime_bits = 23 at m = 32), in a file of
their own so that xdist runs the two lanes side by side."""
import pytest

from test_torch_scheme_ops import (  # noqa: F401  (collected here, with this `world`)
    make_world, test_batched_scalar_shapes, test_keys_equal_jax,
    test_op_equals_jax_and_plaintext, test_scheme_parity_with_oracle)


@pytest.fixture(scope="module")
def world():
    return make_world(prime_bits=23)
