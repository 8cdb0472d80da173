"""The cases of test_torch_scheme_ops.py on a ring of the dense transform
family, the reference's canonical FheContext(m=22, log_q=80, p=23,
generator=7), in a file of their own so that xdist runs it beside the
Cooley-Tukey rings."""
import pytest

from test_torch_scheme_ops import (  # noqa: F401  (collected here, with this `world`)
    make_world, test_batched_scalar_shapes, test_keys_equal_jax,
    test_op_equals_jax_and_plaintext, test_scheme_parity_with_oracle)


@pytest.fixture(scope="module")
def world():
    J, T = make_world(ring=(22, 80, 23, 7))
    assert not T.ctx.use_ct
    return J, T
