"""The cases of test_torch_apps.py on the wide residue lane (chain primes
below 2^23, forced with prime_bits = 23), in a file of their own so that
xdist runs the two lanes side by side.  The CLIs take no prime_bits, so
their MATCH runs stay in test_torch_apps.py; at m = 8192 they land on
the wide lane by themselves (chip_smoke.py)."""
import pytest

from test_torch_apps import (  # noqa: F401  (collected here, with this `apps`)
    run_apps, test_ciphertexts_equal_jax, test_decrypts_equal_oracle,
    test_host_helpers_equal_jax, test_keys_equal_jax)


@pytest.fixture(scope="module")
def apps(tmp_path_factory):
    return run_apps(tmp_path_factory.mktemp("apps_wide"), prime_bits=23)
