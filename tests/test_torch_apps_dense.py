"""The cases of test_torch_apps.py on a ring of the dense transform
family, the reference's canonical m = 22, p = 23, g = 7 (10 slots, 8 of
them usable, so the same d = 2, n = 16 dataset fills 2 blocks), in a file
of their own so that xdist runs it beside the Cooley-Tukey ring."""
import pytest

from test_torch_apps import (  # noqa: F401  (collected here, with this `apps`)
    run_apps, test_ciphertexts_equal_jax, test_decrypts_equal_oracle,
    test_host_helpers_equal_jax, test_keys_equal_jax)


@pytest.fixture(scope="module")
def apps(tmp_path_factory):
    out = run_apps(tmp_path_factory.mktemp("apps_dense"), ring=(22, 23, 7))
    assert not out["contexts"][1].use_ct
    return out
