"""The two applications, encrypted regression and statistics, in both
packages on one draw of randomness (RandomSource(42)) at m = 32, p = 97,
g = 3 (8 usable slots, so a d = 2, n = 16 dataset fills 2 blocks),
narrow lane: every returned ciphertext equals fhe_si_tpu's, every
decrypt equals the plaintext oracle mod p, the host helpers equal JAX's,
and the port's CLIs reach MATCH.  test_torch_apps_wide.py runs the same
on the wide lane."""
import numpy as np
import pytest
import torch

from fhe_si_tpu import sampling
from fhe_si_tpu.apps import regression as jreg, statistics as jst
from fhe_si_tpu.cli import gen_data
from fhe_si_tpu.context import FheContext as RefContext
from fhe_si_tpu_torch import DeviceContext, FheContext
from fhe_si_tpu_torch.apps import regression as treg, statistics as tst
from fhe_si_tpu_torch.cli import test_regression as treg_cli
from fhe_si_tpu_torch.cli import test_statistics as tst_cli

torch.set_num_threads(1)

M, P, G, SEED = 32, 97, 3, 42


def run_apps(tmp_dir, prime_bits=None, ring=(M, P, G)):
    """Both packages' Regression and Statistics on one dataset at ring
    (m, p, generator), a ring with 8 usable slots; returns a dict of (JAX
    ciphertexts, port ciphertexts, port secret key, expected slot-0 values
    mod p) per app, plus the data file, contexts and p."""
    m, p, g = ring
    path = str(tmp_dir / "data.txt")
    gen_data.generate(path, 2, 16, seed=5)
    out = {"path": path, "p": p}

    def contexts(log_q, xi):
        kw = dict(m=m, log_q=log_q, p=p, generator=g, xi=xi,
                  prime_bits=prime_bits)
        ref, ctx = RefContext(**kw), FheContext(**kw)
        assert ctx.usable_slots == 8 and ctx.wide == (prime_bits is not None)
        return ref, ctx

    raw, labels, dim = treg.load_data(path)
    ref, ctx = contexts(*treg.derive_log_q(len(labels), dim, p))
    jm = jreg.Regression(ref, sampling.RandomSource(SEED))
    tm = treg.Regression(DeviceContext(ctx, "cpu"), sampling.RandomSource(SEED))
    jm.add_data(*jreg.batch_data(ref, raw, labels))
    tm.add_data(*treg.batch_data(ctx, raw, labels))
    assert tm.data.num_rows() == 2
    (jth, jdet), (tth, tdet) = jm.regress(), tm.regress()
    theta_pt, det_pt = treg.regress_pt(raw, labels)
    out["regression"] = (list(jth) + [jdet], list(tth) + [tdet],
                         tm.secret_key, list(theta_pt) + [det_pt])
    out["regression_model"] = (jm, tm)

    data, dim = tst.load_data(path)
    n = data.num_rows()
    ref, ctx = contexts(*tst.derive_log_q(n, dim, p))
    js = jst.Statistics(ref, sampling.RandomSource(SEED))
    ts = tst.Statistics(DeviceContext(ctx, "cpu"), sampling.RandomSource(SEED))
    js.add_data(*jst.batch_data(ref, data))
    ts.add_data(*tst.batch_data(ctx, data))

    def flat(res):
        cov, mu, n_ct, n2 = res
        return (list(mu) + [n_ct]
                + [cov.at(i, j) for i in range(dim) for j in range(dim)]
                + [n2])

    cov_pt = tst.compute_covariance_pt(data)
    want = (tst.compute_nth_moment_pt(data, 1) + [n]
            + [cov_pt.at(i, j) for i in range(dim) for j in range(dim)]
            + [n * n])
    out["statistics"] = (flat(js.compute_covariance()),
                         flat(ts.compute_covariance()), ts.secret_key, want)
    out["contexts"] = (ref, ctx)
    return out


@pytest.fixture(scope="module")
def apps(tmp_path_factory):
    return run_apps(tmp_path_factory.mktemp("apps"))


@pytest.mark.parametrize("app", ["regression", "statistics"])
def test_ciphertexts_equal_jax(apps, app):
    jcts, tcts = apps[app][:2]
    assert len(jcts) == len(tcts)
    for j, t in zip(jcts, tcts):
        assert not t.scaled_up and t.parts.dtype == torch.int32
        assert np.array_equal(np.asarray(j.parts), t.parts.numpy())


@pytest.mark.parametrize("app", ["regression", "statistics"])
def test_decrypts_equal_oracle(apps, app):
    _, tcts, sk, want = apps[app]
    got = [int(pt.decode_slots()[0]) for pt in sk.decrypt_batch(tcts)]
    assert got == [w % apps["p"] for w in want]


def test_keys_equal_jax(apps):
    jm, tm = apps["regression_model"]
    assert [k for k, _ in tm.rotations] == jm.auto_ks
    assert len(jm.auto_ks) == 3          # log2(8 usable slots)
    for jk, (_, tk) in zip(jm.auto_key_switch, tm.rotations):
        assert np.array_equal(np.asarray(jk.matrix_evals),
                              tk.matrix_evals.numpy())


def test_host_helpers_equal_jax(apps):
    path = apps["path"]
    jraw, jlabels, jdim = jreg.load_data(path)
    traw, tlabels, tdim = treg.load_data(path)
    assert (traw.rows, tlabels, tdim) == (jraw.rows, jlabels, jdim)
    assert treg.regress_pt(traw, tlabels) == jreg.regress_pt(jraw, jlabels)
    jdata, _ = jst.load_data(path)
    tdata, _ = tst.load_data(path)
    assert tdata.rows == jdata.rows
    assert tst.compute_nth_moment_pt(tdata, 2) == jst.compute_nth_moment_pt(
        jdata, 2)
    assert tst.compute_covariance_pt(tdata).rows == \
        jst.compute_covariance_pt(jdata).rows
    for n, d, p in ((16, 2, 97), (256, 4, 40961), (1000, 3, 40961)):
        assert treg.derive_log_q(n, d, p) == jreg.derive_log_q(n, d, p)
        assert tst.derive_log_q(n, d, p) == jst.derive_log_q(n, d, p)
    ref, ctx = apps["contexts"]
    for jb, tb in ((jreg.batch_data(ref, jraw, jlabels),
                    treg.batch_data(ctx, traw, tlabels)),
                   (jst.batch_data(ref, jdata), tst.batch_data(ctx, tdata))):
        jpts, tpts = sum(jb[0], []) + jb[1], sum(tb[0], []) + tb[1]
        assert len(jpts) == len(tpts) == 6
        for jp, tp in zip(jpts, tpts):
            assert np.array_equal(jp.message, tp.message)


@pytest.mark.parametrize("cli", [treg_cli, tst_cli], ids=["regression",
                                                           "statistics"])
def test_cli_matches_on_cpu(apps, cli, capsys, tmp_path):
    argv = ["x", apps["path"], str(P), str(G), "7", f"--m={M}"]
    assert cli.main(argv + ["--device=cpu"]) == 0
    out = capsys.readouterr()
    assert out.out.rstrip().endswith("MATCH") and "MISMATCH" not in out.out
    assert "[phases]" in out.err and "(narrow lane)" in out.out
    if not torch.cuda.is_available():
        assert cli.main(argv) == 1               # --device=cuda:0 by default
        assert "pass --device=cpu" in capsys.readouterr().err
    trace = tmp_path / "trace"             # the app phase, traced
    assert cli.main(argv + ["--device=cpu", "--trace", str(trace)]) == 0
    assert capsys.readouterr().out.rstrip().endswith("MATCH")
    assert len(list(trace.glob("*.pt.trace.json"))) == 1
