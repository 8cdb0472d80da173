"""The port's serializers against fhe_si_tpu's at m = 22, with no
tolerance: the npz archives of serialization.py (mirror of
tests/test_serialization.py) and the reference byte format of
refserial.py / refcompat.py (mirror of tests/test_refcompat.py, without
the JAX package's optional g++ codec core, which the port does not
load).  Both packages draw the same keys and ciphertexts from one seed;
every file one of them writes equals the other's, array for array or
byte for byte, and loads in the other, whose decrypts are right."""
import struct

import numpy as np
import pytest
import torch

from fhe_si_tpu import (refcompat as jrefcompat, refserial as jrefserial,
                        sampling, scheme as jscheme,
                        serialization as jser)
from fhe_si_tpu.apps.matrix import Matrix as JMatrix
from fhe_si_tpu.context import FheContext as RefContext
from fhe_si_tpu.hostmath import numbth, oracle
from fhe_si_tpu_torch import DeviceContext, FheContext, refcompat, refserial
from fhe_si_tpu_torch import scheme, serialization as ser
from fhe_si_tpu_torch.apps.matrix import Matrix

torch.set_num_threads(1)

KW = dict(m=22, log_q=80, p=23, generator=7)
NPZ = ("ctx", "sk", "pk", "ksw", "ct", "ct2")


class Pkg:
    """One package's context, keys, relinearization key and a
    ciphertext, drawn from RandomSource(seed)."""

    def __init__(self, sch, ctx, dev, seed):
        self.sch, self.ctx, self.dev = sch, ctx, dev
        self.src = sampling.RandomSource(seed)
        self.sk, self.pk = sch.keygen(dev, self.src)
        self.ksw = sch.KeySwitch.for_relinearization(self.sk, self.src)
        self.msg = self.src.uniform_mod_p(ctx.phim, ctx.p)
        self.ct = self.pk.encrypt(sch.Plaintext(ctx, self.msg), self.src)


@pytest.fixture(scope="module")
def ctxs():
    ref, ctx = RefContext(**KW), FheContext(**KW)
    return ref, ctx, DeviceContext(ctx, "cpu")


def _pair(ctxs, seed):
    ref, ctx, dev = ctxs
    return Pkg(jscheme, ref, ref, seed), Pkg(scheme, ctx, dev, seed)


@pytest.fixture(scope="module")
def ref_chain():
    """Synthetic reference-style chain: larger primes = 1 mod 2m with
    2m-th roots, like AddPrimesBySize builds (FHEContext.cpp:88-115);
    tests/test_refcompat.py:17-29."""
    m = 22
    primes = []
    p = (1 << 30) - 1
    p -= p % (2 * m)
    p += 2 * m + 1
    while len(primes) < 8:
        p -= 2 * m
        if numbth.is_prime(p):
            primes.append(p)
    return [(q, numbth.find_element_of_order(q, 2 * m)) for q in primes]


def _ref(ctx, chain):
    return refserial.RefContext(ctx.m, ctx.log_q, ctx.p, ctx.generator,
                                ctx.decomp_size, chain)


def _jref(ctx, chain):
    return jrefserial.RefContext(ctx.m, ctx.log_q, ctx.p, ctx.generator,
                                 ctx.decomp_size, chain)


# ------------------------------------------------------------------ npz
def _export_all(mod, side, d):
    mod.export_context(side.ctx, f"{d}/ctx.npz")
    mod.export_secret_key(side.sk, f"{d}/sk.npz")
    mod.export_public_key(side.pk, f"{d}/pk.npz")
    mod.export_keyswitch(side.ksw, f"{d}/ksw.npz")
    mod.export_ciphertext(side.ct, f"{d}/ct.npz")
    mod.export_ciphertext(side.ct * side.ct, f"{d}/ct2.npz")  # ScaleDown on export


def test_full_roundtrip(ctxs, tmp_path):
    """tests/test_serialization.py on the port: export, import into a new
    context, decrypt, relinearize, encrypt afresh."""
    _, t = _pair(ctxs, 55)
    d = str(tmp_path)
    _export_all(ser, t, d)
    ctx2 = ser.import_context(f"{d}/ctx.npz")
    assert np.array_equal(ctx2.primes, t.ctx.primes)
    assert np.array_equal(ctx2.roots, t.ctx.roots)
    assert (ctx2.m, ctx2.log_q, ctx2.p, ctx2.generator) == (22, 80, 23, 7)
    dev2 = DeviceContext(ctx2, "cpu")
    sk2 = ser.import_secret_key(dev2, f"{d}/sk.npz")
    pk2 = ser.import_public_key(dev2, f"{d}/pk.npz")
    ksw2 = ser.import_keyswitch(dev2, f"{d}/ksw.npz")
    ct1 = ser.import_ciphertext(dev2, f"{d}/ct.npz")
    ct2 = ser.import_ciphertext(dev2, f"{d}/ct2.npz")
    assert sk2.sk_evals.device == dev2.device
    assert list(sk2.decrypt(ct1).message) == list(t.msg % t.ctx.p)
    assert list(sk2.decrypt(ksw2.apply(ct2)).message) == list(
        oracle.plaintext_mul(t.ctx, t.msg, t.msg))
    ct3 = pk2.encrypt(scheme.Plaintext(ctx2, t.msg), sampling.RandomSource(1))
    assert list(sk2.decrypt(ct3).message) == list(t.msg % t.ctx.p)


def test_npz_files_equal_and_load_across_packages(ctxs, tmp_path):
    """Each package's archives hold the same arrays, and each package
    loads the other's and decrypts right."""
    j, t = _pair(ctxs, 56)
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    dj, dt = str(tmp_path / "j"), str(tmp_path / "t")
    _export_all(jser, j, dj)
    _export_all(ser, t, dt)
    for name in NPZ:
        zj, zt = np.load(f"{dj}/{name}.npz"), np.load(f"{dt}/{name}.npz")
        assert sorted(zj.files) == sorted(zt.files), name
        for k in zj.files:
            assert zj[k].dtype == zt[k].dtype, (name, k)
            assert np.array_equal(zj[k], zt[k]), (name, k)
    want = list(oracle.plaintext_mul(t.ctx, t.msg, t.msg))
    # the port reads the JAX package's files
    dev2 = DeviceContext(ser.import_context(f"{dj}/ctx.npz"), "cpu")
    sk2 = ser.import_secret_key(dev2, f"{dj}/sk.npz")
    assert list(sk2.decrypt(ser.import_ciphertext(
        dev2, f"{dj}/ct.npz")).message) == list(t.msg % t.ctx.p)
    ksw2 = ser.import_keyswitch(dev2, f"{dj}/ksw.npz")
    assert list(sk2.decrypt(ksw2.apply(ser.import_ciphertext(
        dev2, f"{dj}/ct2.npz"))).message) == want
    # and the JAX package reads the port's
    ctx3 = jser.import_context(f"{dt}/ctx.npz")
    sk3 = jser.import_secret_key(ctx3, f"{dt}/sk.npz")
    ksw3 = jser.import_keyswitch(ctx3, f"{dt}/ksw.npz")
    assert list(sk3.decrypt(jser.import_ciphertext(
        ctx3, f"{dt}/ct.npz")).message) == list(t.msg % t.ctx.p)
    assert list(sk3.decrypt(ksw3.apply(jser.import_ciphertext(
        ctx3, f"{dt}/ct2.npz"))).message) == want


# ---------------------------------------------------- reference byte format
def test_zz_zzx_roundtrip():
    """tests/test_refcompat.py:32 without its native-core half: the
    port's pure-Python codec writes the JAX package's bytes and reads
    them back."""
    rng = np.random.default_rng(0)
    vals = ([int(v) for v in rng.integers(-2**62, 2**62, 64)]
            + [0, -1, 1, 2**200, -(2**200), 2**600])
    w, jw = refserial.Writer(), jrefserial.Writer()
    w.zzx(vals + [0, 0])
    jw.zzx(vals + [0, 0])
    buf = w.getvalue()
    assert buf == jw.getvalue()
    assert refserial.Reader(buf).zzx() == vals
    assert jrefserial.Reader(buf).zzx() == vals
    r = refserial.Reader(buf)
    assert [r.zz() for _ in range(r.i32() + 1)] == vals
    w = refserial.Writer()
    w.zzx([])
    assert w.getvalue() == struct.pack("<i", -1)
    assert refserial.Reader(w.getvalue()).zzx() == []
    with pytest.raises(EOFError):
        refserial.Reader(buf[:-1]).zzx()


def test_context_stream_roundtrip(ctxs, ref_chain):
    ref, ctx, _ = ctxs
    rc = refserial.RefContext(ctx.m, ctx.log_q, ctx.p, ctx.generator,
                              ctx.decomp_size, ref_chain)
    buf = refserial.write_context(rc)
    assert buf == jrefserial.write_context(_jref(ref, ref_chain))
    back = refserial.read_context(buf)
    assert (back.m, back.log_q, back.p, back.generator, back.decomp_size) \
        == (22, 80, 23, 7, 3)
    assert back.chain == ref_chain
    ctx2 = refcompat.context_from_reference(back)
    assert ctx2.phim == ctx.phim and ctx2.p == ctx.p
    mine = refcompat.export_reference_context(ctx)
    assert mine == jrefcompat.export_reference_context(ref)
    assert refserial.read_context(mine).chain == [
        (int(q), int(r)) for q, r in zip(ctx.primes, ctx.roots)]


def test_ciphertext_interop(ctxs):
    j, t = _pair(ctxs, 3)
    buf = refcompat.export_ciphertext(t.ct)
    assert buf == jrefcompat.export_ciphertext(j.ct)
    back = refcompat.import_ciphertext(buf, t.dev)
    assert back.to_python_parts() == t.ct.to_python_parts()
    assert list(t.sk.decrypt(back).message) == list(t.msg % t.ctx.p)
    jback = jrefcompat.import_ciphertext(buf, j.ctx)
    assert np.array_equal(np.asarray(jback.parts), back.parts.numpy())


def test_dcrt_rebase_roundtrip(ctxs, ref_chain):
    """poly -> reference-basis DoubleCRT -> poly is exact, and the rows
    equal the JAX package's."""
    ref, ctx, _ = ctxs
    poly = [int(v) for v in np.random.default_rng(1).integers(
        -2**60, 2**60, ctx.phim)]
    dcrt = refcompat.poly_to_dcrt(poly, _ref(ctx, ref_chain), ctx)
    jdcrt = jrefcompat.poly_to_dcrt(poly, _jref(ref, ref_chain), ref)
    assert set(dcrt) == set(jdcrt) == set(range(len(ref_chain)))
    for k in dcrt:
        assert np.array_equal(dcrt[k], jdcrt[k])
    assert refcompat.dcrt_to_poly(dcrt, _ref(ctx, ref_chain), ctx) == poly


def test_secret_key_interop(ctxs, ref_chain):
    """The secret key in reference format: the same bytes from both
    packages, and each re-imports the other's and decrypts."""
    j, t = _pair(ctxs, 9)
    rc, jrc = _ref(t.ctx, ref_chain), _jref(j.ctx, ref_chain)
    buf = refcompat.export_secret_key(t.sk, rc)
    assert buf == jrefcompat.export_secret_key(j.sk, jrc)
    sk2 = refcompat.import_secret_key(buf, rc, t.dev)
    assert torch.equal(sk2.sk_evals, t.sk.sk_evals)
    assert list(sk2.decrypt(t.ct).message) == list(t.msg % t.ctx.p)
    jsk2 = jrefcompat.import_secret_key(buf, jrc, j.ctx)
    assert np.array_equal(np.asarray(jsk2.sk_evals), sk2.sk_evals.numpy())


def test_public_key_interop(ctxs, ref_chain):
    """pk export -> import (FHE-SI.cpp:72-78): the same bytes from both
    packages, identical limbs and evals after import, and the same
    ciphertext from the re-imported key on the same randomness."""
    j, t = _pair(ctxs, 11)
    rc = _ref(t.ctx, ref_chain)
    buf = refcompat.export_public_key(t.pk, rc)
    assert buf == jrefcompat.export_public_key(j.pk, _jref(j.ctx, ref_chain))
    pk2 = refcompat.import_public_key(buf, rc, t.dev)
    assert torch.equal(pk2.pk_limbs, t.pk.pk_limbs)
    assert torch.equal(pk2.pk_evals, t.pk.pk_evals)
    er = sampling.sample_encrypt(t.src, t.ctx.phim, t.ctx.stdev)
    ct_a = t.pk.encrypt(scheme.Plaintext(t.ctx, t.msg), er)
    ct_b = pk2.encrypt(scheme.Plaintext(t.ctx, t.msg), er)
    assert ct_a.to_python_parts() == ct_b.to_python_parts()
    assert list(t.sk.decrypt(ct_b).message) == list(t.msg % t.ctx.p)


def test_matrix_framing_and_ciphertext_matrix(ctxs):
    """Matrix<T> framing (u32 rows | u32 cols | row-major, no per-row
    prefixes: Serialization.h:58-81) and a Matrix<Ciphertext> round trip,
    byte-equal to the JAX package's."""
    w = refserial.Writer()
    refserial.write_matrix(w, [[7] * 3, [7] * 3], w.zz)
    buf = w.getvalue()
    assert buf[:8] == struct.pack("<II", 2, 3)
    one = refserial.Writer()
    one.zz(7)
    assert buf[8:] == one.getvalue() * 6
    j, t = _pair(ctxs, 23)
    mats = []
    for side, M in ((j, JMatrix), (t, Matrix)):
        msgs = [[side.src.uniform_mod_p(side.ctx.phim, side.ctx.p)
                 for _ in range(3)] for _ in range(2)]
        mats.append((msgs, M([[side.pk.encrypt(side.sch.Plaintext(
            side.ctx, mm), side.src) for mm in row] for row in msgs])))
    (_, jmat), (msgs, mat) = mats
    buf = refcompat.export_ciphertext_matrix(mat)
    assert buf == jrefcompat.export_ciphertext_matrix(jmat)
    back = refcompat.import_ciphertext_matrix(buf, t.dev)
    assert (back.num_rows(), back.num_cols()) == (2, 3)
    for r in range(2):
        for c in range(3):
            assert back.at(r, c).to_python_parts() == \
                mat.at(r, c).to_python_parts()
            assert list(t.sk.decrypt(back.at(r, c)).message) == \
                list(msgs[r][c] % t.ctx.p)


def test_keyswitch_interop(ctxs, ref_chain):
    """keyswitch matrix export -> import -> use (FHE-SI.cpp:270-276): the
    same bytes from both packages; the re-imported matrix gives the same
    relinearization as the original."""
    j, t = _pair(ctxs, 13)
    rc = _ref(t.ctx, ref_chain)
    buf = refcompat.export_keyswitch(t.ksw, rc)
    assert buf == jrefcompat.export_keyswitch(j.ksw, _jref(j.ctx, ref_chain))
    ksw2 = refcompat.import_keyswitch(buf, rc, t.dev)
    assert torch.equal(ksw2.matrix_evals, t.ksw.matrix_evals)
    m1 = t.src.uniform_mod_p(t.ctx.phim, t.ctx.p)
    c1 = t.pk.encrypt(scheme.Plaintext(t.ctx, m1), t.src)
    tens = t.ct * c1
    out_a, out_b = t.ksw.apply(tens), ksw2.apply(tens)
    assert out_a.to_python_parts() == out_b.to_python_parts()
    assert list(t.sk.decrypt(out_b).message) == list(
        oracle.plaintext_mul(t.ctx, t.msg, m1))
