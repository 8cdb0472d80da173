"""The port on the reference's own rings, against fhe_si_tpu's oracle on
fhe_si_tpu's RandomSource draws, with no tolerance.  Mirrors of the JAX
package's parity suites, which run on dense-family rings:
tests/test_scheme_parity.py (m = 22 and 46, decompSize 2),
tests/test_wide_lane.py:113-133 (the wide lane, decompSize 4 and 5, and
decompSize 4 on the m = 32 Cooley-Tukey ring), tests/test_large_p.py
(24- and 30-bit p) and tests/test_extension_slots.py (m = 31, p = 2,
d = 5)."""
import numpy as np
import pytest
import torch

from fhe_si_tpu import sampling
from fhe_si_tpu.hostmath import numbth, oracle
from fhe_si_tpu_torch import DeviceContext, FheContext, scheme
from fhe_si_tpu_torch.context import limbs_to_int

from test_torch_scheme_ops import run_scheme_parity

torch.set_num_threads(1)


def _parts(ct):
    return ct.to_python_parts()


# ------------------------------------------- tests/test_scheme_parity.py
@pytest.fixture(scope="module", params=[(22, 80, 23, 7), (46, 96, 47, 5)],
                ids=["m22_q80_p23", "m46_q96_p47"])
def setup(request):
    m, log_q, p, g = request.param
    ctx = FheContext(m=m, log_q=log_q, p=p, generator=g)
    dev = DeviceContext(ctx, "cpu")
    assert not ctx.use_ct
    src_d = sampling.RandomSource(1234)
    src_o = sampling.RandomSource(1234)
    kg = sampling.sample_keygen(src_d, ctx.phim, ctx.stdev, ctx.log_q)
    kg_o = sampling.sample_keygen(src_o, ctx.phim, ctx.stdev, ctx.log_q)
    sk_d, pk_d = scheme.keygen(dev, kg)
    sk_o, pk_o = oracle.keygen(ctx, kg_o)
    return ctx, (src_d, src_o), (sk_d, pk_d), (sk_o, pk_o)


def _encrypt_pair(ctx, srcs, keys_d, keys_o, msg):
    src_d, src_o = srcs
    er_d = sampling.sample_encrypt(src_d, ctx.phim, ctx.stdev)
    er_o = sampling.sample_encrypt(src_o, ctx.phim, ctx.stdev)
    c_d = keys_d[1].encrypt(scheme.Plaintext(ctx, msg), er_d)
    c_o = oracle.encrypt(keys_o[1], msg, er_o)
    return c_d, c_o


def _draw(srcs, ctx):
    msg = srcs[0].uniform_mod_p(ctx.phim, ctx.p)
    srcs[1].uniform_mod_p(ctx.phim, ctx.p)
    return msg


def test_keygen_parity(setup):
    ctx, _, (sk_d, pk_d), (sk_o, pk_o) = setup
    pkl = pk_d.pk_limbs.numpy()
    dev_pk = [[limbs_to_int(pkl[i, j]) for j in range(ctx.phim)]
              for i in range(2)]
    assert dev_pk == pk_o.pk


def test_encrypt_decrypt_parity(setup):
    ctx, srcs, kd, ko = setup
    msg = _draw(srcs, ctx)
    c_d, c_o = _encrypt_pair(ctx, srcs, kd, ko, msg)
    assert _parts(c_d) == c_o.parts
    assert list(kd[0].decrypt(c_d).message) == oracle.decrypt(ko[0], c_o)
    assert list(kd[0].decrypt(c_d).message) == list(msg % ctx.p)


def test_homomorphic_ops_parity(setup):
    ctx, srcs, kd, ko = setup
    src_d, src_o = srcs
    m1, m2 = _draw(srcs, ctx), _draw(srcs, ctx)
    c1_d, c1_o = _encrypt_pair(ctx, srcs, kd, ko, m1)
    c2_d, c2_o = _encrypt_pair(ctx, srcs, kd, ko, m2)

    assert _parts(c1_d + c2_d) == oracle.add(c1_o, c2_o).parts

    kr_d = sampling.sample_keyswitch(src_d, ctx.phim, ctx.stdev, ctx.log_q, 3,
                                     ctx.ndigits)
    kr_o = sampling.sample_keyswitch(src_o, ctx.phim, ctx.stdev, ctx.log_q, 3,
                                     ctx.ndigits)
    ksw_d = scheme.KeySwitch.for_relinearization(kd[0], kr_d)
    ksw_o = oracle.keyswitch_init_s2(ko[0], kr_o)
    cm_d = ksw_d.apply(c1_d * c2_d)
    cm_o = oracle.apply_keyswitch(ksw_o, oracle.mul(c1_o, c2_o))
    assert _parts(cm_d) == cm_o.parts
    assert list(kd[0].decrypt(cm_d).message) == list(
        oracle.plaintext_mul(ctx, m1, m2))

    k = ctx.generator
    ar_d = sampling.sample_keyswitch(src_d, ctx.phim, ctx.stdev, ctx.log_q, 2,
                                     ctx.ndigits)
    ar_o = sampling.sample_keyswitch(src_o, ctx.phim, ctx.stdev, ctx.log_q, 2,
                                     ctx.ndigits)
    ka_d = scheme.KeySwitch.for_automorph(kd[0], k, ar_d)
    ka_o = oracle.keyswitch_init_automorph(ko[0], k, ar_o)
    cr_d = ka_d.apply(c1_d >> k)
    cr_o = oracle.apply_keyswitch(ka_o, oracle.automorph(c1_o, k))
    assert _parts(cr_d) == cr_o.parts
    assert list(kd[0].decrypt(cr_d).message) == list(
        oracle.plaintext_rotate(ctx, m1, 1))

    cv = _draw(srcs, ctx)
    pt = scheme.Plaintext(ctx, cv)
    assert _parts(c1_d + pt) == oracle.add_const(c1_o, cv).parts
    assert _parts(c1_d * pt) == oracle.mul_const(c1_o, cv).parts
    assert _parts(c1_d * (-7)) == oracle.mul_scalar(c1_o, -7).parts

    t_d = (c1_d * c2_d) + (c1_d * c1_d)
    t_o = oracle.add(oracle.mul(c1_o, c2_o), oracle.mul(c1_o, c1_o))
    t_d, t_o = t_d * 9, oracle.mul_scalar(t_o, 9)
    t_d, t_o = t_d * pt, oracle.mul_const(t_o, cv)
    t_d, t_o = t_d + pt, oracle.add_const(t_o, cv)
    r_d = ksw_d.apply(t_d)
    r_o = oracle.apply_keyswitch(ksw_o, t_o)
    assert _parts(r_d) == r_o.parts
    assert list(kd[0].decrypt(r_d).message) == oracle.decrypt(ko[0], r_o)


def test_part_limb_widths(setup):
    """n_ct-width parts; automorph outputs stay unreduced and wider;
    width-ragged adds and decrypt_batch stay exact."""
    ctx, srcs, kd, ko = setup
    n_ct = ctx.n_limbs_ct
    c_d, c_o = _encrypt_pair(ctx, srcs, kd, ko, _draw(srcs, ctx))
    assert c_d.parts.shape[-1] == n_ct
    rot_d = c_d.automorph(ctx.generator)
    rot_o = oracle.automorph(c_o, ctx.generator)
    assert rot_d.parts.shape[-1] > n_ct
    assert _parts(rot_d) == rot_o.parts
    s_d = rot_d + c_d
    assert s_d.parts.shape[-1] == n_ct
    assert _parts(s_d) == oracle.add(rot_o, c_o).parts
    cv = _draw(srcs, ctx)
    pa_d = rot_d + scheme.Plaintext(ctx, cv)
    assert pa_d.parts.shape[-1] == rot_d.parts.shape[-1]
    assert _parts(pa_d) == oracle.add_const(rot_o, cv).parts
    singles = [kd[0].decrypt(c_d).message, kd[0].decrypt(rot_d).message]
    batch = kd[0].decrypt_batch([c_d, rot_d])
    assert [list(b.message) for b in batch] == [list(s) for s in singles]


def test_decrypt_rejects_excess_parts(setup):
    ctx, srcs, kd, ko = setup
    c_d, _ = _encrypt_pair(ctx, srcs, kd, ko, _draw(srcs, ctx))
    prod = (c_d * c_d).relinearized_view()
    assert prod.parts.shape[0] == 3
    with pytest.raises(ValueError, match="relinearize first"):
        kd[0].decrypt(prod)
    with pytest.raises(ValueError, match="relinearize first"):
        kd[0].decrypt_batch([prod])


# ------------------------- digit radixes and lanes (test_scheme_parity.py,
# tests/test_wide_lane.py:113-133), and decompSize 4 on a CT ring
@pytest.mark.parametrize("kw,digit_bits,ndigits,wide", [
    (dict(m=22, log_q=80, p=23, generator=7, decomp_size=2), 16, 5, False),
    (dict(m=22, log_q=80, p=23, generator=7, prime_bits=23), 24, 4, True),
    (dict(m=22, log_q=80, p=23, generator=7, decomp_size=4), 32, 3, False),
    (dict(m=22, log_q=96, p=23, generator=7, decomp_size=5, prime_bits=23),
     40, 3, True),
    (dict(m=32, log_q=80, p=97, generator=3, decomp_size=4), 32, 3, False),
], ids=["m22-decomp2", "m22-wide", "m22-decomp4", "m22-decomp5-wide",
        "m32-ct-decomp4"])
def test_digit_radix_parity(kw, digit_bits, ndigits, wide):
    ctx = FheContext(**kw)
    assert (ctx.digit_bits, ctx.ndigits, ctx.wide) == (digit_bits, ndigits,
                                                       wide)
    assert ctx.use_ct == (kw["m"] == 32)
    run_scheme_parity(ctx)


# ------------------------------------------------ tests/test_large_p.py
def _find_p(m: int, near_bits: int) -> int:
    """Largest prime p with m | p-1 below 2^near_bits (d = 1 slots)."""
    p = (1 << near_bits) - 1
    p -= (p - 1) % m
    while not numbth.is_prime(p):
        p -= m
    return p


@pytest.mark.parametrize("m,log_q,bits", [(22, 120, 24), (22, 140, 30)])
def test_scheme_parity_large_p(m, log_q, bits):
    p = _find_p(m, bits)
    assert p.bit_length() == bits and (p - 1) % m == 0
    ctx = FheContext(m=m, log_q=log_q, p=p, generator=7)
    dev = DeviceContext(ctx, "cpu")
    assert ctx.slot_degree == 1

    src_d, src_o = sampling.RandomSource(17), sampling.RandomSource(17)
    sk_d, pk_d = scheme.keygen(dev, sampling.sample_keygen(
        src_d, ctx.phim, ctx.stdev, ctx.log_q))
    sk_o, pk_o = oracle.keygen(ctx, sampling.sample_keygen(
        src_o, ctx.phim, ctx.stdev, ctx.log_q))
    srcs = (src_d, src_o)
    m1, m2 = _draw(srcs, ctx), _draw(srcs, ctx)
    c1_d, c1_o = _encrypt_pair(ctx, srcs, (sk_d, pk_d), (sk_o, pk_o), m1)
    c2_d, c2_o = _encrypt_pair(ctx, srcs, (sk_d, pk_d), (sk_o, pk_o), m2)
    assert _parts(c1_d) == c1_o.parts
    assert list(sk_d.decrypt(c1_d).message) == oracle.decrypt(sk_o, c1_o)
    assert list(sk_d.decrypt(c1_d).message) == list(m1 % ctx.p)
    assert _parts(c1_d + c2_d) == oracle.add(c1_o, c2_o).parts

    kr_d = sampling.sample_keyswitch(src_d, ctx.phim, ctx.stdev, ctx.log_q,
                                     3, ctx.ndigits)
    kr_o = sampling.sample_keyswitch(src_o, ctx.phim, ctx.stdev, ctx.log_q,
                                     3, ctx.ndigits)
    ksw_d = scheme.KeySwitch.for_relinearization(sk_d, kr_d)
    ksw_o = oracle.keyswitch_init_s2(sk_o, kr_o)
    cm_d = ksw_d.apply(c1_d * c2_d)
    cm_o = oracle.apply_keyswitch(ksw_o, oracle.mul(c1_o, c2_o))
    assert _parts(cm_d) == cm_o.parts
    assert list(sk_d.decrypt(cm_d).message) == oracle.decrypt(sk_o, cm_o)
    assert list(sk_d.decrypt(cm_d).message) == list(
        oracle.plaintext_mul(ctx, m1, m2))

    k = ctx.generator
    ar_d = sampling.sample_keyswitch(src_d, ctx.phim, ctx.stdev, ctx.log_q,
                                     2, ctx.ndigits)
    ar_o = sampling.sample_keyswitch(src_o, ctx.phim, ctx.stdev, ctx.log_q,
                                     2, ctx.ndigits)
    ka_d = scheme.KeySwitch.for_automorph(sk_d, k, ar_d)
    ka_o = oracle.keyswitch_init_automorph(sk_o, k, ar_o)
    cr_d = ka_d.apply(c1_d >> k)
    cr_o = oracle.apply_keyswitch(ka_o, oracle.automorph(c1_o, k))
    assert _parts(cr_d) == cr_o.parts
    assert list(sk_d.decrypt(cr_d).message) == list(
        oracle.plaintext_rotate(ctx, m1, 1))

    cv = _draw(srcs, ctx)
    pt = scheme.Plaintext(ctx, cv)
    assert _parts(c1_d + pt) == oracle.add_const(c1_o, cv).parts
    assert _parts(c1_d * pt) == oracle.mul_const(c1_o, cv).parts

    vals = src_d.uniform_mod_p(ctx.usable_slots, ctx.p)
    pt2 = scheme.Plaintext.from_slots(ctx, vals)
    assert list(pt2.decode_slots()[:ctx.usable_slots]) == list(vals % ctx.p)


# ------------------------------------------ tests/test_extension_slots.py
def test_scheme_parity_extension_slots():
    """m = 31, p = 2: d = ord_31(2) = 5, six GF(2^5) slots.  encrypt /
    decrypt, mul+relin and rotation on slot-constant messages."""
    m, p, g, d = 31, 2, 3, 5
    ctx = FheContext(m=m, log_q=80, p=p, generator=g)
    assert ctx.slot_degree == d and not ctx.use_ct
    dev = DeviceContext(ctx, "cpu")
    sd, so = sampling.RandomSource(42), sampling.RandomSource(42)
    sk_d, pk_d = scheme.keygen(dev, sampling.sample_keygen(
        sd, ctx.phim, ctx.stdev, ctx.log_q))
    sk_o, pk_o = oracle.keygen(ctx, sampling.sample_keygen(
        so, ctx.phim, ctx.stdev, ctx.log_q))

    consts1 = sd.uniform_mod_p(ctx.total_slots, p)
    so.uniform_mod_p(ctx.total_slots, p)
    consts2 = sd.uniform_mod_p(ctx.total_slots, p)
    so.uniform_mod_p(ctx.total_slots, p)
    m1 = ctx.embed_in_slots(consts1, only_usable=False)
    m2 = ctx.embed_in_slots(consts2, only_usable=False)

    def enc(msg):
        cd = pk_d.encrypt(scheme.Plaintext(ctx, msg),
                          sampling.sample_encrypt(sd, ctx.phim, ctx.stdev))
        co = oracle.encrypt(pk_o, msg,
                            sampling.sample_encrypt(so, ctx.phim, ctx.stdev))
        return cd, co

    c1d, c1o = enc(m1)
    c2d, c2o = enc(m2)
    assert _parts(c1d) == c1o.parts
    assert list(sk_d.decrypt(c1d).message) == oracle.decrypt(sk_o, c1o) \
        == list(m1)

    kr_d = sampling.sample_keyswitch(sd, ctx.phim, ctx.stdev, ctx.log_q, 3,
                                     ctx.ndigits)
    kr_o = sampling.sample_keyswitch(so, ctx.phim, ctx.stdev, ctx.log_q, 3,
                                     ctx.ndigits)
    ksw_d = scheme.KeySwitch.for_relinearization(sk_d, kr_d)
    ksw_o = oracle.keyswitch_init_s2(sk_o, kr_o)
    cm_d = ksw_d.apply(c1d * c2d)
    cm_o = oracle.apply_keyswitch(ksw_o, oracle.mul(c1o, c2o))
    assert _parts(cm_d) == cm_o.parts
    got = ctx.decode_slots(np.asarray(sk_d.decrypt(cm_d).message))
    assert np.array_equal(got[:, 0], consts1 * consts2 % p)
    assert not got[:, 1:].any()

    ar_d = sampling.sample_keyswitch(sd, ctx.phim, ctx.stdev, ctx.log_q, 2,
                                     ctx.ndigits)
    ar_o = sampling.sample_keyswitch(so, ctx.phim, ctx.stdev, ctx.log_q, 2,
                                     ctx.ndigits)
    ka_d = scheme.KeySwitch.for_automorph(sk_d, g, ar_d)
    ka_o = oracle.keyswitch_init_automorph(sk_o, g, ar_o)
    cr_d = ka_d.apply(c1d >> g)
    cr_o = oracle.apply_keyswitch(ka_o, oracle.automorph(c1o, g))
    assert _parts(cr_d) == cr_o.parts
    dec = ctx.decode_slots(np.asarray(sk_d.decrypt(cr_d).message))
    assert np.array_equal(dec[:, 0], np.roll(consts1, -1))
    assert list(sk_d.decrypt(cr_d).message) == list(
        oracle.plaintext_rotate(ctx, m1, 1))
