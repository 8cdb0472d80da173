"""Every scheme operation of the port against fhe_si_tpu's on one draw of
randomness at m = 32, p = 97, narrow lane: the adds (ragged widths and
unpaired tails included), scalar and constant multiplies, automorph and
rotation, and the batched helpers of the apps.  Each result's tensors
equal JAX's, and its decrypt equals the plaintext computation.
test_torch_scheme_ops_wide.py runs the same cases on the wide lane, and
test_torch_scheme_ops_dense.py on a dense-family ring (m = 22)."""
import numpy as np
import pytest
import torch

from fhe_si_tpu import sampling
from fhe_si_tpu import scheme as jscheme
from fhe_si_tpu.context import FheContext as RefContext
from fhe_si_tpu.hostmath import oracle
from fhe_si_tpu_torch import DeviceContext, FheContext, scheme

torch.set_num_threads(1)

SEED = 11


class Side:
    """One package's keys and four ciphertexts, drawn from RandomSource
    (SEED) in the same order on both sides."""

    def __init__(self, sch, ctx, dev):
        src = sampling.RandomSource(SEED)
        self.scheme, self.ctx = sch, ctx
        self.sk, pk = sch.keygen(dev, src)
        self.ksw = sch.KeySwitch.for_relinearization(self.sk, src)
        self.g = ctx.generator
        self.ginv = pow(self.g, -1, ctx.m)     # (c >> g) >> ginv: key s again
        self.aksw = sch.KeySwitch.for_automorph(self.sk, self.g, src)
        self.msgs = [src.uniform_mod_p(ctx.phim, ctx.p) for _ in range(4)]
        self.c = pk.encrypt_batch([sch.Plaintext(ctx, m) for m in self.msgs],
                                  src)
        self.pt = sch.Plaintext(ctx, src.uniform_mod_p(ctx.phim, ctx.p))

    def wide(self, i):
        """c[i] mapped by X -> X^g and back: under the key s again, at a
        limb width above n_ct (an unreduced automorph output)."""
        return (self.c[i] >> self.g) >> self.ginv

    def view3(self, a, b):
        """The ScaleDown'd product of c[a] and c[b]: 3 parts, unrelinearized."""
        return (self.c[a] * self.c[b]).relinearized_view()


def make_world(prime_bits=None, ring=(32, 80, 97, 3)):
    """Both packages' Sides on ring (m, log_q, p, generator): m = 32 rides
    the Cooley-Tukey family, a ring like (22, 80, 23, 7) the dense one."""
    m, log_q, p, g = ring
    kw = dict(m=m, log_q=log_q, p=p, generator=g, prime_bits=prime_bits)
    ref, ctx = RefContext(**kw), FheContext(**kw)
    assert ctx.wide == (prime_bits is not None)
    return (Side(jscheme, ref, ref),
            Side(scheme, ctx, DeviceContext(ctx, "cpu")))


@pytest.fixture(scope="module")
def world():
    return make_world()


def _msg(S, i):
    return scheme.Plaintext(S.ctx, S.msgs[i])


def _auto(S, pt):
    return pt.automorph(S.g)


def _times(pt, s: int):
    return scheme.Plaintext(pt.ctx, s * pt.message)


# name -> (the op on one side, the expected plaintexts or None[, key]).
# A None expectation holds the tensors equal only (states no key can
# decrypt).  key "auto" decrypts with s(X^g), the key of c >> g.
CASES = {
    "add": (lambda S: [S.c[0] + S.c[1]],
            lambda S, P: [P(0) + P(1)]),
    "add_ragged_width": (lambda S: [S.wide(0) + S.c[1]],
                         lambda S, P: [P(0) + P(1)]),
    "add_unpaired_tail": (lambda S: [S.view3(0, 1) + S.c[2]],
                          lambda S, P: [P(0) * P(1) + P(2)]),
    "add_tensored": (lambda S: [S.c[0] * S.c[1] + S.c[2] * S.c[3]],
                     lambda S, P: [P(0) * P(1) + P(2) * P(3)]),
    "add_tensored_tail": (lambda S: [S.c[0] * S.c[1] + S.view3(0, 1) * S.c[2]],
                          None),
    "add_const": (lambda S: [S.c[0] + S.pt],
                  lambda S, P: [P(0) + S.pt]),
    "add_const_wide_parts": (lambda S: [S.wide(0) + S.pt],
                             lambda S, P: [P(0) + S.pt]),
    # the tensored state sits at scale q^2/p: the constant the reference
    # adds there is scaled for parts, so no plaintext identity holds
    "add_const_tensored": (lambda S: [S.c[0] * S.c[1] + S.pt], None),
    "mul_scalar_pos": (lambda S: [S.c[0] * 5],
                       lambda S, P: [_times(P(0), 5)]),
    "mul_scalar_neg": (lambda S: [S.c[1] * -2],
                       lambda S, P: [_times(P(1), -2)]),
    "mul_scalar_tensored": (lambda S: [(S.c[0] * S.c[1]) * -1],
                            lambda S, P: [_times(P(0) * P(1), -1)]),
    "mul_const": (lambda S: [S.c[0] * S.pt],
                  lambda S, P: [P(0) * S.pt]),
    "mul_const_wide_parts": (lambda S: [S.wide(0) * S.pt],
                             lambda S, P: [P(0) * S.pt]),
    "mul_const_tensored": (lambda S: [(S.c[0] * S.c[1]) * S.pt],
                           lambda S, P: [P(0) * P(1) * S.pt]),
    "automorph": (lambda S: [S.c[0] >> S.g],
                  lambda S, P: [_auto(S, P(0))], "auto"),
    "automorph_wide_parts": (lambda S: [S.wide(0)],
                             lambda S, P: [P(0)]),
    "automorph_tensored": (lambda S: [(S.c[0] * S.c[1]) >> S.g], None),
    "rotate": (lambda S: [S.aksw.apply(S.c[0] >> S.g)],
               lambda S, P: [P(0).rotate(1)]),
    "rotate_reduce_stage": (
        lambda S: S.scheme.sum_batch_only(S.c[:2], [(S.g, S.aksw)]),
        lambda S, P: [P(i) + _auto(S, P(i)) for i in range(2)]),
    "keyswitch_sum_batch_parts": (
        lambda S: S.scheme.keyswitch_sum_batch(
            [S.view3(0, 1), S.view3(2, 3)], S.ksw, [(S.g, S.aksw)]),
        lambda S, P: [x + _auto(S, x) for x in (P(0) * P(1), P(2) * P(3))]),
    "keyswitch_sum_batch_tensored": (
        lambda S: S.scheme.keyswitch_sum_batch(
            [S.c[0] * S.c[1], S.c[2] * S.c[3]], S.ksw, [(S.g, S.aksw)]),
        lambda S, P: [x + _auto(S, x) for x in (P(0) * P(1), P(2) * P(3))]),
    "combine_signed_batch": (
        lambda S: S.scheme.relin_batch(S.scheme.combine_signed_batch(
            S.scheme.mul_batch([(S.c[0], S.c[1]), (S.c[2], S.c[3]),
                                (S.c[0], S.c[2]), (S.c[1], S.c[3])]),
            [1, -1, -1, 1], 2), S.ksw),
        lambda S, P: [P(0) * P(1) - P(2) * P(3),
                      P(1) * P(3) - P(0) * P(2)]),
    "scalar_mul_batch": (
        lambda S: S.scheme.scalar_mul_batch(S.c[:3], [3, -1, 1]),
        lambda S, P: [_times(P(i), s) for i, s in enumerate((3, -1, 1))]),
}


def _state(ct):
    t = ct.tprod if ct.scaled_up else ct.parts
    return ct.scaled_up, np.asarray(t.numpy() if isinstance(t, torch.Tensor)
                                    else t)


@pytest.mark.parametrize("case", list(CASES))
def test_op_equals_jax_and_plaintext(world, case):
    J, T = world
    op, want, *key = CASES[case]
    got_j, got_t = op(J), op(T)
    assert len(got_j) == len(got_t)
    for cj, ct in zip(got_j, got_t):
        (sj, aj), (st, at) = _state(cj), _state(ct)
        assert sj == st and aj.shape == at.shape and at.dtype == np.int32
        assert np.array_equal(aj, at)
    if want is None:
        return
    sk = T.sk
    if key == ["auto"]:
        dev = sk.dev
        sk = scheme.FheSecretKey(dev, dev.automorph_tensored(
            sk.sk_evals, dev.automorph_perm(T.g)))
    for ct, pt in zip(got_t, want(T, lambda i: _msg(T, i))):
        if ct.scaled_up or ct.num_parts() > 2:
            ct = T.ksw.apply(ct)
        assert np.array_equal(sk.decrypt(ct).message, pt.message)


def test_keys_equal_jax(world):
    J, T = world
    for a, b in ((J.sk.sk_evals, T.sk.sk_evals),
                 (J.ksw.matrix_evals, T.ksw.matrix_evals),
                 (J.aksw.matrix_evals, T.aksw.matrix_evals)):
        assert np.array_equal(np.asarray(a), b.numpy())


def test_batched_scalar_shapes(world):
    """One scalar and one sign per ciphertext: a [B] scalar meets its own
    [2, phim, n] ciphertext, not a broadcast axis."""
    _, T = world
    dev = T.sk.dev
    parts = torch.stack([c.parts for c in T.c[:3]])
    out = dev.mul_scalar(parts, [2, 3, 4], [False, True, False])
    for i, (s, neg) in enumerate(((2, False), (3, True), (4, False))):
        single = dev.mul_scalar(parts[i], s, neg)
        assert torch.equal(out[i], single)


def run_scheme_parity(ctx: FheContext, seed: int = 77):
    """The port's encrypt / mul+relin / automorph+keyswitch / decrypt
    against hostmath/oracle.py on identical randomness (the circuit of
    tests/test_wide_lane.py run_scheme_parity)."""
    dev = DeviceContext(ctx, "cpu")
    src_d, src_o = sampling.RandomSource(seed), sampling.RandomSource(seed)
    sk_d, pk_d = scheme.keygen(dev, sampling.sample_keygen(
        src_d, ctx.phim, ctx.stdev, ctx.log_q))
    sk_o, pk_o = oracle.keygen(ctx, sampling.sample_keygen(
        src_o, ctx.phim, ctx.stdev, ctx.log_q))

    def enc_pair():
        msg = src_d.uniform_mod_p(ctx.phim, ctx.p)
        src_o.uniform_mod_p(ctx.phim, ctx.p)
        e_d = sampling.sample_encrypt(src_d, ctx.phim, ctx.stdev)
        e_o = sampling.sample_encrypt(src_o, ctx.phim, ctx.stdev)
        return (msg, pk_d.encrypt(scheme.Plaintext(ctx, msg), e_d),
                oracle.encrypt(pk_o, msg, e_o))

    m1, c1_d, c1_o = enc_pair()
    m2, c2_d, c2_o = enc_pair()
    assert c1_d.to_python_parts() == c1_o.parts

    def ksw_rnd(src, k):
        return sampling.sample_keyswitch(src, ctx.phim, ctx.stdev, ctx.log_q,
                                         k, ctx.ndigits)

    ksw_d = scheme.KeySwitch.for_relinearization(sk_d, ksw_rnd(src_d, 3))
    ksw_o = oracle.keyswitch_init_s2(sk_o, ksw_rnd(src_o, 3))
    cm_d = ksw_d.apply(c1_d * c2_d)
    cm_o = oracle.apply_keyswitch(ksw_o, oracle.mul(c1_o, c2_o))
    assert cm_d.to_python_parts() == cm_o.parts
    assert list(sk_d.decrypt(cm_d).message) == list(
        oracle.plaintext_mul(ctx, m1, m2))

    g = ctx.generator
    ka_d = scheme.KeySwitch.for_automorph(sk_d, g, ksw_rnd(src_d, 2))
    ka_o = oracle.keyswitch_init_automorph(sk_o, g, ksw_rnd(src_o, 2))
    assert (c1_d >> g).to_python_parts() == oracle.automorph(c1_o, g).parts
    cr_d = ka_d.apply(c1_d >> g)
    cr_o = oracle.apply_keyswitch(ka_o, oracle.automorph(c1_o, g))
    assert cr_d.to_python_parts() == cr_o.parts
    assert list(sk_d.decrypt(cr_d).message) == list(
        oracle.plaintext_rotate(ctx, m1, 1))


def test_scheme_parity_with_oracle(world):
    run_scheme_parity(world[1].ctx)
