"""The port's DoubleCrt / SingleCrt / IndexSet object API against
fhe_si_tpu's on the same inputs, with no tolerance: the 8 tests of
tests/test_doublecrt.py at m = 22, each run through both packages, every
evaluation tensor and every reconstructed polynomial equal, and the
exact Python-int results of the JAX tests on top."""
import numpy as np
import pytest
import torch

from fhe_si_tpu import doublecrt as jdcrt, indexmap as jindexmap
from fhe_si_tpu.context import FheContext as RefContext
from fhe_si_tpu.hostmath import oracle
from fhe_si_tpu.sampling import RandomSource
from fhe_si_tpu_torch import DeviceContext, FheContext
from fhe_si_tpu_torch.doublecrt import DoubleCrt, SingleCrt
from fhe_si_tpu_torch import indexmap as tindexmap
from fhe_si_tpu_torch.indexmap import IndexMap, IndexSet

torch.set_num_threads(1)

KW = dict(m=22, log_q=80, p=23, generator=7)


class Both:
    """One value built through both packages: .j the JAX object, .t the
    port's.  Arithmetic and method calls apply to both and check that
    the evaluation tensors agree."""

    def __init__(self, j, t):
        self.j, self.t = j, t
        assert np.array_equal(np.asarray(j.evals), t.evals.numpy())
        assert sorted(j.index_set) == sorted(t.index_set)

    def __getattr__(self, name):
        fj, ft = getattr(self.j, name), getattr(self.t, name)

        def call(*args):
            rj, rt = fj(*_side(args, 0)), ft(*_side(args, 1))
            if isinstance(rt, DoubleCrt):
                return Both(rj, rt)
            assert rj == rt, name
            return rt
        return call

    def __add__(self, o):
        return Both(self.j + _side([o], 0)[0], self.t + _side([o], 1)[0])

    def __sub__(self, o):
        return Both(self.j - _side([o], 0)[0], self.t - _side([o], 1)[0])

    def __mul__(self, o):
        return Both(self.j * _side([o], 0)[0], self.t * _side([o], 1)[0])


def _side(args, i):
    """Arguments for one package: Both -> its side, IndexSet -> that
    package's IndexSet with the same members."""
    out = []
    for a in args:
        if isinstance(a, Both):
            a = (a.j, a.t)[i]
        elif isinstance(a, IndexSet):
            a = jindexmap.IndexSet.of(a) if i == 0 else a
        out.append(a)
    return out


@pytest.fixture(scope="module")
def world():
    ref, ctx = RefContext(**KW), FheContext(**KW)
    return ref, ctx, DeviceContext(ctx, "cpu")


def from_poly(world, coeffs, index_set=None):
    ref, _, dev = world
    js = None if index_set is None else jindexmap.IndexSet.of(index_set)
    return Both(jdcrt.DoubleCrt.from_poly(ref, coeffs, js),
                DoubleCrt.from_poly(dev, coeffs, index_set))


def test_index_set_algebra():
    """tests/test_doublecrt.py:17, on both packages' IndexSet/IndexMap."""
    for mod in (jindexmap, tindexmap):
        a = mod.IndexSet(0, 4)
        b = mod.IndexSet.of([3, 4, 5, 6])
        assert (a | b).card() == 7
        assert sorted(a & b) == [3, 4]
        assert sorted(a / b) == [0, 1, 2]
        assert sorted(a ^ b) == [0, 1, 2, 5, 6]
        assert a.first() == 0 and a.last() == 4 and a.next(2) == 3
        assert a.next(4) == 5
        assert 3 in a and not a.contains(9)
        assert mod.IndexSet(2, 4) <= a and a >= mod.IndexSet(2, 4)
        im = mod.IndexMap(init=lambda i: i * 10)
        im.insert(mod.IndexSet.of([1, 3]))
        assert im[3] == 30
        assert sorted(im.get_index_set()) == [1, 3]
    im = IndexMap()
    im.insert(2)
    im.remove(IndexSet.of([2]))
    assert im.get_index_set().card() == 0


def test_roundtrip_and_arith(world):
    ref, ctx, dev = world
    rng = np.random.default_rng(0)
    P = ctx.prime_product
    a = [int(v) for v in rng.integers(-2**60, 2**60, ctx.phim)]
    b = [int(v) for v in rng.integers(-2**60, 2**60, ctx.phim)]
    da, db = from_poly(world, a), from_poly(world, b)
    assert da.to_poly() == [oracle.centered_mod(v, P) for v in a]
    assert (da + db).to_poly() == [oracle.centered_mod(x + y, P)
                                   for x, y in zip(a, b)]
    assert (da - db).to_poly() == [oracle.centered_mod(x - y, P)
                                   for x, y in zip(a, b)]
    want = oracle.poly_mod_phim(oracle.poly_mul(
        [oracle.centered_mod(v, P) for v in a],
        [oracle.centered_mod(v, P) for v in b]), ctx.phim_x)
    assert (da * db).to_poly() == [oracle.centered_mod(v, P)
                                   for v in oracle.pad(want, ctx.phim)]
    c = da * 12345
    assert c.to_poly() == [oracle.centered_mod(v * 12345, P) for v in a]
    assert c.div_by_constant(12345).to_poly() == da.to_poly()
    e = from_poly(world, [3] + [0] * (ctx.phim - 1)).exp(5)
    assert e.to_poly()[0] == 243
    const = Both(jdcrt.DoubleCrt.constant(ref, 7), DoubleCrt.constant(dev, 7))
    assert const.to_poly()[0] == 7
    assert da.to_poly(IndexSet(0, 2), True) == da.j.to_poly(
        jindexmap.IndexSet(0, 2), True)


def test_automorph_matches_oracle(world):
    ref, ctx, dev = world
    a = [int(v) for v in np.random.default_rng(1).integers(0, 1000, ctx.phim)]
    got = from_poly(world, a).automorph(ctx.generator).to_poly()
    ct = oracle.OracleCiphertext(ctx, parts=[a])
    assert got == oracle.automorph(ct, ctx.generator).parts[0]


def test_add_primes_and_subsets(world):
    ref, ctx, dev = world
    a = [int(v) for v in np.random.default_rng(2).integers(-2**40, 2**40,
                                                            ctx.phim)]
    da = from_poly(world, a, IndexSet(0, 3))
    assert da.to_poly() == a
    da.add_primes(IndexSet(4, ctx.num_primes - 1))
    da = Both(da.j, da.t)
    assert da.t.index_set.card() == ctx.num_primes
    assert da.to_poly() == a
    db = from_poly(world, a, IndexSet(0, 5))
    assert (da + db).to_poly() == [2 * v for v in a]


def test_add_primes_and_scale(world):
    ref, ctx, dev = world
    a = [5, -3] + [0] * (ctx.phim - 2)
    da = from_poly(world, a, IndexSet(0, 4))
    assert da.add_primes_and_scale(IndexSet(5, ctx.num_primes - 1)) > 0
    da = Both(da.j, da.t)
    poly = da.to_poly()
    assert [c % ctx.p for c in poly] == [c % ctx.p for c in a]
    f = 1
    for i in range(5, ctx.num_primes):
        f *= int(ctx.primes[i])
    assert all(c % f == 0 for c in poly)


def test_scale_down_to_set(world):
    ref, ctx, dev = world
    a = [int(v) for v in np.random.default_rng(3).integers(-2**60, 2**60,
                                                            ctx.phim)]
    da = from_poly(world, a)
    keep = IndexSet(0, ctx.num_primes - 3)
    da.scale_down_to_set(keep)
    da = Both(da.j, da.t)
    assert da.t.index_set == keep
    poly = da.to_poly()
    removed = 1
    for i in range(ctx.num_primes - 2, ctx.num_primes):
        removed *= int(ctx.primes[i])
    for orig, new in zip(a, poly):
        assert new % ctx.p == orig % ctx.p
        assert abs(new) <= abs(orig) * ctx.p / removed + ctx.p


def test_single_crt(world):
    ref, ctx, dev = world
    rng = np.random.default_rng(4)
    a = [int(v) for v in rng.integers(-2**40, 2**40, ctx.phim)]
    b = [int(v) for v in rng.integers(-2**40, 2**40, ctx.phim)]
    sa, sb = SingleCrt.from_poly(dev, a), SingleCrt.from_poly(dev, b)
    ja, jb = (jdcrt.SingleCrt.from_poly(ref, a),
              jdcrt.SingleCrt.from_poly(ref, b))
    for t, j in ((sa + sb, ja + jb), (sa - sb, ja - jb)):
        for l in t.index_set:
            assert np.array_equal(t.map[l], j.map[l])
    assert (sa + sb).to_poly() == [x + y for x, y in zip(a, b)]
    dc = Both(ja.to_double_crt(), sa.to_double_crt())
    assert dc.to_poly() == a
    back, jback = dc.t.to_single_crt(), dc.j.to_single_crt()
    for l in back.index_set:
        q = int(ctx.primes[l])
        assert np.array_equal(back.map[l], jback.map[l])
        assert list(back.map[l]) == [v % q for v in a]


def test_sampling_shapes(world):
    ref, ctx, dev = world
    srcs = (RandomSource(0), RandomSource(0))
    d = Both(jdcrt.DoubleCrt(ref), DoubleCrt(dev))
    for name, args in (("randomize", ()), ("sample_gaussian", ()),
                       ("sample_hwt", (8,)), ("sample_small", ())):
        getattr(d.j, name)(srcs[0], *args)
        getattr(d.t, name)(srcs[1], *args)
        d = Both(d.j, d.t)
        assert d.t.evals.shape == (ctx.num_primes, ctx.phim)
        p = d.to_poly()
        if name == "sample_gaussian":
            assert max(abs(v) for v in p) < 30
        elif name == "sample_hwt":
            assert sum(1 for v in p if v != 0) == 8 and set(p) <= {-1, 0, 1}
        elif name == "sample_small":
            assert set(p) <= {-1, 0, 1}
