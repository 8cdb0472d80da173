"""DoubleCrt / SingleCrt: the reference's polynomial-representation API
(DoubleCRT.h:83-365, SingleCRT.h:41-175) on a DeviceContext.

Counterpart of fhe_si_tpu/doublecrt.py.  The scheme pipelines in
device.py work on raw tensors; this module is the object API for code
ported from the reference, with the index-set machinery (mod-up
`add_primes`, `add_primes_and_scale`, mod-switching `scale_down_to_set`)
that the scheme layer does not need.  Where the JAX package finds its
DeviceContext through the cache `device_context(ctx)`, every object here
takes its DeviceContext explicitly, and with it the torch.device.

Representation: evaluations int32 [card(index_set), phim] on dev.device;
row r is the r-th smallest chain index of the set.  The transforms are
the dense family's operands dev.full['fwd'] / dev.full['inv'] gathered
to the set's rows, as JAX gathers its fwd_chunks / inv_chunks
(doublecrt.py:82-92).  Like JAX's, DoubleCrt therefore runs on
dense-family contexts only: on a Cooley-Tukey context it raises.  The
exact big-integer steps (CRT over an arbitrary subset) run on host
Python ints, as in JAX; they are set-up operations.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .device import DeviceContext
from .hostmath import numbth
from .indexmap import IndexSet
from .ops import modular, ntt
from .sampling import RandomSource


def _rows(s: IndexSet) -> np.ndarray:
    return np.array(sorted(s), dtype=np.int64)


class DoubleCrt:
    def __init__(self, dev: DeviceContext, evals=None,
                 index_set: IndexSet | None = None):
        if dev.use_ct:
            raise NotImplementedError(
                f"DoubleCrt: m={dev.ctx.m} rides the Cooley-Tukey family; "
                "DoubleCrt transforms through the dense tables only, as "
                "fhe_si_tpu's does (doublecrt.py:82-92)")
        self.dev = dev
        self.ctx = dev.ctx
        self.index_set = (index_set if index_set is not None
                          else IndexSet(0, dev.ctx.num_primes - 1))
        if evals is None:
            evals = torch.zeros((self.index_set.card(), dev.ctx.phim),
                                dtype=torch.int32, device=dev.device)
        self.evals = evals

    # ------------------------------------------------------------- helpers
    def _idx(self):
        return torch.as_tensor(_rows(self.index_set), device=self.dev.device)

    def _q(self):
        idx = self._idx()
        return self.dev.q[idx], self.dev.qinv_f[idx]

    def _per_prime(self, values):
        """One int32 per row of the set, as a [rows, 1] device tensor."""
        return torch.as_tensor(np.asarray(values, dtype=np.int32)[:, None],
                               device=self.dev.device)

    def copy(self) -> "DoubleCrt":
        return DoubleCrt(self.dev, self.evals, self.index_set)

    # ------------------------------------------------------- constructors
    @classmethod
    def from_poly(cls, dev: DeviceContext, coeffs,
                  index_set: IndexSet | None = None) -> "DoubleCrt":
        """DoubleCRT(const ZZX&) (DoubleCRT.cpp:212-257): reduce the integer
        coefficients mod each chain prime, then forward NTT."""
        obj = cls(dev, index_set=index_set)
        ctx = dev.ctx
        rows = _rows(obj.index_set)
        res = np.zeros((len(rows), ctx.phim), dtype=np.int64)
        for r, l in enumerate(rows):
            q = int(ctx.primes[l])
            for j, c in enumerate(coeffs[:ctx.phim]):
                res[r, j] = int(c) % q
        obj.evals = obj._ntt_fwd(torch.as_tensor(res.astype(np.int32),
                                                 device=dev.device))
        return obj

    @classmethod
    def constant(cls, dev: DeviceContext, num: int,
                 index_set: IndexSet | None = None) -> "DoubleCrt":
        """operator=(const ZZ&) (DoubleCRT.cpp:333-347)."""
        obj = cls(dev, index_set=index_set)
        vals = [int(num) % int(dev.ctx.primes[l]) for l in _rows(obj.index_set)]
        obj.evals = obj._per_prime(vals).expand(-1, dev.ctx.phim).contiguous()
        return obj

    def _ntt(self, key: str, x):
        """The dense transform dev.full[key] on the set's rows."""
        tab, q = self.dev.full[key], self.dev.q
        if self.index_set.card() < self.ctx.num_primes:
            idx = self._idx()
            tab, q = tuple(t[idx] for t in tab), q[idx]
        return ntt.modmatmul(tab, x, q)

    def _ntt_fwd(self, res):
        return self._ntt('fwd', res)

    def _ntt_inv(self, ev):
        return self._ntt('inv', ev)

    # ------------------------------------------------------------ to poly
    def to_poly(self, index_set: IndexSet | None = None,
                positive: bool = False) -> list[int]:
        """toPoly (DoubleCRT.cpp:349-398): iNTT per prime + exact CRT,
        centered representatives (or positive when requested)."""
        s = self.index_set if index_set is None else (index_set & self.index_set)
        rows_all = _rows(self.index_set)
        keep = [i for i, l in enumerate(rows_all) if l in s]
        if not keep:
            return [0] * self.ctx.phim
        res = self._ntt_inv(self.evals).cpu().numpy()[keep]
        primes = [int(self.ctx.primes[rows_all[i]]) for i in keep]
        P = math.prod(primes)
        out = []
        for j in range(self.ctx.phim):
            x, mod = 0, 1
            for r, q in enumerate(primes):
                # incremental CRT (intVecCRT semantics, NumbTh.cpp:306-338)
                delta = (int(res[r, j]) - x) * numbth.modinv(mod % q, q) % q
                x += mod * delta
                mod *= q
            x %= P
            if x > P // 2:
                x -= P
            if positive and x < 0:
                x += P
            out.append(x)
        return out

    # ---------------------------------------------------------- arithmetic
    def _binop(self, other, fn):
        if isinstance(other, DoubleCrt):
            if self.dev is not other.dev:
                raise ValueError("DoubleCrt op: incompatible contexts")
            # match index sets (Op, DoubleCRT.cpp:79-113)
            me, oth = self, other
            if not (me.index_set >= oth.index_set):
                me = me.copy()
                me.add_primes(oth.index_set / me.index_set)
            if me.index_set > oth.index_set:
                oth = oth.copy()
                oth.add_primes(me.index_set / oth.index_set)
            q, qinv = me._q()
            return DoubleCrt(me.dev, fn(me.evals, oth.evals, q, qinv),
                             me.index_set)
        if isinstance(other, (int, np.integer)):
            n = self._per_prime([int(other) % int(self.ctx.primes[l])
                                 for l in _rows(self.index_set)])
            q, qinv = self._q()
            return DoubleCrt(self.dev, fn(self.evals, n, q, qinv),
                             self.index_set)
        # polynomial with integer coefficients
        rhs = DoubleCrt.from_poly(self.dev, list(other), self.index_set)
        return self._binop(rhs, fn)

    def _mod_mul(self, a, b, q, qinv):
        return modular.mod_mul(a, b, q, qinv, self.dev.wide)

    def __add__(self, other):
        return self._binop(other, lambda a, b, q, i: modular.mod_add(a, b, q))

    def __sub__(self, other):
        return self._binop(other, lambda a, b, q, i: modular.mod_sub(a, b, q))

    def __mul__(self, other):
        return self._binop(other, self._mod_mul)

    def div_by_constant(self, num: int) -> "DoubleCrt":
        """operator/=(const ZZ&) (DoubleCRT.cpp:407-420): multiply by the
        per-prime modular inverse."""
        inv = self._per_prime([
            numbth.modinv(int(num) % int(self.ctx.primes[l]),
                          int(self.ctx.primes[l]))
            for l in _rows(self.index_set)])
        q, qinv = self._q()
        return DoubleCrt(self.dev, self._mod_mul(self.evals, inv, q, qinv),
                         self.index_set)

    def exp(self, e: int) -> "DoubleCrt":
        """Exp (DoubleCRT.cpp:423-434): elementwise PowerMod by
        square-and-multiply over the bits of e."""
        q, qinv = self._q()
        result = torch.ones_like(self.evals)
        base = self.evals
        ee = int(e)
        while ee:
            if ee & 1:
                result = self._mod_mul(result, base, q, qinv)
            ee >>= 1
            if ee:
                base = self._mod_mul(base, base, q, qinv)
        return DoubleCrt(self.dev, result, self.index_set)

    def automorph(self, k: int) -> "DoubleCrt":
        """automorph (DoubleCRT.cpp:439-465): slot permutation."""
        return DoubleCrt(self.dev, torch.index_select(
            self.evals, -1, self.dev.automorph_perm(k)), self.index_set)

    # -------------------------------------------------------- index juggling
    def add_primes(self, s1: IndexSet):
        """addPrimes mod-up (DoubleCRT.cpp:142-156): reconstruct the poly,
        fill new rows with its residues."""
        if s1.card() == 0:
            return
        assert s1.is_disjoint(self.index_set)
        poly = self.to_poly()
        new_set = self.index_set | s1
        merged = DoubleCrt.from_poly(self.dev, poly, new_set)
        self.index_set = new_set
        self.evals = merged.evals

    def add_primes_and_scale(self, s1: IndexSet) -> float:
        """addPrimesAndScale (DoubleCRT.cpp:162-208): scale existing rows by
        factor = prod(q_new) * (prod(q_new)^{-1} mod p), zero-fill new rows."""
        if s1.card() == 0:
            return 0.0
        assert s1.is_disjoint(self.index_set)
        p = self.ctx.p
        factor = 1
        log_factor = 0.0
        for i in s1:
            qi = int(self.ctx.primes[i])
            factor *= qi
            log_factor += math.log(qi)
        prod_inv = numbth.modinv(factor % p, p)
        factor *= prod_inv
        log_factor += math.log(prod_inv)
        scaled = self * factor  # per-prime scalar multiply on current rows
        new_set = self.index_set | s1
        rows_new = _rows(new_set)
        old = torch.as_tensor(np.isin(rows_new, _rows(self.index_set)),
                              device=self.dev.device)
        out = torch.zeros((len(rows_new), self.ctx.phim), dtype=torch.int32,
                          device=self.dev.device)
        out[old] = scaled.evals
        self.index_set = new_set
        self.evals = out
        return log_factor

    def remove_primes(self, s1: IndexSet):
        keep = [i for i, l in enumerate(_rows(self.index_set)) if l not in s1]
        self.index_set = self.index_set / s1
        self.evals = self.evals[torch.as_tensor(keep, dtype=torch.long,
                                                device=self.dev.device)]

    def scale_down_to_set(self, s: IndexSet):
        """scaleDownToSet true mod-switching (DoubleCRT.cpp:518-558):
        multiply by (diffProd mod p), add the p-divisible correction delta,
        divide by diffProd."""
        intersect = s & self.index_set
        diff = self.index_set / s
        assert intersect.card() > 0 and diff.card() > 0
        p = self.ctx.p
        diff_prod = 1
        for i in diff:
            diff_prod *= int(self.ctx.primes[i])
        scaled = self * (diff_prod % p)
        delta = scaled.to_poly(diff)
        factor = diff_prod * numbth.modinv(diff_prod % p, p)
        mod = diff_prod * p
        new_delta = []
        for c in delta:
            d = c * factor - c
            d %= mod
            if d > mod // 2:
                d -= mod
            new_delta.append(d)
        scaled.remove_primes(diff)
        scaled = scaled + new_delta
        result = scaled.div_by_constant(diff_prod)
        self.index_set = result.index_set
        self.evals = result.evals

    # -------------------------------------------------------------- sampling
    def randomize(self, source: RandomSource):
        """randomize (DoubleCRT.cpp:468-481): uniform residues mod each prime."""
        res = np.stack([source.uniform_mod_p(self.ctx.phim, int(self.ctx.primes[l]))
                        for l in _rows(self.index_set)])
        self.evals = torch.as_tensor(res.astype(np.int32),
                                     device=self.dev.device)

    def sample_gaussian(self, source: RandomSource, stdev: float | None = None):
        e = source.gaussian_poly(self.ctx.phim, stdev or self.ctx.stdev)
        self.evals = DoubleCrt.from_poly(self.dev, list(e), self.index_set).evals

    def sample_hwt(self, source: RandomSource, hwt: int = 64):
        e = source.hwt_poly(self.ctx.phim, hwt)
        self.evals = DoubleCrt.from_poly(self.dev, list(e), self.index_set).evals

    def sample_small(self, source: RandomSource):
        """sampleSmall (NumbTh.cpp:361-375): coeffs in {-1,0,1}, P(0)=1/2."""
        u = source.rng.integers(0, 4, self.ctx.phim)
        e = np.where(u & 1, (u & 2) - 1, 0)
        self.evals = DoubleCrt.from_poly(self.dev, list(e), self.index_set).evals

    # --------------------------------------------------------------- convert
    def to_single_crt(self, index_set: IndexSet | None = None) -> "SingleCrt":
        s = self.index_set if index_set is None else (index_set & self.index_set)
        rows_all = list(_rows(self.index_set))
        res = self._ntt_inv(self.evals).cpu().numpy()
        out = SingleCrt(self.dev, index_set=s)
        for l in s:
            out.map[l] = res[rows_all.index(l)].copy()
        return out

    def __eq__(self, other):
        return (isinstance(other, DoubleCrt) and self.dev is other.dev
                and self.index_set == other.index_set
                and torch.equal(self.evals, other.evals))

    def __repr__(self):
        return f"DoubleCrt(primes={sorted(self.index_set)}, phim={self.ctx.phim})"


class SingleCrt:
    """Per-prime coefficient-domain residues (SingleCRT.h:41-175), held on
    the host as int64 numpy rows."""

    def __init__(self, dev: DeviceContext, index_set: IndexSet | None = None):
        self.dev = dev
        self.ctx = dev.ctx
        self.index_set = (index_set if index_set is not None
                          else IndexSet(0, dev.ctx.num_primes - 1))
        self.map: dict[int, np.ndarray] = {
            l: np.zeros(dev.ctx.phim, dtype=np.int64) for l in self.index_set}

    @classmethod
    def from_poly(cls, dev: DeviceContext, coeffs,
                  index_set: IndexSet | None = None) -> "SingleCrt":
        obj = cls(dev, index_set)
        phim = dev.ctx.phim
        for l in obj.index_set:
            q = int(dev.ctx.primes[l])
            obj.map[l] = np.array([int(c) % q for c in coeffs[:phim]]
                                  + [0] * max(0, phim - len(coeffs)),
                                  dtype=np.int64)
        return obj

    def to_poly(self) -> list[int]:
        return self.to_double_crt().to_poly()

    def to_double_crt(self) -> DoubleCrt:
        obj = DoubleCrt(self.dev, index_set=self.index_set)
        res = np.stack([self.map[l] for l in _rows(self.index_set)])
        obj.evals = obj._ntt_fwd(torch.as_tensor(res.astype(np.int32),
                                                 device=self.dev.device))
        return obj

    def __add__(self, other: "SingleCrt") -> "SingleCrt":
        out = SingleCrt(self.dev, self.index_set)
        for l in self.index_set:
            q = int(self.ctx.primes[l])
            out.map[l] = (self.map[l] + other.map[l]) % q
        return out

    def __sub__(self, other: "SingleCrt") -> "SingleCrt":
        out = SingleCrt(self.dev, self.index_set)
        for l in self.index_set:
            q = int(self.ctx.primes[l])
            out.map[l] = (self.map[l] - other.map[l]) % q
        return out
