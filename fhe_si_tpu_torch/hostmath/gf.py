"""GF(p)[X] and GF(p^d) arithmetic for extension-field plaintext slots.

The reference factors Phi_m(X) mod p with NTL's SFCanZass
(PlaintextSpace.cpp:28-30) into totalSlots irreducible factors; when
ord_m(p) = d > 1 every factor has degree d and each slot is GF(p^d).
Instead of porting a general Cantor-Zassenhaus, this module exploits the
cyclotomic structure: the irreducible factors of Phi_m over GF(p)
correspond one-to-one to the cosets of H = <p> in (Z/mZ)*, via

    f_S(X) = prod_{t in S} (X - zeta^t)

for a primitive m-th root of unity zeta in GF(p^d).  The product's
coefficients are fixed by the Frobenius x -> x^p (which permutes the
roots within the coset), hence land in the base field — asserted when
computed.  This yields the exact same factor set as SFCanZass,
deterministically.

All polynomials are dense coefficient lists (index = degree) of Python
ints in [0, p); GF(p^d) elements are length-d tuples of ints (coefficient
vectors over a fixed irreducible modulus h).  Everything here is
setup-time host math; no device code depends on it.
"""
from __future__ import annotations

import math

from . import numbth


# ----------------------------------------------------------- GF(p)[X] basics
def trim(a: list[int]) -> list[int]:
    while a and a[-1] == 0:
        a.pop()
    return a


def pmul(a: list[int], b: list[int], p: int) -> list[int]:
    if not a or not b:
        return []
    out = [0] * (len(a) + len(b) - 1)
    for i, ai in enumerate(a):
        if ai:
            for j, bj in enumerate(b):
                out[i + j] = (out[i + j] + ai * bj) % p
    return trim(out)


def pdivmod(num: list[int], den: list[int], p: int) -> tuple[list[int], list[int]]:
    """Quotient and remainder in GF(p)[X] (den nonzero)."""
    num = [int(c) % p for c in num]
    den = trim([int(c) % p for c in den])
    dd = len(den) - 1
    inv_lead = numbth.modinv(den[-1], p)
    if len(num) - 1 < dd:
        return [], trim(num)
    out = [0] * (len(num) - dd)
    for i in range(len(num) - 1, dd - 1, -1):
        q = num[i] * inv_lead % p
        out[i - dd] = q
        if q:
            for j, dj in enumerate(den):
                num[i - dd + j] = (num[i - dd + j] - q * dj) % p
    return trim(out), trim(num[:dd])


def pmod(a: list[int], f: list[int], p: int) -> list[int]:
    return pdivmod(a, f, p)[1]


def pinv_mod(a: list[int], f: list[int], p: int) -> list[int]:
    """Inverse of a modulo f in GF(p)[X] (extended Euclid; the InvMod of
    PlaintextSpace.cpp:48)."""
    r0, r1 = trim([c % p for c in f]), pmod(a, f, p)
    s0, s1 = [], [1]
    while r1:
        q, r = pdivmod(r0, r1, p)
        r0, r1 = r1, r
        qs = pmul(q, s1, p)
        s_new = [(x - y) % p for x, y in
                 zip(s0 + [0] * max(0, len(qs) - len(s0)),
                     qs + [0] * max(0, len(s0) - len(qs)))]
        s0, s1 = s1, trim(s_new)
    if len(r0) != 1:
        raise ValueError("element not invertible modulo f")
    c = numbth.modinv(r0[0], p)
    return [x * c % p for x in s0]


def ppow_mod(base: list[int], e: int, f: list[int], p: int) -> list[int]:
    """base^e mod f in GF(p)[X] by square-and-multiply."""
    result = [1]
    b = pmod(base, f, p)
    while e:
        if e & 1:
            result = pmod(pmul(result, b, p), f, p)
        b = pmod(pmul(b, b, p), f, p)
        e >>= 1
    return result


def pgcd(a: list[int], b: list[int], p: int) -> list[int]:
    a, b = trim([c % p for c in a]), trim([c % p for c in b])
    while b:
        a, b = b, pmod(a, b, p)
    return a


def is_irreducible(h: list[int], p: int) -> bool:
    """Rabin irreducibility test for monic h of degree d over GF(p):
    X^(p^d) = X mod h, and gcd(X^(p^(d/r)) - X, h) = 1 for prime r | d."""
    d = len(h) - 1
    if d == 1:
        return True

    def x_pow_minus_x(e: int) -> list[int]:
        t = ppow_mod([0, 1], e, h, p)
        t = list(t) + [0] * max(0, 2 - len(t))
        t[1] = (t[1] - 1) % p
        return trim(t)

    for r in numbth.factorize(d):
        if len(pgcd(x_pow_minus_x(p ** (d // r)), h, p)) != 1:
            return False
    return not x_pow_minus_x(p ** d)


def find_irreducible(p: int, d: int) -> list[int]:
    """Smallest (in coefficient-counter order) monic irreducible of degree
    d over GF(p) — deterministic, so contexts rebuild identically."""
    if d == 1:
        return [0, 1]
    counter = 0
    while True:
        lo, c = [], counter
        for _ in range(d):
            lo.append(c % p)
            c //= p
        if c:
            raise ValueError(f"no irreducible of degree {d} over GF({p})??")
        h = lo + [1]
        if is_irreducible(h, p):
            return h
        counter += 1


# ------------------------------------------------------------------- GF(p^d)
class GFExt:
    """GF(p^d) = GF(p)[Y]/(h); elements are length-d tuples of ints."""

    def __init__(self, p: int, d: int, h: list[int] | None = None):
        self.p = p
        self.d = d
        self.h = h if h is not None else find_irreducible(p, d)
        assert len(self.h) == d + 1
        self.order = p ** d
        # reduction rows: Y^(d+r) mod h for r in [0, d)
        rows = []
        cur = [(-c) % p for c in self.h[:d]]      # Y^d mod h
        for _ in range(d):
            rows.append(list(cur))
            top = cur[d - 1]
            cur = [0] + cur[:d - 1]
            if top:
                cur = [(a + top * b) % p for a, b in zip(cur, rows[0])]
        self._red = rows
        self.zero = (0,) * d
        self.one = tuple([1] + [0] * (d - 1))

    def add(self, a, b):
        p = self.p
        return tuple((x + y) % p for x, y in zip(a, b))

    def sub(self, a, b):
        p = self.p
        return tuple((x - y) % p for x, y in zip(a, b))

    def mul(self, a, b):
        p, d = self.p, self.d
        conv = [0] * (2 * d - 1)
        for i, ai in enumerate(a):
            if ai:
                for j, bj in enumerate(b):
                    conv[i + j] += ai * bj
        out = conv[:d]
        for r in range(d - 1):
            c = conv[d + r]
            if c:
                row = self._red[r]
                for k in range(d):
                    out[k] += c * row[k]
        return tuple(x % p for x in out)

    def pow(self, a, e: int):
        result = self.one
        b = a
        while e:
            if e & 1:
                result = self.mul(result, b)
            b = self.mul(b, b)
            e >>= 1
        return result

    def element_of_order(self, m: int):
        """Deterministic element of exact order m (requires m | p^d - 1).
        Candidates enumerate Y + c, then higher-degree patterns."""
        if (self.order - 1) % m:
            raise ValueError(f"no order-{m} element in GF({self.p}^{self.d})")
        exp = (self.order - 1) // m
        prime_facs = numbth.factorize(m)
        counter = 1
        while counter < self.order:
            c, digs = counter, []
            for _ in range(self.d):
                digs.append(c % self.p)
                c //= self.p
            counter += 1
            cand = tuple(digs)
            r = self.pow(cand, exp)
            if r == self.one:
                continue
            if all(self.pow(r, m // f) != self.one for f in prime_facs):
                return r
        raise ValueError("no element of the requested order found")


# -------------------------------------------------- cyclotomic slot factors
def multiplicative_order(p: int, m: int) -> int:
    """ord_m(p): the slot degree d of PlaintextSpace (gcd(p, m) = 1)."""
    if math.gcd(p, m) != 1:
        raise ValueError(f"p={p} and m={m} are not coprime")
    t, d = p % m, 1
    while t != 1:
        t = t * p % m
        d += 1
    return d


def cyclotomic_slot_factors(m: int, p: int, g: int
                            ) -> tuple[int, list[int], list[list[int]]]:
    """Irreducible factors of Phi_m mod p in g-coset slot order.

    Returns (d, slot_exponents, factors):
      d               = ord_m(p), the common factor degree;
      slot_exponents  = [g^j mod m for j in range(S)], S = phi(m)/d —
                        slot j's factor has roots {zeta^(g^j * p^i)};
      factors[j]      = monic degree-d coefficient list mod p.

    Matches the factor set of SFCanZass (PlaintextSpace.cpp:28-30); the
    g-cycle order gives automorph-by-g = cyclic slot shift, the property
    the reference establishes with FindSlots/ReorderSlots
    (PlaintextSpace.cpp:69-110).  Raises if the powers of g do not
    enumerate the cosets of <p> (the reference asserts the same,
    PlaintextSpace.cpp:104).
    """
    d = multiplicative_order(p, m)
    phim = numbth.euler_phi(m)
    S = phim // d
    # cosets of H = <p> in (Z/mZ)*, keyed by their minimum element
    H = []
    t = 1
    for _ in range(d):
        H.append(t)
        t = t * p % m
    seen: set[int] = set()
    slot_exps: list[int] = []
    cosets: list[list[int]] = []
    t = 1
    for _ in range(S):
        if t in seen:
            raise ValueError(
                f"generator {g} does not enumerate the cosets of <{p}> in "
                f"(Z/{m}Z)*: slot cycle repeats after {len(slot_exps)} of {S}")
        coset = [t * h % m for h in H]
        seen.update(coset)
        slot_exps.append(t)
        cosets.append(coset)
        t = t * g % m
    if len(seen) != phim:
        raise ValueError("coset enumeration did not cover (Z/mZ)*")

    gf = GFExt(p, d)
    zeta = gf.element_of_order(m)
    zeta_pow = {0: gf.one}
    acc = gf.one
    for i in range(1, m):
        acc = gf.mul(acc, zeta)
        zeta_pow[i] = acc

    factors: list[list[int]] = []
    for coset in cosets:
        # f = prod_{t in coset} (X - zeta^t), coefficients in GF(p^d)
        f = [gf.one]
        for t in coset:
            root = zeta_pow[t]
            nxt = [gf.zero] * (len(f) + 1)
            for i, ci in enumerate(f):
                nxt[i + 1] = gf.add(nxt[i + 1], ci)
                nxt[i] = gf.sub(nxt[i], gf.mul(ci, root))
            f = nxt
        coeffs = []
        for ci in f:
            assert all(c == 0 for c in ci[1:]), \
                "factor coefficient escaped the base field (bad zeta?)"
            coeffs.append(ci[0])
        assert coeffs[-1] == 1 and len(coeffs) == d + 1
        factors.append(coeffs)
    return d, slot_exps, factors
