"""Exact number theory on the host (pure Python ints).

TPU-native replacement for the reference's NTL-backed NumbTh layer
(reference: NumbTh.cpp).  All of this runs once at context-setup time;
Python ints are arbitrary precision, so no GMP/NTL is needed.

Covered reference API (cited as file:line into the C++ fhe-si sources):
  - factorize            NumbTh.cpp:26-51
  - phi / euler_phi      NumbTh.cpp:53-82
  - mobius               NumbTh.cpp:123-137
  - cyclotomic           NumbTh.cpp:141-158 (Mobius product formula)
  - find_element_of_order  (FindPrimitiveRoot, NumbTh.cpp:85-121 — made
    deterministic here: smallest base wins, so contexts are reproducible)
  - modular inverse, probabilistic primality (NTL ProbPrime analog)
"""
from __future__ import annotations

import math
from functools import lru_cache


def is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 3.3e24 (covers all our uses)."""
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    d = n - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        x = pow(a, d, n)
        if x == 1 or x == n - 1:
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def factorize(n: int) -> list[int]:
    """Distinct prime factors of n, ascending (reference NumbTh.cpp:26-51)."""
    factors = []
    if n < 2:
        return factors
    d = 2
    while d * d <= n:
        if n % d == 0:
            factors.append(d)
            while n % d == 0:
                n //= d
        d += 1 if d == 2 else 2
    if n > 1:
        factors.append(n)
    return factors


def euler_phi(n: int) -> int:
    """Euler totient (reference phi_N, NumbTh.cpp:69-82)."""
    result = n
    for p in factorize(n):
        result -= result // p
    return result


def mobius(n: int) -> int:
    """Mobius function (reference NumbTh.cpp:123-137)."""
    arity = 0
    d = 2
    while d * d <= n:
        if n % d == 0:
            n //= d
            if n % d == 0:
                return 0
            arity ^= 1
        d += 1 if d == 2 else 2
    if n > 1:
        arity ^= 1
    return 1 if arity == 0 else -1


# ---------------------------------------------------------------- polynomials
# Dense integer polynomials as Python lists, index = degree.

def poly_trim(a: list[int]) -> list[int]:
    while a and a[-1] == 0:
        a.pop()
    return a


def poly_mul(a: list[int], b: list[int]) -> list[int]:
    if not a or not b:
        return []
    out = [0] * (len(a) + len(b) - 1)
    for i, ai in enumerate(a):
        if ai:
            for j, bj in enumerate(b):
                out[i + j] += ai * bj
    return poly_trim(out)


def poly_divmod_exact(num: list[int], den: list[int]) -> list[int]:
    """Exact division of integer polynomials (remainder must be zero)."""
    num = list(num)
    dd = len(den) - 1
    lead = den[-1]
    out = [0] * (len(num) - dd)
    for i in range(len(num) - 1, dd - 1, -1):
        c = num[i]
        if c % lead != 0:
            raise ValueError("non-exact polynomial division")
        q = c // lead
        out[i - dd] = q
        if q:
            for j, dj in enumerate(den):
                num[i - dd + j] -= q * dj
    if any(num[:dd]):
        raise ValueError("non-zero remainder in exact division")
    return poly_trim(out)


@lru_cache(maxsize=None)
def cyclotomic(m: int) -> tuple[int, ...]:
    """Coefficients of the m-th cyclotomic polynomial Phi_m(X).

    Mobius product formula, mirroring reference Cyclotomic
    (NumbTh.cpp:141-158): Phi_m = prod_{d|m} (X^{m/d}-1)^{mu(d)}.
    """
    num: list[int] = [1]
    den: list[int] = [1]
    for d in range(1, m + 1):
        if m % d == 0:
            g = [0] * (m // d + 1)
            g[0], g[-1] = -1, 1
            mu = mobius(d)
            if mu == 1:
                num = poly_mul(num, g)
            elif mu == -1:
                den = poly_mul(den, g)
    return tuple(poly_divmod_exact(num, den))


def modinv(a: int, m: int) -> int:
    return pow(a % m, -1, m)


def find_element_of_order(q: int, e: int) -> int:
    """Smallest-base element of exact multiplicative order e mod prime q.

    Deterministic replacement for the reference's randomized
    FindPrimitiveRoot (NumbTh.cpp:85-121): tries bases 2,3,4,... and
    returns base^((q-1)/e) once that power has exact order e.  Requires
    e | q-1.
    """
    if (q - 1) % e != 0:
        raise ValueError(f"no order-{e} element mod {q}: e does not divide q-1")
    exp = (q - 1) // e
    prime_facs = factorize(e)
    for base in range(2, q):
        root = pow(base, exp, q)
        if root == 1:
            continue
        if all(pow(root, e // f, q) != 1 for f in prime_facs):
            return root
    raise ValueError(f"no order-{e} element found mod {q}")


def multiplicative_order(g: int, m: int) -> int:
    """Order of g in (Z/mZ)* (g coprime to m): smallest divisor e of
    phi(m) with g^e = 1, found by peeling prime factors off phi(m)."""
    if math.gcd(g, m) != 1:
        raise ValueError(f"{g} is not a unit mod {m}")
    e = euler_phi(m)
    for f in factorize(e):
        while e % f == 0 and pow(g, e // f, m) == 1:
            e //= f
    return e


def is_cyclic_group(m: int) -> bool:
    """True iff (Z/mZ)* is cyclic: m in {1, 2, 4, p^k, 2*p^k}, p odd."""
    if m <= 4:
        return True
    if m % 4 == 0:
        return False
    odd = m if m % 2 else m // 2
    return len(factorize(odd)) == 1


def find_group_generator(m: int) -> int:
    """Smallest generator of (Z/mZ)*, when cyclic (m = 1,2,4,p^k,2p^k).

    Convenience for choosing the `generator` context parameter (the
    reference leaves this to the user; README:36-37 requires g to
    generate Z/(p-1)Z)."""
    phi = euler_phi(m)
    facs = factorize(phi)
    for g in range(2, m):
        if math.gcd(g, m) != 1:
            continue
        if all(pow(g, phi // f, m) != 1 for f in facs):
            return g
    raise ValueError(f"(Z/{m}Z)* has no generator (group is not cyclic)")


def generate_prime_chain(m: int, nat_log_product: float, *, max_bits: int = 20,
                         min_bits: int = 19, exclude: tuple[int, ...] = ()) -> list[int]:
    """TPU prime chain: primes ≡ 1 (mod m), below 2^max_bits, whose product
    exceeds e^nat_log_product.

    This replaces AddPrimesBySize (reference FHEContext.cpp:88-115).  The
    reference walks ~60-bit NTL primes downward; the prime basis is an
    internal exact-arithmetic device (SURVEY §1), so we instead pick
    primes that fit int32 lanes with headroom for 10-bit-split modular
    multiplies on the VPU (product of two < 2^20 residue halves stays
    < 2^31).  We walk downward from 2^max_bits - 1 in steps of m to keep
    every prime ≡ 1 mod m, dropping below 2^min_bits only if the window
    is exhausted.
    """
    del min_bits  # (soft floor retired: a single downward walk is simplest)
    step = m if m % 2 == 0 else 2 * m  # keep candidates odd
    top = (1 << max_bits) - 1
    p = top - (top % step) + 1  # ≡ 1 mod step
    if p > top:
        p -= step
    chain: list[int] = []
    size_left = nat_log_product
    while size_left > 0.0:
        while p > max(2, m) and not (is_prime(p) and p not in exclude):
            p -= step
        if p <= max(2, m):
            raise ValueError(
                f"prime window exhausted for m={m}: found {len(chain)} primes ≡ 1 "
                f"mod {m} below 2^{max_bits}, need log-product {nat_log_product:.1f} "
                f"({size_left:.1f} short)")
        chain.append(p)
        size_left -= math.log(p)
        p -= step
    return chain


def extend_prime_chain(chain: list[int], m: int, count: int, *,
                       exclude: tuple[int, ...] = ()) -> list[int]:
    """Append `count` more primes ≡ 1 (mod m) continuing downward from the
    smallest chain member (extra primes only add CRT slack — always legal)."""
    step = m if m % 2 == 0 else 2 * m
    p = min(chain) - step
    out = list(chain)
    while count > 0:
        while p > max(2, m) and not (is_prime(p) and p not in exclude
                                     and p not in out):
            p -= step
        if p <= max(2, m):
            raise ValueError(f"prime window exhausted extending chain for m={m}")
        out.append(p)
        count -= 1
        p -= step
    return out
