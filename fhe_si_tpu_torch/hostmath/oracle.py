"""Reference-exact FHE-SI scheme in pure Python big-int arithmetic.

Serves two roles:
  1. Test oracle: every device kernel / scheme op is checked bit-exactly
     against this module (same sampled randomness on both paths).
  2. Measured CPU baseline: NTL is not installed in this image, so the
     baseline denominator for bench.py is this faithful single-threaded
     re-implementation of the reference algorithms (see BASELINE.md).

Every function cites the reference code whose semantics it reproduces.
The DoubleCRT layer is *not* replicated here: the prime chain is an exact
arithmetic device (SURVEY §1), so exact Python-int polynomial arithmetic,
with values reduced to the centered representative mod P = prod(primes)
exactly where the reference calls toPoly, yields bit-identical results.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING

import numpy as np

from ..sampling import (EncryptRandomness, KeyGenRandomness,
                        KeySwitchRandomness)

if TYPE_CHECKING:  # annotation-only; avoids a package import cycle
    from ..context import FheContext
else:
    FheContext = "FheContext"

Poly = list[int]  # dense coefficients, index = degree, length = phim (padded)


# ------------------------------------------------------------------ poly core
def _pack(coeffs: Poly, nbytes: int) -> int:
    """Nonnegative coefficients < 2^(8*nbytes) -> one big int at that
    spacing.  int.from_bytes over a joined buffer is O(n*nbytes) — the
    naive sum(c << (bits*i)) is quadratic in n and dominated the oracle
    at phim >= 4096."""
    return int.from_bytes(
        b"".join(c.to_bytes(nbytes, "little") for c in coeffs), "little")


def _kron_mul(a: Poly, b: Poly, bits: int) -> Poly:
    """Exact signed polynomial product via Kronecker substitution:
    pack at 2^bits spacing (positive/negative parts packed separately,
    byte-aligned), one big-int multiply, balanced-digit unpack via one
    to_bytes conversion (linear, like the packing)."""
    nb = bits // 8
    pa = (_pack([c if c > 0 else 0 for c in a], nb)
          - _pack([-c if c < 0 else 0 for c in a], nb))
    pb = (_pack([c if c > 0 else 0 for c in b], nb)
          - _pack([-c if c < 0 else 0 for c in b], nb))
    prod = pa * pb
    n_out = len(a) + len(b) - 1
    half = 1 << (bits - 1)
    # balanced digits d_i in [-half, half): prod + sum(half << bits*i)
    # has plain base-2^bits digits d_i + half in [0, 2^bits), extracted
    # with one to_bytes pass
    u = prod + _pack([half] * n_out, nb)
    assert u >= 0 and u.bit_length() <= bits * n_out, \
        "Kronecker spacing too small for the product"
    buf = u.to_bytes(nb * n_out, "little")
    return [int.from_bytes(buf[i * nb:(i + 1) * nb], "little") - half
            for i in range(n_out)]


def poly_mul(a: Poly, b: Poly) -> Poly:
    if not a or not b:
        return []
    ma = max(abs(c) for c in a)
    mb = max(abs(c) for c in b)
    bits = (ma * mb * min(len(a), len(b))).bit_length() + 2
    return _kron_mul(a, b, max((bits + 7) // 8 * 8, 8))


def poly_mod_phim(a: Poly, phim_x) -> Poly:
    """Remainder of a modulo the monic Phi_m(X).  Iterates only the
    nonzero Phi coefficients — for power-of-two m, Phi = X^phim + 1 and
    the reduction is O(phim) instead of O(phim^2)."""
    deg_phi = len(phim_x) - 1
    nz = [(j, pj) for j, pj in enumerate(phim_x) if pj and j < deg_phi]
    a = list(a)
    for i in range(len(a) - 1, deg_phi - 1, -1):
        c = a[i]
        if c:
            a[i] = 0  # monic top term
            for j, pj in nz:
                a[i - deg_phi + j] -= c * pj
    return a[:deg_phi]


def pad(a, n: int) -> Poly:
    a = [int(c) for c in a]
    return a + [0] * (n - len(a))


# ------------------------------------------------------------ reference prims
def reduce_coeff(val: int, log_q: int, positive: bool = False) -> int:
    """Reduce (Util.cpp:3-26): val mod 2^logQ, positive in [0, q) or signed
    in [-q/2, q/2) via the xor/sub signMask trick."""
    q = 1 << log_q
    v = val & (q - 1)
    if positive:
        return v
    sign_mask = q >> 1
    return (v ^ sign_mask) - sign_mask


def reduce_poly(a: Poly, log_q: int, positive: bool = False) -> Poly:
    return [reduce_coeff(c, log_q, positive) for c in a]


def centered_mod(x: int, modulus: int) -> int:
    """Centered representative in [-modulus/2, modulus/2) matching
    DoubleCRT::toPoly (DoubleCRT.cpp:368-376: subtract if > P/2)."""
    r = x % modulus
    if r > modulus // 2:
        r -= modulus
    return r


def floor_div(a: int, b: int) -> int:
    """NTL ZZ division semantics for b > 0: floor (a = b*q + r, 0 <= r < b)."""
    return a // b


# ----------------------------------------------------------------- structures
@dataclass
class OracleCiphertext:
    """Ciphertext (Ciphertext.h:46-97): coefficient parts mod 2^logQ, or the
    tensored representation after multiply (scaled_up)."""
    ctx: FheContext
    parts: list[Poly] = field(default_factory=list)
    tprod: list[Poly] = field(default_factory=list)   # exact ints (implicitly mod P)
    scaled_up: bool = False

    def copy(self) -> "OracleCiphertext":
        return OracleCiphertext(self.ctx, [list(p) for p in self.parts],
                                [list(t) for t in self.tprod], self.scaled_up)


@dataclass
class OracleSecretKey:
    ctx: FheContext
    s_keys: list[Poly]            # [(1,0,0,...), s] with s ternary HWt(64)


@dataclass
class OraclePublicKey:
    ctx: FheContext
    pk: list[Poly]                # (c0, c1) reduced signed mod q


@dataclass
class OracleKeySwitch:
    ctx: FheContext
    matrix: list[list[Poly]]      # [2][n_src*ndigits] polys


# ------------------------------------------------------------------ key setup
def keygen(ctx: FheContext, rnd: KeyGenRandomness) -> tuple[OracleSecretKey, OraclePublicKey]:
    """FHESISecKey::Init (FHE-SI.cpp:86-91) + FHESIPubKey::Init
    (FHE-SI.cpp:42-62)."""
    phim = ctx.phim
    one = pad([1], phim)
    s = pad(rnd.s, phim)
    sk = OracleSecretKey(ctx, [one, s])

    c0 = pad(rnd.c0, phim)
    c1 = pad(rnd.c1, phim)
    tmp = poly_mod_phim(poly_mul(s, c1), ctx.phim_x)
    c0 = [a + b for a, b in zip(c0, pad(tmp, phim))]
    c1 = [-c for c in c1]
    c0 = reduce_poly(c0, ctx.log_q)
    c1 = reduce_poly(c1, ctx.log_q)
    return sk, OraclePublicKey(ctx, [c0, c1])


# ------------------------------------------------------------- encrypt/decrypt
def encrypt(pk: OraclePublicKey, message_mod_p, rnd: EncryptRandomness) -> OracleCiphertext:
    """FHESIPubKey::Encrypt (FHE-SI.cpp:10-36): ct_i = pk_i*r + p*e_i
    (exact, centered mod P), ct_0 += floor(q/p)*m, reduce signed mod q."""
    ctx = pk.ctx
    phim = ctx.phim
    r = pad(rnd.r, phim)
    parts = []
    for i, pk_i in enumerate(pk.pk):
        e = [ctx.p * int(c) for c in rnd.errors[i]]
        prod = poly_mod_phim(poly_mul(pk_i, r), ctx.phim_x)
        ct = [a + b for a, b in zip(pad(prod, phim), pad(e, phim))]
        ct = [centered_mod(c, ctx.prime_product) for c in ct]
        parts.append(ct)
    scale = ctx.q // ctx.p
    msg = pad(message_mod_p, phim)
    parts[0] = [c + scale * m for c, m in zip(parts[0], msg)]
    parts = [reduce_poly(part, ctx.log_q) for part in parts]
    return OracleCiphertext(ctx, parts=parts)


def decrypt(sk: OracleSecretKey, ct: OracleCiphertext) -> list[int]:
    """FHESISecKey::Decrypt (FHE-SI.cpp:93-119): d = <ct, sk> (centered
    mod P), then m_i = floor((d_i*2p + q) / 2q) mod p."""
    ctx = sk.ctx
    phim = ctx.phim
    acc = [0] * phim
    for part, skey in zip(ct.parts, sk.s_keys):
        prod = poly_mod_phim(poly_mul(part, skey), ctx.phim_x)
        acc = [a + b for a, b in zip(acc, pad(prod, phim))]
    acc = [centered_mod(c, ctx.prime_product) for c in acc]
    q, p = ctx.q, ctx.p
    return [floor_div(c * 2 * p + q, 2 * q) % p for c in acc]


# ------------------------------------------------------------- homomorphic ops
def add(a: OracleCiphertext, b: OracleCiphertext) -> OracleCiphertext:
    """Ciphertext::operator+= (Ciphertext.cpp:123-145): ragged part-wise add;
    non-tensored parts are re-reduced signed mod q, tensored sums are exact."""
    assert a.scaled_up == b.scaled_up
    out = a.copy()
    if not a.scaled_up:
        n = min(len(out.parts), len(b.parts))
        for i in range(n):
            s = [x + y for x, y in zip(out.parts[i], b.parts[i])]
            out.parts[i] = reduce_poly(s, a.ctx.log_q)
        out.parts.extend([list(p) for p in b.parts[n:]])
    else:
        n = min(len(out.tprod), len(b.tprod))
        for i in range(n):
            out.tprod[i] = [x + y for x, y in zip(out.tprod[i], b.tprod[i])]
        out.tprod.extend([list(t) for t in b.tprod[n:]])
    return out


def add_const(a: OracleCiphertext, const_mod_p) -> OracleCiphertext:
    """Ciphertext::operator+=(ZZX) (Ciphertext.cpp:147-161):
    constant scaled by floor(c*2^logQ / p) into part/tprod 0."""
    ctx = a.ctx
    scaled = [floor_div(int(c) << ctx.log_q, ctx.p) for c in pad(const_mod_p, ctx.phim)]
    out = a.copy()
    if not a.scaled_up:
        s = [x + y for x, y in zip(out.parts[0], scaled)]
        out.parts[0] = reduce_poly(s, ctx.log_q)
    else:
        out.tprod[0] = [x + y for x, y in zip(out.tprod[0], scaled)]
    return out


def mul(a: OracleCiphertext, b: OracleCiphertext) -> OracleCiphertext:
    """Ciphertext::operator*= (Ciphertext.cpp:167-192): tensor product of
    (p * a_parts) with b_parts, exact mod Phi_m (centered mod P)."""
    ctx = a.ctx
    assert not a.scaled_up and not b.scaled_up
    phim = ctx.phim
    c1 = [[ctx.p * c for c in part] for part in a.parts]
    c2 = [list(part) for part in b.parts]
    tprod = [[0] * phim for _ in range(len(c1) + len(c2) - 1)]
    for i, ci in enumerate(c1):
        for j, cj in enumerate(c2):
            prod = pad(poly_mod_phim(poly_mul(ci, cj), ctx.phim_x), phim)
            tprod[i + j] = [x + y for x, y in zip(tprod[i + j], prod)]
    tprod = [[centered_mod(c, ctx.prime_product) for c in t] for t in tprod]
    return OracleCiphertext(ctx, tprod=tprod, scaled_up=True)


def mul_scalar(a: OracleCiphertext, ell: int) -> OracleCiphertext:
    """Ciphertext::operator*=(long) (Ciphertext.cpp:233-244)."""
    out = a.copy()
    if not a.scaled_up:
        out.parts = [reduce_poly([c * ell for c in part], a.ctx.log_q)
                     for part in out.parts]
    else:
        out.tprod = [[centered_mod(c * ell, a.ctx.prime_product) for c in t]
                     for t in out.tprod]
    return out


def mul_const(a: OracleCiphertext, const_mod_p) -> OracleCiphertext:
    """Ciphertext::operator*=(ZZX) (Ciphertext.cpp:246-258)."""
    ctx = a.ctx
    cpoly = pad(const_mod_p, ctx.phim)
    out = a.copy()
    if not a.scaled_up:
        new_parts = []
        for part in out.parts:
            prod = pad(poly_mod_phim(poly_mul(part, cpoly), ctx.phim_x), ctx.phim)
            new_parts.append(reduce_poly(prod, ctx.log_q))
        out.parts = new_parts
    else:
        out.tprod = [
            [centered_mod(c, ctx.prime_product)
             for c in pad(poly_mod_phim(poly_mul(t, cpoly), ctx.phim_x), ctx.phim)]
            for t in out.tprod]
    return out


def scale_down(a: OracleCiphertext) -> OracleCiphertext:
    """Ciphertext::ScaleDown (Ciphertext.cpp:194-218): per tensored part,
    centered mod P, then floor((2x + q)/(2q)), then reduce signed mod q."""
    if not a.scaled_up:
        return a.copy()
    ctx = a.ctx
    q = ctx.q
    parts = []
    for t in a.tprod:
        part = [floor_div(2 * centered_mod(c, ctx.prime_product) + q, 2 * q)
                for c in t]
        parts.append(reduce_poly(part, ctx.log_q))
    return OracleCiphertext(ctx, parts=parts)


def byte_decomp(a: OracleCiphertext) -> OracleCiphertext:
    """Ciphertext::ByteDecomp (Ciphertext.cpp:82-121): radix-2^(8*decompSize)
    digits of the positive representative, part i digit j at index
    i*ndigits + j."""
    ctx = a.ctx
    nd, db = ctx.ndigits, ctx.digit_bits
    mask = (1 << db) - 1
    new_parts = []
    for part in a.parts:
        pos = [reduce_coeff(c, ctx.log_q, positive=True) for c in part]
        for j in range(nd):
            new_parts.append([(c >> (db * j)) & mask for c in pos])
    return OracleCiphertext(ctx, parts=new_parts)


def automorph(a: OracleCiphertext, k: int) -> OracleCiphertext:
    """Ciphertext::operator>>= (Ciphertext.cpp:264-275): F(X) -> F(X^k)
    mod Phi_m on every part (exact; no re-reduction, matching the
    DoubleCRT round-trip in CiphertextPart::operator>>=)."""
    ctx = a.ctx
    out = a.copy()

    def amap(poly: Poly) -> Poly:
        # X^m == 1 mod Phi_m, so exponents fold into [0, m) first.
        up = [0] * ctx.m
        for i, c in enumerate(poly):
            up[(i * k) % ctx.m] += c
        return pad(poly_mod_phim(up, ctx.phim_x), ctx.phim)

    if not a.scaled_up:
        out.parts = [[centered_mod(c, ctx.prime_product) for c in amap(p)]
                     for p in out.parts]
    else:
        out.tprod = [[centered_mod(c, ctx.prime_product) for c in amap(t)]
                     for t in out.tprod]
    return out


# ----------------------------------------------------------------- key switch
def keyswitch_init(src: OracleSecretKey, dst: OracleSecretKey,
                   rnd: KeySwitchRandomness) -> OracleKeySwitch:
    """KeySwitchSI::Init (FHE-SI.cpp:153-209): b = A*t + e + 2^(digit_bits*j)*s_i
    (s_i shifted *after* use, so digit j sees shift j), A negated; both rows
    reduced signed mod q."""
    ctx = src.ctx
    phim = ctx.phim
    t = dst.s_keys[1]
    rowA, rowB = [], []
    ind = 0
    for s_i in src.s_keys:
        s_shift = [centered_mod(c, ctx.prime_product) for c in s_i]
        for _ in range(ctx.ndigits):
            A = pad(rnd.A[ind], phim)
            b = pad(poly_mod_phim(poly_mul(A, t), ctx.phim_x), phim)
            b = [centered_mod(c, ctx.prime_product) for c in b]
            b = [x + int(e) + s for x, e, s in zip(b, rnd.e[ind], s_shift)]
            s_shift = [c << ctx.digit_bits for c in s_shift]
            rowB.append(reduce_poly(b, ctx.log_q))
            rowA.append(reduce_poly([-c for c in A], ctx.log_q))
            ind += 1
    return OracleKeySwitch(ctx, [rowB, rowA])


def keyswitch_init_s2(sk: OracleSecretKey, rnd: KeySwitchRandomness) -> OracleKeySwitch:
    """KeySwitchSI::InitS2 (FHE-SI.cpp:211-227): relinearization key for the
    tensored key (1, s, s^2)."""
    ctx = sk.ctx
    s = sk.s_keys[1]
    s2 = [centered_mod(c, ctx.prime_product)
          for c in pad(poly_mod_phim(poly_mul(s, s), ctx.phim_x), ctx.phim)]
    tensored = OracleSecretKey(ctx, [sk.s_keys[0], list(s), s2])
    return keyswitch_init(tensored, sk, rnd)


def keyswitch_init_automorph(sk: OracleSecretKey, k: int,
                             rnd: KeySwitchRandomness) -> OracleKeySwitch:
    """KeySwitchSI::InitAutomorph (FHE-SI.cpp:229-239)."""
    ctx = sk.ctx

    def amap(poly: Poly) -> Poly:
        # X^m == 1 mod Phi_m, so exponents fold into [0, m) first.
        up = [0] * ctx.m
        for i, c in enumerate(poly):
            up[(i * k) % ctx.m] += c
        return [centered_mod(c, ctx.prime_product)
                for c in pad(poly_mod_phim(up, ctx.phim_x), ctx.phim)]

    auto_key = OracleSecretKey(ctx, [amap(s) for s in sk.s_keys])
    return keyswitch_init(auto_key, sk, rnd)


def apply_keyswitch(ksw: OracleKeySwitch, ct: OracleCiphertext) -> OracleCiphertext:
    """KeySwitchSI::ApplyKeySwitch (FHE-SI.cpp:241-260): ScaleDown,
    ByteDecomp, two dot products with the matrix rows, reduce signed."""
    ctx = ksw.ctx
    ct = scale_down(ct)
    ct = byte_decomp(ct)
    new_parts = []
    for row in ksw.matrix:
        acc = [0] * ctx.phim
        for m_poly, d_poly in zip(row, ct.parts):
            prod = pad(poly_mod_phim(poly_mul(m_poly, d_poly), ctx.phim_x), ctx.phim)
            acc = [a + b for a, b in zip(acc, prod)]
        acc = [centered_mod(c, ctx.prime_product) for c in acc]
        new_parts.append(reduce_poly(acc, ctx.log_q))
    return OracleCiphertext(ctx, parts=new_parts)


# --------------------------------------------------------------- plaintext ops
def plaintext_mul(ctx: FheContext, a, b) -> np.ndarray:
    """Plaintext::operator*= (Plaintext.h:82-86): product mod (Phi_m, p)."""
    prod = poly_mod_phim(poly_mul(pad(a, ctx.phim), pad(b, ctx.phim)), ctx.phim_x)
    return np.array([c % ctx.p for c in pad(prod, ctx.phim)], dtype=np.int64)


def plaintext_automorph(ctx: FheContext, a, t: int) -> np.ndarray:
    """F(X) -> F(X^t) mod (Phi_m, p) — the exact plaintext image of the
    ciphertext automorphism (Ciphertext.cpp:264-275 applied to the
    message).  Coincides with plaintext_rotate(k) for t = g^k when every
    slot holds a base-field constant; for full GF(p^d) slot elements the
    decode/roll/embed rotate differs by a per-slot basis twist (the
    remainder mod F_{j+1} of r_j(X^t) is not r_j), so this is the
    faithful mirror of `ciphertext >> t`."""
    up = [0] * ctx.m
    for i, c in enumerate(np.asarray(a, dtype=np.int64)):
        up[(i * t) % ctx.m] = (up[(i * t) % ctx.m] + int(c)) % ctx.p
    red = pad(poly_mod_phim(up, ctx.phim_x), ctx.phim)
    return np.array([c % ctx.p for c in red], dtype=np.int64)


def plaintext_rotate(ctx: FheContext, a, k: int) -> np.ndarray:
    """Plaintext::operator>>= (Plaintext.h:88-97): new[j] = old[(j+k) % n]
    over all totalSlots.  With extension-field slots the decoded slot
    values are [S, d] coefficient vectors; they move wholesale (the
    reference decodes/reorders/re-embeds the remainder polynomials the
    same way).  With multiple g-orbit slot cycles (power-of-two m) each
    cycle rolls independently (context.rotate_slots)."""
    slots = ctx.decode_slots(a)
    rotated = ctx.rotate_slots(slots, k)
    return ctx.embed_in_slots(rotated, only_usable=False)
