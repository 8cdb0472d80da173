"""Plain reference of FHE-SI's multiply + relinearize, the benchmark's judge.

Exact integer polynomial arithmetic modulo the cyclotomic Phi_m(X), with
ciphertext coefficients reduced signed modulo q = 2^logQ, written from the
scheme's definition (Brakerski's scale-invariant SWHE as the dwu4/fhe-si
sources implement it, FHE-SI.cpp, Ciphertext.cpp):

  keygen        pk = (reduce(c0 + s * c1), reduce(-c1))          FHE-SI.cpp:42-91
  relin key     row j of source key s_i (1, s, s^2):
                  b = reduce(A * s + e + 2^(db*j) * s_i), a = reduce(-A)
                                                                  FHE-SI.cpp:153-227
  encrypt       c_i = reduce(pk_i * r + p * e_i), c_0 += floor(q/p) * msg
                                                                  FHE-SI.cpp:10-36
  multiply      t_k = sum_{i+j=k} (p * a_i) * b_j                 Ciphertext.cpp:167-192
  ScaleDown     c_k = reduce(floor((2 t_k + q) / 2q))             Ciphertext.cpp:194-218
  ByteDecomp    digits of the positive representative, db bits    Ciphertext.cpp:82-121
  key switch    out_r = reduce(sum_k row_r[k] * digit_k)          FHE-SI.cpp:241-260

where * is the product modulo Phi_m(X) and reduce(v) the representative
of v mod q in [-q/2, q/2).  There are no prime chains, transforms or
limbs here: every value is a Python integer, every product an exact
Kronecker substitution (one big-integer multiply per polynomial product),
so the result does not depend on how any implementation bounds its
intermediate values.  Imports numpy and the standard library only.
"""
from __future__ import annotations

import numpy as np

LIMB_BITS = 16


# ------------------------------------------------------------------ the ring
def _mobius(n: int) -> int:
    out, k = 1, 2
    while k * k <= n:
        if n % k == 0:
            n //= k
            if n % k == 0:
                return 0
            out = -out
        k += 1
    return -out if n > 1 else out


def _times_xd_minus_1(a: list[int], d: int) -> list[int]:
    out = [0] * d + a
    for i, c in enumerate(a):
        out[i] -= c
    return out


def _over_xd_minus_1(a: list[int], d: int) -> list[int]:
    """Exact quotient of a by X^d - 1: a_k = q_(k-d) - q_k."""
    q = [0] * (len(a) - d)
    for k in range(len(q)):
        q[k] = -a[k] + (q[k - d] if k >= d else 0)
    return q


def cyclotomic(m: int) -> list[int]:
    """Coefficients of Phi_m(X), lowest degree first:
    the product over d | m of (X^d - 1)^mu(m / d)."""
    divs = [d for d in range(1, m + 1) if m % d == 0]
    poly = [1]
    for d in divs:
        if _mobius(m // d) == 1:
            poly = _times_xd_minus_1(poly, d)
    for d in divs:
        if _mobius(m // d) == -1:
            poly = _over_xd_minus_1(poly, d)
    return poly


class Ring:
    """Z[X] / Phi_m(X) with exact integer coefficients."""

    def __init__(self, m: int):
        self.m = m
        self.phi = cyclotomic(m)
        self.phim = len(self.phi) - 1
        self._low = np.array(self.phi[:self.phim], dtype=object)
        # Phi_m divides X^(m/2) + 1 for even m and X^m - 1 for odd m:
        # fold by that first, then clear the degrees left above phim
        self._fold, self._sign = (m // 2, -1) if m % 2 == 0 else (m, 1)

    def reduce(self, c) -> np.ndarray:
        c = np.array(c, dtype=object)
        M = self._fold
        while len(c) > M:
            head, tail = c[:M].copy(), c[M:]
            head[:len(tail)] += self._sign * tail
            c = head
        if len(c) < self.phim:
            return np.concatenate([c, np.zeros(self.phim - len(c), object)])
        for i in range(len(c) - 1, self.phim - 1, -1):
            top = c[i]
            if top:
                c[i - self.phim:i] -= top * self._low
        return c[:self.phim]

    def mul(self, a, b) -> np.ndarray:
        """a * b mod Phi_m for coefficient vectors of length phim."""
        return self.reduce(poly_mul(a, b))


def _pack(values, nbytes: int) -> int:
    return int.from_bytes(b"".join(int(v).to_bytes(nbytes, "little")
                                   for v in values), "little")


def poly_mul(a, b) -> np.ndarray:
    """Exact product of two integer polynomials by Kronecker substitution:
    each packed at a spacing that holds any coefficient of the product
    (positive and negative parts apart), one big-integer multiply, and
    the product read back as balanced digits."""
    a = [int(v) for v in a]
    b = [int(v) for v in b]
    n_out = len(a) + len(b) - 1
    top = max(map(abs, a)) * max(map(abs, b)) * min(len(a), len(b))
    if top == 0:
        return np.zeros(n_out, dtype=object)
    nb = (top.bit_length() + 2 + 7) // 8
    bits = 8 * nb

    def packed(v):
        return (_pack([x if x > 0 else 0 for x in v], nb)
                - _pack([-x if x < 0 else 0 for x in v], nb))

    half = 1 << (bits - 1)
    u = packed(a) * packed(b) + half * (((1 << (bits * n_out)) - 1)
                                        // ((1 << bits) - 1))
    buf = u.to_bytes(nb * n_out, "little")
    return np.array([int.from_bytes(buf[i * nb:(i + 1) * nb], "little") - half
                     for i in range(n_out)], dtype=object)


# ---------------------------------------------------------------- the scheme
class Scheme:
    """FHE-SI at (m, logQ, p, decompSize) on exact integers."""

    def __init__(self, m: int, log_q: int, p: int, decomp_size: int):
        self.ring = Ring(m)
        self.phim = self.ring.phim
        self.log_q, self.q, self.p = log_q, 1 << log_q, p
        self.digit_bits = 8 * decomp_size
        self.ndigits = -(-log_q // self.digit_bits)

    def reduce(self, v) -> np.ndarray:
        """v mod q in [-q/2, q/2) (Util.cpp:3-26)."""
        half = self.q >> 1
        return ((np.asarray(v, dtype=object) & (self.q - 1)) ^ half) - half

    def _vec(self, v) -> np.ndarray:
        return np.array([int(x) for x in v], dtype=object)

    def keygen(self, s, c0, c1) -> tuple:
        s, c1 = self._vec(s), self._vec(c1)
        return (self.reduce(self._vec(c0) + self.ring.mul(s, c1)),
                self.reduce(-c1))

    def relin_key(self, s, A, e) -> tuple[list, list]:
        """The two rows of the key from (1, s, s^2) to (1, s); A and e in
        the order (source part, digit)."""
        s = self._vec(s)
        one = np.zeros(self.phim, dtype=object)
        one[0] = 1
        rows_b, rows_a, k = [], [], 0
        for s_i in (one, s, self.ring.mul(s, s)):
            for j in range(self.ndigits):
                a = self._vec(A[k])
                b = (self.ring.mul(a, s) + self._vec(e[k])
                     + (s_i << (self.digit_bits * j)))
                rows_b.append(self.reduce(b))
                rows_a.append(self.reduce(-a))
                k += 1
        return rows_b, rows_a

    def encrypt(self, pk, msg, r, errors) -> tuple:
        r = self._vec(r)
        parts = [self.ring.mul(pk_i, r) + self.p * self._vec(e_i)
                 for pk_i, e_i in zip(pk, errors)]
        parts[0] = parts[0] + (self.q // self.p) * self._vec(msg)
        return tuple(self.reduce(c) for c in parts)

    def tensor(self, a, b) -> list:
        """The tensored parts t_k = sum_{i+j=k} (p a_i) b_j, exact."""
        t = [np.zeros(self.phim, dtype=object) for _ in range(3)]
        for i in range(2):
            for j in range(2):
                t[i + j] = t[i + j] + self.ring.mul(self.p * a[i], b[j])
        return t

    def scale_down(self, t) -> np.ndarray:
        """floor((2 t + q) / 2q), reduced."""
        return self.reduce((2 * t + self.q) // (2 * self.q))

    def digits(self, c) -> list:
        pos = np.asarray(c, dtype=object) & (self.q - 1)
        mask = (1 << self.digit_bits) - 1
        return [(pos >> (self.digit_bits * j)) & mask
                for j in range(self.ndigits)]

    def mul_relin(self, a, b, key) -> tuple:
        """Multiply two 2-part ciphertexts and relinearize with key (the
        rows of relin_key): parts (c0, c1) mod q."""
        digs = [d for t in self.tensor(a, b)
                for d in self.digits(self.scale_down(t))]
        out = []
        for row in key:
            acc = np.zeros(2 * self.phim - 1, dtype=object)
            for k_poly, d in zip(row, digs):
                acc = acc + poly_mul(k_poly, d)
            out.append(self.reduce(self.ring.reduce(acc)))
        return tuple(out)

    def decrypt(self, s, ct) -> np.ndarray:
        """floor((2p (c0 + c1 s) + q) / 2q) mod p (FHE-SI.cpp:93-119)."""
        d = ct[0] + self.ring.mul(ct[1], self._vec(s))
        return np.array([int(x) for x in
                         ((2 * self.p * d + self.q) // (2 * self.q)) % self.p],
                        dtype=np.int64)

    def plaintext_mul(self, x, y) -> np.ndarray:
        prod = self.ring.mul(self._vec(x), self._vec(y))
        return np.array([int(v) % self.p for v in prod], dtype=np.int64)


def to_limbs(values, width: int) -> np.ndarray:
    """Integers -> width little-endian 16-bit limbs of their two's
    complement, int64 [len, width]."""
    mask = (1 << (LIMB_BITS * width)) - 1
    buf = b"".join((int(v) & mask).to_bytes(2 * width, "little")
                   for v in values)
    return np.frombuffer(buf, dtype="<u2").reshape(-1, width).astype(np.int64)
