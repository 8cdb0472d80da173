"""Injectable randomness for keygen/encryption.

The port's copy of fhe_si_tpu/sampling.py.  The exactness contract between
the two packages rests on it: the same seed draws the same integers in
the same order from both (tests/test_torch_host.py).

The reference drives all sampling through NTL's PRG plus lrand48
(NumbTh.cpp:340-404, Util.cpp:49-55, FHE-SI.cpp:14-19).  We do not
replicate NTL's bit stream (SURVEY §7 "NTL PRG: do not port"); instead
every scheme operation takes explicit pre-sampled arrays, and this module
provides a canonical host sampler that fills them.  The same sampled
values feed both the device path and the pure-Python oracle, so the two
can be compared bit-exactly.

Distributions (matching the reference's shapes):
  - binary_poly:     coeffs uniform {0,1}            (FHE-SI.cpp:14-19)
  - gaussian_poly:   rounded Box-Muller N(0, stdev)  (NumbTh.cpp:377-404)
  - hwt_poly:        exactly hwt coeffs = ±1         (NumbTh.cpp:340-359)
  - uniform_signed_q: uniform in [-q/2, q/2), q=2^logQ (Util.cpp:49-55)
  - uniform_mod_p:   uniform in [0, p)               (Regression.h:180-190)
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


class RandomSource:
    """Canonical host sampler over numpy's PCG64. Seed-reproducible."""

    def __init__(self, seed: int):
        self.rng = np.random.Generator(np.random.PCG64(seed))

    def binary_poly(self, n: int) -> np.ndarray:
        return self.rng.integers(0, 2, size=n, dtype=np.int64)

    def gaussian_poly(self, n: int, stdev: float) -> np.ndarray:
        """Box-Muller pairs rounded to nearest int, like sampleGaussian
        (NumbTh.cpp:387-402): floor(x + 0.5) of N(0, stdev^2) samples."""
        out = np.empty(n, dtype=np.int64)
        for i in range(0, n, 2):
            r1 = self.rng.random()
            r2 = self.rng.random()
            theta = 2 * np.pi * r1
            rr = np.sqrt(-2.0 * np.log(max(r2, 1e-300))) * stdev
            out[i] = int(np.floor(rr * np.cos(theta) + 0.5))
            if i + 1 < n:
                out[i + 1] = int(np.floor(rr * np.sin(theta) + 0.5))
        return out

    def hwt_poly(self, n: int, hwt: int) -> np.ndarray:
        out = np.zeros(n, dtype=np.int64)
        hwt = min(hwt, n)
        count = 0
        while count < hwt:
            u = int(self.rng.integers(0, n))
            if out[u] == 0:
                out[u] = 1 if self.rng.integers(0, 2) else -1
                count += 1
        return out

    def uniform_signed_q(self, n: int, log_q: int) -> list[int]:
        """n Python ints uniform in [-2^(logQ-1), 2^(logQ-1))."""
        half = 1 << (log_q - 1)
        out = []
        for _ in range(n):
            val = 0
            for shift in range(0, log_q, 32):
                width = min(32, log_q - shift)
                val |= int(self.rng.integers(0, 1 << width)) << shift
            out.append(val - half)
        return out

    def uniform_mod_p(self, n: int, p: int) -> np.ndarray:
        return self.rng.integers(0, p, size=n, dtype=np.int64)


@dataclass
class EncryptRandomness:
    """Sampling plan of FHESIPubKey::Encrypt (FHE-SI.cpp:10-36):
    r binary, then one Gaussian error per public-key part (in order)."""
    r: np.ndarray                # [phim] in {0,1}
    errors: list[np.ndarray]     # n_parts x [phim] Gaussian ints


def sample_encrypt(source: RandomSource, phim: int, stdev: float,
                   n_parts: int = 2) -> EncryptRandomness:
    r = source.binary_poly(phim)
    errors = [source.gaussian_poly(phim, stdev) for _ in range(n_parts)]
    return EncryptRandomness(r=r, errors=errors)


@dataclass
class KeyGenRandomness:
    """FHESISecKey::Init (FHE-SI.cpp:86-91) then FHESIPubKey::Init
    (FHE-SI.cpp:42-62): s = HWt(64); c0 Gaussian; c1 uniform mod q."""
    s: np.ndarray                # [phim] in {-1,0,1}, weight 64
    c0: np.ndarray               # [phim] Gaussian ints
    c1: list[int]                # [phim] uniform signed mod q


def sample_keygen(source: RandomSource, phim: int, stdev: float, log_q: int,
                  hwt: int = 64) -> KeyGenRandomness:
    return KeyGenRandomness(
        s=source.hwt_poly(phim, hwt),
        c0=source.gaussian_poly(phim, stdev),
        c1=source.uniform_signed_q(phim, log_q),
    )


@dataclass
class KeySwitchRandomness:
    """KeySwitchSI::Init (FHE-SI.cpp:153-209): per (source-part i, digit j),
    in that nesting order: A uniform signed mod q, then e Gaussian."""
    A: list[list[int]]           # (n_src*ndigits) x [phim] uniform signed
    e: list[np.ndarray]          # (n_src*ndigits) x [phim] Gaussian ints


def sample_keyswitch(source: RandomSource, phim: int, stdev: float,
                     log_q: int, n_src: int, ndigits: int) -> KeySwitchRandomness:
    A, e = [], []
    for _ in range(n_src * ndigits):
        A.append(source.uniform_signed_q(phim, log_q))
        e.append(source.gaussian_poly(phim, stdev))
    return KeySwitchRandomness(A=A, e=e)
