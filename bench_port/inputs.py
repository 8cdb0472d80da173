"""Everything a run feeds the scheme, drawn from --seed by the benchmark's
own generator: the secret key and key-generation randomness, the
relinearization key's randomness, and a pool of encrypted operand pairs
(messages and encryption randomness).  The same values go to the program
(through its public API) and to the plain reference.

The distributions are the scheme's (the shapes of FHE-SI.cpp,
NumbTh.cpp and Util.cpp that fhe_si_tpu_torch/sampling.py documents),
drawn here in bulk with numpy:
  s        weight-64 ternary: 64 distinct positions (all of a smaller
           ring), each +1 or -1
  errors   rounded Gaussians floor(N(0, stdev^2) + 1/2)
  c1, A    uniform integers in [-q/2, q/2), q = 2^logQ
  r        uniform bits
  messages uniform coefficients mod p
Every seed draws the same sizes, so seeds change values and never work.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

HWT = 64            # the secret key's Hamming weight (FHE-SI.cpp:90)
KEY_PARTS = 3       # relinearization from (1, s, s^2)


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence(seed % (1 << 64)).spawn(3)[stream])


def _gauss(rng, shape, stdev) -> np.ndarray:
    return np.floor(rng.normal(0.0, stdev, size=shape) + 0.5).astype(np.int64)


def _uniform_q(rng, n: int, log_q: int) -> list[int]:
    """n integers uniform in [-2^(logQ-1), 2^(logQ-1))."""
    nbytes = (log_q + 7) // 8
    raw = rng.integers(0, 256, size=(n, nbytes), dtype=np.uint8)
    raw[:, -1] &= (1 << (log_q - 8 * (nbytes - 1))) - 1
    half = 1 << (log_q - 1)
    return [int.from_bytes(row.tobytes(), "little") - half for row in raw]


@dataclass
class Keys:
    s: np.ndarray            # [phim] in {-1, 0, 1}, weight 64
    c0: np.ndarray           # [phim] Gaussian
    c1: list[int]            # [phim] uniform mod q
    A: list[list[int]]       # KEY_PARTS * ndigits x [phim] uniform mod q
    e: list[np.ndarray]      # KEY_PARTS * ndigits x [phim] Gaussian


@dataclass
class Pool:
    """pool x batch operand pairs; operand o of pair (k, i) is ciphertext
    msgs[k, i, o] under randomness r[k, i, o], errors[k, i, o]."""
    msgs: np.ndarray         # [pool, batch, 2, phim] mod p
    r: np.ndarray            # [pool, batch, 2, phim] in {0, 1}
    errors: np.ndarray       # [pool, batch, 2, 2, phim] Gaussian


def keys(seed: int, ctx: dict, phim: int, ndigits: int) -> Keys:
    rng = _rng(seed, 0)
    s = np.zeros(phim, dtype=np.int64)
    hwt = min(HWT, phim)
    s[rng.choice(phim, hwt, replace=False)] = rng.integers(0, 2, hwt) * 2 - 1
    c0 = _gauss(rng, phim, ctx["stdev"])
    c1 = _uniform_q(rng, phim, ctx["log_q"])
    rows = KEY_PARTS * ndigits
    A = _uniform_q(rng, rows * phim, ctx["log_q"])
    e = _gauss(rng, (rows, phim), ctx["stdev"])
    return Keys(s, c0, c1, [A[k * phim:(k + 1) * phim] for k in range(rows)],
                list(e))


def pool(seed: int, ctx: dict, phim: int, traffic: dict) -> Pool:
    rng = _rng(seed, 1)
    lead = (traffic["pool"], traffic["pairs_per_call"], 2)
    return Pool(msgs=rng.integers(0, ctx["p"], size=lead + (phim,)),
                r=rng.integers(0, 2, size=lead + (phim,)),
                errors=_gauss(rng, lead + (2, phim), ctx["stdev"]))


def checked_pairs(seed: int, traffic: dict) -> list[tuple[int, int]]:
    """The pairs whose outputs the reference judges: traffic
    'checked_pairs' of them, pair k from the k-th equal slice of the
    batch (so a fault in any part of a batch is within reach), each from
    a pool entry drawn apart; no pair twice."""
    rng = _rng(seed, 2)
    n, batch, entries = (traffic["checked_pairs"], traffic["pairs_per_call"],
                         traffic["pool"])
    out: list[tuple[int, int]] = []
    for k in range(n):
        lo, hi = k * batch // n, max((k + 1) * batch // n, k * batch // n + 1)
        while True:
            pair = (int(rng.integers(entries)), int(rng.integers(lo, hi)))
            if pair not in out:
                out.append(pair)
                break
    return out


class Replay:
    """A source of encryption randomness for the program's batched
    encrypt, which draws per ciphertext r, then one error per key part
    (fhe_si_tpu_torch/sampling.sample_encrypt): it hands out the pool's
    draws in that order."""

    def __init__(self, r: np.ndarray, errors: np.ndarray):
        self._r = iter(r.reshape(-1, r.shape[-1]))
        self._e = iter(errors.reshape(-1, errors.shape[-1]))

    def binary_poly(self, n: int) -> np.ndarray:
        return self._next(self._r, n)

    def gaussian_poly(self, n: int, stdev: float) -> np.ndarray:
        return self._next(self._e, n)

    @staticmethod
    def _next(draws, n: int) -> np.ndarray:
        out = next(draws)
        if len(out) != n:
            raise ValueError(f"drawn {len(out)} coefficients, asked for {n}")
        return out
