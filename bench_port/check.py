"""How `correct` is decided: the outputs that the timed window produced, for
a sample of pairs drawn from the seed (inputs.checked_pairs), against the
plain reference, limb for limb.

For each checked pair the window keeps two outputs: the first call's and
the last call's on its pool entry.  The reference recomputes, from the
seed's draws alone, the public key, the relinearization key, the pair's
two ciphertexts and their product, and writes it as 16-bit two's
complement limbs at the output's width.  The number compared is the count
of limbs that differ (an output of the wrong shape counts every limb);
the limit is 0: the scheme's arithmetic mod 2^logQ is exact.
"""
from __future__ import annotations

import numpy as np

from . import inputs
from .reference import fhe_si

LIMIT = 0


class Judge:
    """The reference's side of one run: the scheme, keys and pool of the
    seed, made once; `want(pair, width)` the limbs of a pair's product."""

    scheme_class = fhe_si.Scheme

    def __init__(self, config: dict, traffic: dict, seed: int):
        c = config["context"]
        self.ref = self.scheme_class(c["m"], c["log_q"], c["p"],
                                     c["decomp_size"])
        keys = inputs.keys(seed, c, self.ref.phim, self.ref.ndigits)
        self.pool = inputs.pool(seed, c, self.ref.phim, traffic)
        self.pk = self.ref.keygen(keys.s, keys.c0, keys.c1)
        self.key = self.ref.relin_key(keys.s, keys.A, keys.e)

    def product(self, pair) -> tuple:
        k, i = pair
        a, b = (self.ref.encrypt(self.pk, self.pool.msgs[k, i, o],
                                 self.pool.r[k, i, o],
                                 self.pool.errors[k, i, o]) for o in range(2))
        return self.ref.mul_relin(a, b, self.key)

    def mismatched(self, pair, outputs) -> tuple[int, int]:
        """(limbs that differ, outputs that differ) of the program's
        outputs [2, phim, width] of one pair."""
        want = None
        limbs = bad = 0
        for got in outputs:
            got = np.asarray(got)
            if got.ndim != 3 or got.shape[:2] != (2, self.ref.phim):
                n = max(got.size, 1)
            else:
                if want is None:
                    want = np.stack([fhe_si.to_limbs(x, got.shape[-1])
                                     for x in self.product(pair)])
                n = int(np.count_nonzero(got != want))
            limbs += n
            bad += n > 0
        return limbs, bad


def judge(config: dict, traffic: dict, seed: int, outputs: dict,
          judge_class=Judge) -> dict:
    """outputs: {pair: [output, ...]} -> the numbers of the check."""
    j = judge_class(config, traffic, seed)
    limbs = bad = judged = 0
    for pair, outs in outputs.items():
        n, b = j.mismatched(pair, outs)
        limbs, bad, judged = limbs + n, bad + b, judged + len(outs)
    return {"mismatched_limbs": limbs, "failed_outputs": bad,
            "judged_outputs": judged}
