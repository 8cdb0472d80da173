"""Encrypted ordinary least squares (reference Regression.h:14-216) over
the port's scheme layer.

Counterpart of fhe_si_tpu/apps/regression.py without prewarm_async (a
TPU compile workaround).  The host helpers (load_data, batch_data,
regress_pt, derive_log_q) are copies of the JAX package's.
theta_i = adj(X^T X) . (X^T y) and det are returned encrypted; the
caller divides by det after decryption.
"""
from __future__ import annotations

import numpy as np

from .. import sampling, scheme
from ..context import FheContext
from ..device import DeviceContext
from .matrix import Matrix


def load_data(filename: str):
    """Reference LoadData (Regression.h:14-41): first line 'd n', then n
    lines of d features + 1 label."""
    try:
        with open(filename) as f:
            tokens = f.read().split()
    except OSError as e:
        raise SystemExit(f"Unable to read data file: {e}")
    dim, n = int(tokens[0]), int(tokens[1])
    vals = [int(t) for t in tokens[2:2 + n * (dim + 1)]]
    raw = Matrix()
    labels = []
    for i in range(n):
        row = vals[i * (dim + 1):(i + 1) * (dim + 1)]
        raw.add_row(row[:dim])
        labels.append(row[dim])
    return raw, labels, dim


def batch_data(ctx: FheContext, raw_data: Matrix, labels: list[int]):
    """Reference BatchData (Regression.h:43-66): usableSlots rows per batch,
    one plaintext per (batch, column), plus label plaintexts."""
    batch = ctx.usable_slots
    ptxt_data, ptxt_labels = [], []
    n, d = raw_data.num_rows(), raw_data.num_cols()
    for i in range(0, n, batch):
        hi = min(i + batch, n)
        row = [scheme.Plaintext.from_slots(
                   ctx, [raw_data.at(k, j) % ctx.p for k in range(i, hi)])
               for j in range(d)]
        ptxt_data.append(row)
        ptxt_labels.append(scheme.Plaintext.from_slots(
            ctx, [labels[k] % ctx.p for k in range(i, hi)]))
    return ptxt_data, ptxt_labels


def automorph_keys(sk: scheme.FheSecretKey, source: sampling.RandomSource
                   ) -> list[tuple[int, scheme.KeySwitch]]:
    """Keys for the rotations by g^(2^i) that sum the usable slots
    (Regression.h:70-81, Statistics.h:17-27)."""
    ctx = sk.ctx
    out = []
    k, n_slots = ctx.generator, ctx.usable_slots
    while n_slots > 1:
        out.append((k, scheme.KeySwitch.for_automorph(sk, k, source)))
        n_slots >>= 1
        k = k * k % ctx.m
    return out


class Regression:
    """Reference Regression class (Regression.h:68-191)."""

    def __init__(self, dev: DeviceContext, source: sampling.RandomSource):
        self.ctx = dev.ctx
        self.source = source
        self.secret_key, self.public_key = scheme.keygen(dev, source)
        self.key_switch = scheme.KeySwitch.for_relinearization(
            self.secret_key, source)
        self.rotations = automorph_keys(self.secret_key, source)
        self.data = Matrix()
        self.labels: list[scheme.Ciphertext] = []

    def add_data(self, ptxt_data, ptxt_labels):
        """Encrypt every batched cell + labels (Regression.h:83-95), one
        batched encrypt per block row."""
        for row, label in zip(ptxt_data, ptxt_labels):
            cts = self.public_key.encrypt_batch(list(row) + [label],
                                                self.source)
            self.data.add_row(cts[:-1])
            self.labels.append(cts[-1])

    def clear(self):
        self.data = Matrix()
        self.labels = []

    def _noise(self) -> scheme.Ciphertext:
        """Random values in every slot but slot 0 (Regression.h:180-190)."""
        vals = self.source.uniform_mod_p(self.ctx.total_slots, self.ctx.p)
        vals[0] = 0
        pt = scheme.Plaintext.from_slots(self.ctx, vals, only_usable=False)
        return self.public_key.encrypt(pt, self.source)

    def regress(self):
        """Regression.h:102-149. Returns (theta: list[Ciphertext], det)."""
        ksw = self.key_switch
        data_t = self.data.transpose()
        d, nb = data_t.num_rows(), data_t.num_cols()
        # X^T y and the upper triangle of X^T X as one batched product
        # (the block-product sums of Matrix.cpp:81-97, 150-174)
        tri = [(i, j) for i in range(d) for j in range(i, d)]
        pairs = ([(data_t.at(i, b), self.labels[b])
                  for i in range(d) for b in range(nb)]
                 + [(data_t.at(i, b), data_t.at(j, b))
                    for i, j in tri for b in range(nb)])
        sums = scheme.combine_signed_batch(
            scheme.mul_batch(pairs), [1] * len(pairs), nb)
        xtx = [[None] * d for _ in range(d)]
        for (i, j), ct in zip(tri, sums[d:]):
            xtx[i][j] = xtx[j][i] = ct
        # MapAll{keyswitch; SumBatchedData}, batched
        entries = sums[:d] + [xtx[i][j] for i in range(d) for j in range(d)]
        processed = scheme.keyswitch_sum_batch(entries, ksw, self.rotations)
        last = processed[:d]
        xtx = Matrix([processed[d + i * d:d + (i + 1) * d] for i in range(d)])

        if self.data.num_cols() == 1:
            return [last[0]], xtx.at(0, 0)

        # adjugate inverse and theta = adj(X^T X) . X^T y, one batched call
        # per cofactor level (Matrix.cpp:182-263)
        reduce_many = lambda cts: scheme.relin_batch(cts, ksw)  # noqa: E731
        inv, det = xtx.invert_batched(
            scheme.mul_batch, scheme.combine_signed_batch, reduce_many,
            scheme.scalar_mul_batch)
        pairs = [(inv.at(i, k), last[k]) for i in range(d) for k in range(d)]
        theta_cts = reduce_many(scheme.combine_signed_batch(
            scheme.mul_batch(pairs), [1] * (d * d), d))

        theta = [theta_cts[i] + self._noise() for i in range(d)]
        det = det + self._noise()
        return theta, det


def regress_pt(raw_data: Matrix, labels: list[int]):
    """Plaintext oracle RegressPT (Regression.h:193-214): exact integers."""
    a = raw_data.transpose()
    tmp = a.mul_vector(labels)
    ata = a.mult_by_transpose()
    if raw_data.num_cols() == 1:
        return [tmp.at(0, 0)], ata.at(0, 0)
    inv, det = ata.invert()
    theta_m = inv @ tmp
    return [theta_m.at(i, 0) for i in range(theta_m.num_rows())], det


def derive_log_q(n_points: int, dim: int, p: int) -> tuple[int, int]:
    """Test_Regression.cpp:85-108 parameter derivation: returns (logQ, xi)."""
    block_size = 1
    val = (p - 1) // 2 - 1
    while val > 1:
        block_size <<= 1
        val >>= 1
    n = (p - 1) // 2 - 1
    n_blocks = (n_points + block_size - 1) // block_size
    xi = max(n_blocks, dim)
    lg_q = (4.5 * np.log(n)
            + max(1, dim - 1) * (np.log(1280.0) + 2 * np.log(n) + np.log(xi)))
    return int(np.ceil(lg_q / np.log(2) + 24.7)), xi
