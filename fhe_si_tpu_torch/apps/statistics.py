"""Encrypted mean / second moment / covariance (reference
Statistics.h:12-208) over the port's scheme layer.

Counterpart of fhe_si_tpu/apps/statistics.py without prewarm_async.  The
host helpers are copies of the JAX package's.  Covariance follows the reference formula n * sum(x x^T) - mu mu^T
with rotate-and-reduce slot sums and noise masking of non-first slots.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import sampling, scheme
from ..context import FheContext
from ..device import DeviceContext
from .matrix import Matrix
from .regression import automorph_keys


def load_data(filename: str):
    """Statistics-side LoadData (Test_Statistics.cpp:9-33): labels ignored."""
    try:
        with open(filename) as f:
            tokens = f.read().split()
    except OSError as e:
        raise SystemExit(f"Unable to read data file: {e}")
    dim, n = int(tokens[0]), int(tokens[1])
    vals = [int(t) for t in tokens[2:2 + n * (dim + 1)]]
    data = Matrix()
    for i in range(n):
        row = vals[i * (dim + 1):(i + 1) * (dim + 1)]
        data.add_row(row[:dim])
    return data, dim


def batch_data(ctx: FheContext, raw_data: Matrix):
    """Test_Statistics.cpp:35-64: per-batch plaintext blocks + block sizes."""
    batch = ctx.usable_slots
    blocks, block_sizes = [], []
    n, d = raw_data.num_rows(), raw_data.num_cols()
    for i in range(0, n, batch):
        hi = min(i + batch, n)
        row = [scheme.Plaintext.from_slots(
                   ctx, [raw_data.at(k, j) % ctx.p for k in range(i, hi)])
               for j in range(d)]
        blocks.append(row)
        block_sizes.append(scheme.Plaintext(ctx, [(hi - i) % ctx.p]))
    return blocks, block_sizes


class Statistics:
    """Reference Statistics class (Statistics.h:12-171)."""

    def __init__(self, dev: DeviceContext, source: sampling.RandomSource):
        self.dev = dev
        self.ctx = dev.ctx
        self.source = source
        self.secret_key, self.public_key = scheme.keygen(dev, source)
        self.key_switch = scheme.KeySwitch.for_relinearization(
            self.secret_key, source)
        self.rotations = automorph_keys(self.secret_key, source)
        self.data = Matrix()
        self.n_elems: list[scheme.Ciphertext] = []

    def add_data(self, blocks, block_sizes):
        """Statistics.h:29-41, one batched encrypt per block."""
        for row, bs in zip(blocks, block_sizes):
            cts = self.public_key.encrypt_batch(list(row) + [bs], self.source)
            self.data.add_row(cts[:-1])
            self.n_elems.append(cts[-1])

    def _noise(self):
        vals = self.source.uniform_mod_p(self.ctx.total_slots, self.ctx.p)
        vals[0] = 0
        pt = scheme.Plaintext.from_slots(self.ctx, vals, only_usable=False)
        return self.public_key.encrypt(pt, self.source)

    def compute_nth_moment(self, n: int):
        """Statistics.h:48-84: returns (moment: list[Ciphertext], denom)."""
        if n < 1 or n > 2:
            raise ValueError("only moments 1 and 2 are supported")
        cols = self.data.num_cols()
        rows = self.data.num_rows()
        denom = self.n_elems[0]
        for i in range(1, rows):
            denom = denom + self.n_elems[i]
        if n == 2:
            # all squares in one batch, then per-column block sums
            pairs = [(self.data.at(i, j), self.data.at(i, j))
                     for j in range(cols) for i in range(rows)]
            moments = scheme.keyswitch_sum_batch(
                scheme.combine_signed_batch(scheme.mul_batch(pairs),
                                            [1] * len(pairs), rows),
                self.key_switch, self.rotations)
        else:
            moments = []
            for j in range(cols):
                acc = self.data.at(0, j)
                for i in range(1, rows):
                    acc = acc + self.data.at(i, j)
                moments.append(acc)
            moments = scheme.sum_batch_only(moments, self.rotations)
        return [mj + self._noise() for mj in moments], denom

    def compute_covariance(self):
        """Statistics.h:86-128: returns (cov: Matrix, mu: list, n, n2)."""
        ksw = self.key_switch
        mu, n_ct = self.compute_nth_moment(1)

        d = self.data.num_cols()
        nb = self.data.num_rows()
        pairs = [(i, j) for i in range(d) for j in range(i, d)]

        # -mu_i*mu_j upper triangle: one batched mul + relin + negate
        mu_vals = scheme.scalar_mul_batch(
            scheme.relin_batch(scheme.mul_batch([(mu[i], mu[j])
                                                 for i, j in pairs]), ksw),
            [-1] * len(pairs))

        # X^T X upper triangle block sums, batched (MultByTranspose,
        # Matrix.cpp:150-174)
        data_t = self.data.transpose()
        cov_pairs = [(data_t.at(i, b), data_t.at(j, b))
                     for i, j in pairs for b in range(nb)]
        cov_entries = scheme.combine_signed_batch(
            scheme.mul_batch(cov_pairs), [1] * len(cov_pairs), nb)
        # keyswitch + rotate-reduce, then times n as one batched mul+relin
        summed = scheme.keyswitch_sum_batch(cov_entries, ksw, self.rotations)
        stack = torch.stack([c.parts for c in summed])
        prod = self.dev.mul_relin(stack, n_ct.parts.expand(stack.shape),
                                  ksw.matrix_evals)
        out = Matrix([[None] * d for _ in range(d)])
        for idx, (i, j) in enumerate(pairs):
            c = scheme.Ciphertext(self.dev, parts=prod[idx])
            c = c + mu_vals[idx]
            c = c + self._noise()
            out.set(i, j, c)
            out.set(j, i, c)

        n2 = ksw.apply(n_ct * n_ct)
        return out, mu, n_ct, n2


# ------------------------------------------------------------ plaintext oracles
def compute_nth_moment_pt(data: Matrix, n: int) -> list[int]:
    """Statistics.h:173-184."""
    return [sum(data.at(i, j) ** n for i in range(data.num_rows()))
            for j in range(data.num_cols())]


def compute_covariance_pt(data: Matrix) -> Matrix:
    """Statistics.h:191-208:  n * (X^T X) - mu mu^T  over exact ints."""
    cov = data.transpose().mult_by_transpose()
    n = data.num_rows()
    cov = Matrix([[cov.at(i, j) * n for j in range(cov.num_cols())]
                  for i in range(cov.num_rows())])
    mu = compute_nth_moment_pt(data, 1)
    mu_mat = Matrix([list(mu)]).transpose().mult_by_transpose()
    return cov - mu_mat


def derive_log_q(n_points: int, dim: int, p: int) -> tuple[int, int]:
    """Test_Statistics.cpp:194-217 parameter derivation: (logQ, xi)."""
    block_size = 1
    val = (p - 1) // 2
    while val > 1:
        block_size <<= 1
        val >>= 1
    n = (p - 1) // 2 - 1
    n_blocks = (n_points + block_size - 1) // block_size
    xi = max(n_blocks, dim)
    lg_q = 6.5 * np.log(n) + np.log(xi)
    return int(np.ceil(lg_q / np.log(2) + 36.1)), xi
