"""The yardstick of the per-layer roofline shares: the card's peaks, and the
least time each operation of one mul+relin step could take on it.

The counting functions are frozen copies of chip_smoke.py's
(crt_bound, modular_bound, kernel_bound, and time_dense's count for
the dense transform), so a later change of the program cannot move the
yardstick.  Each bound counts what the operation needs by its definition
and its shapes: each int32 input and output byte moved once over the
HBM rate, or its arithmetic over the compute rate that serves it,
whichever is longer; never what one implementation happens to do.  At
the benchmark's shapes every bound is set by bytes.

Peaks: NVIDIA's H100 SXM data sheet (dense, at the 700 W power limit):
HBM3 3.35 TB/s, int8 tensor cores 1,979 TOP/s, FP64 tensor cores
67 TFLOP/s.  INT32_OPS_PER_S is not published: it is derived from the
SM count, the INT32 lanes per SM and the boost clock, and enters only
the operation counts of the limb/CRT and modular kernels.
"""
from __future__ import annotations

from dataclasses import dataclass

HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
F64_OPS_PER_S = 67e12
# derived, not published: 132 SMs x 64 INT32 lanes x 1.98 GHz, a
# multiply-add or a three-input add counted as two operations
INT32_OPS_PER_S = 33.5e12
LIMB_BITS = 16


def _bound(nbytes: float, ops: float, ops_per_s: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def crt_bound(name: str, rows: int, L: int, n: int, width: int,
              phim: int) -> tuple[float, str]:
    """Least time (ms) of one limb/CRT call and what sets it.
    crt_to_limbs (L residues -> width limbs), per coefficient: for each
    residue row n multiply-adds into the limb sums and 2 for its m_r and
    er terms, then 12 for the wrap count, a multiply-add per limb for its
    subtraction and 3 per limb for the carry chain.  limbs_to_residues
    (n limbs -> L residues): per coefficient and prime n multiply-adds
    and 12 for the reduction."""
    coeffs = rows * phim
    if name == "crt_to_limbs":
        nbytes = 4 * coeffs * (L + width)
        ops = coeffs * (L * (2 * n + 4) + 5 * n + 12)
    else:
        nbytes = 4 * coeffs * (n + L)
        ops = coeffs * L * (2 * n + 12)
    return _bound(nbytes, ops, INT32_OPS_PER_S)


def modular_bound(name: str, rows: int, L: int, phim: int,
                  K: int = 0) -> tuple[float, str]:
    """Least time (ms) of one modular call.  tensor_product of 2 x 2
    parts, per residue of a part: 2 scalings by p (a multiply and a
    reduction each), 4 multiply-adds and 3 reductions, 4 words in and 3
    out; keyswitch_dot of K terms, per residue of the output pair: 2K
    multiply-adds and 2 reductions, K digit words in (the [2, K] key
    once) and 2 out; each with its 16-byte table row per prime."""
    coeffs = rows * L * phim
    if name == "tensor_product":
        nbytes = 4 * coeffs * 7 + 16 * L
        ops = coeffs * (2 * (2 + 12) + 2 * 4 + 12 * 3)
    else:
        nbytes = 4 * (coeffs * (K + 2) + 2 * K * L * phim) + 16 * L
        ops = coeffs * (2 * 2 * K + 2 * 12)
    return _bound(nbytes, ops, INT32_OPS_PER_S)


def ntt_bound(name: str, rows: int, L: int, phim: int, N: int, N1: int,
              N2: int) -> tuple[float, str]:
    """Least time (ms) of one transform call: int32 input and output
    (phim wide, the digit transform's input once for all primes) over
    HBM, or the two dense stages of the N-point transform (N (N1 + N2)
    multiply-adds per row and prime, each as 9 int8 byte products of 2
    operations) over the int8 rate."""
    n_in = rows * phim if name == "ct_fwd_digits" else rows * L * phim
    nbytes = 4 * (n_in + rows * L * phim)
    ops = 2 * 9 * rows * L * N * (N1 + N2)
    return _bound(nbytes, ops, INT8_OPS_PER_S)


def dense_bound(rows: int, L: int, phim: int) -> tuple[float, str]:
    """Least time (ms) of one dense transform: per prime one exact
    [phim, phim] x [phim, rows] product, 2 rows L phim^2 operations over
    the FP64 rate, or the float64 table and the int32 input and output,
    each once, over HBM."""
    nbytes = 8 * L * phim * phim + 4 * rows * L * 2 * phim
    return _bound(nbytes, 2 * rows * L * phim * phim, F64_OPS_PER_S)


@dataclass(frozen=True)
class Step:
    """The shapes of one mul+relin call: batch pairs on a ring of
    dimension phim; L primes on the full chain and Lk on the keyswitch
    basis, n and nk limbs to reconstruct over each, n_ct limbs a
    ciphertext coefficient, ndigits digits a part; split = (N, N1, N2)
    of a Cooley-Tukey ring, None on the dense family."""
    batch: int
    phim: int
    L: int
    Lk: int
    n: int
    nk: int
    n_ct: int
    ndigits: int
    split: tuple | None

    def ntt_ms(self) -> float:
        """The four transforms: 4 lifted parts forward, 3 tensored parts
        and 2 keyswitched parts inverse, 3 x ndigits digit rows forward."""
        B, args = self.batch, (self.phim,) + self.split
        return sum(ntt_bound(name, rows, L, *args)[0] for name, rows, L in (
            ("ct_fwd", 4 * B, self.L), ("ct_inv", 3 * B, self.L),
            ("ct_inv", 2 * B, self.Lk),
            ("ct_fwd_digits", 3 * self.ndigits * B, self.Lk)))

    def crt_ms(self) -> float:
        """ScaleDown's reconstruction of 3 tensored parts, the keyswitch
        output's of 2, and the lift of the 4 operand parts."""
        B = self.batch
        return (crt_bound("crt_to_limbs", 3 * B, self.L, self.n, self.n_ct,
                          self.phim)[0]
                + crt_bound("crt_to_limbs", 2 * B, self.Lk, self.nk,
                            self.n_ct, self.phim)[0]
                + crt_bound("limbs_to_residues", 4 * B, self.L, self.n_ct,
                            self.n_ct, self.phim)[0])

    def modular_ms(self) -> float:
        return (modular_bound("tensor_product", self.batch, self.L,
                              self.phim)[0]
                + modular_bound("keyswitch_dot", self.batch, self.Lk,
                                self.phim, 3 * self.ndigits)[0])

    def dense_ms(self) -> float:
        B = self.batch
        return sum(dense_bound(rows, L, self.phim)[0] for rows, L in (
            (4 * B, self.L), (3 * B, self.L),
            (3 * self.ndigits * B, self.Lk), (2 * B, self.Lk)))


def recon_limbs(primes) -> int:
    """Limbs that hold a value centred modulo the product of `primes`."""
    P = 1
    for q in primes:
        P *= int(q)
    return -(-(P.bit_length() + 1) // LIMB_BITS)


def ct_split(m: int) -> tuple:
    """(N, N1, N2) of the Cooley-Tukey transform of an even m: N = m / 2
    points, N1 the least divisor of N not below its square root."""
    N = m // 2
    N1 = next(d for d in range(1, N + 1) if N % d == 0 and d * d >= N)
    return N, N1, N // N1
