"""A Hopper kernel for the digit split of the keyswitch, and its wrapper.

The JAX package has no Pallas kernel here: ByteDecomp
(fhe_si_tpu/ops/limbs.py:236 byte_decomp) and the moveaxis/reshape that
fhe_si_tpu/device.py:628 _digit_evals applies to its digits are jnp code
that XLA fuses into one pass on the TPU.  Run eagerly, the plain version
(ops/limbs.py byte_decomp, then the digits' movedim/reshape copy, then on
a dense ring the per-prime `%`) is 21 launches per mul+relin step at
m = 8192, 38 on the dense ring, each over the whole limb tensor.
byte_decomp_kernel of fhe_si_tpu_torch/csrc/digits.cu takes its place,
built and loaded like the other sources of csrc/ (cuda_build.library)
and launched through cuda_build.launch:
it reads the limbs once and writes the digits once, in the layout the
digits' forward transform reads, or, given a table of primes, their
residues modulo each prime.

Dispatch: a tensor on the CPU takes the plain version (byte_decomp_plain,
the composition DeviceContext ran before); a tensor on a CUDA device
launches the kernel, or raises.  There is no fallback.  The host checks
dtypes, contiguity and what the kernel rests on (digits.cu header; the
limits of cuda_build): digits of at most MAX_DIGIT_BITS bits, 16 n >=
logQ, at most MAX_LIMBS limbs and MAX_ROWS primes, fewer than 2^31
coefficients a launch.  cuda_build.LAUNCHES counts the kernel's launches.
"""
from __future__ import annotations

import torch

from ..profiling import annotate
from . import limbs as lb
from .cuda_build import (MAX_DIGIT_BITS, MAX_LIMBS, MAX_ROWS, check_coeffs,
                         launch, on_cuda)


def byte_decomp_plain(parts, log_q: int, digit_bits: int, ndigits: int,
                      primes=None):
    """ops/limbs.py byte_decomp with the digits moved before the
    coefficients; with primes ([Lk] or [Lk, 1]), each digit's residue
    modulo each prime."""
    digs = lb.byte_decomp(parts, log_q, digit_bits, ndigits, None)
    digs = digs.movedim(-1, -2)                       # [..., nd, phim]
    if primes is None:
        return digs.contiguous()
    return digs[..., None, :] % primes.reshape(-1, 1)  # [..., nd, Lk, phim]


def _check(parts, log_q: int, digit_bits: int, ndigits: int, primes):
    """Raise ValueError, with the input's shape, unless the kernel takes
    these operands."""
    shape = tuple(parts.shape)
    if parts.dtype != torch.int32 or not parts.is_contiguous() \
            or parts.dim() < 2:
        raise ValueError(f"byte_decomp: limbs {shape} {parts.dtype} are not a "
                         "contiguous int32 [..., phim, n] tensor")
    n = parts.shape[-1]
    if not 1 <= digit_bits <= MAX_DIGIT_BITS or ndigits < 1:
        raise ValueError(f"byte_decomp: limbs {shape}: {ndigits} digits of "
                         f"{digit_bits} bits; the kernel takes digits of 1 to "
                         f"{MAX_DIGIT_BITS} bits (byte_decomp_planes beyond)")
    if not (1 <= log_q <= 16 * n and n <= MAX_LIMBS):
        raise ValueError(f"byte_decomp: limbs {shape} for logQ {log_q}: the "
                         f"kernel takes 16 n >= logQ and n <= {MAX_LIMBS}")
    check_coeffs("byte_decomp", shape, parts.numel() // n)
    if primes is not None and (
            primes.dtype != torch.int32 or primes.device != parts.device
            or not 1 <= primes.numel() <= MAX_ROWS):
        raise ValueError(f"byte_decomp: limbs {shape}: primes "
                         f"{tuple(primes.shape)} {primes.dtype} on "
                         f"{primes.device}; the kernel takes 1 to "
                         f"{MAX_ROWS} int32 primes on {parts.device}")


def byte_decomp(parts, log_q: int, digit_bits: int, ndigits: int,
                primes=None):
    """ByteDecomp (Ciphertext.cpp:82-121) of limbs [..., phim, n]: the
    digits of the positive representative mod 2^logQ as [..., nd, phim],
    or, with primes ([Lk] or [Lk, 1], int32), each digit modulo each prime
    as [..., nd, Lk, phim].  Equal to byte_decomp_plain."""
    with annotate("fhe.byte_decomp"):
        if not on_cuda(parts):
            return byte_decomp_plain(parts, log_q, digit_bits, ndigits,
                                     primes)
        _check(parts, log_q, digit_bits, ndigits, primes)
        lead, (phim, n) = parts.shape[:-2], parts.shape[-2:]
        lk = 0 if primes is None else primes.numel()
        if primes is not None:
            primes = primes.contiguous()
        out = torch.empty(lead + (ndigits,) + ((lk,) if lk else ()) + (phim,),
                          dtype=torch.int32, device=parts.device)
        if out.numel():
            launch("byte_decomp", "fsi_byte_decomp", (parts, primes, out),
                   (parts.numel() // (phim * n), phim, n, log_q, digit_bits,
                    ndigits, lk))
        return out
