"""The dense transform family: exact (T @ x) mod q per prime with dense
phim x phim tables, for every ring that does not ride the Cooley-Tukey
family (m = p - 1 of the reference, m = 22, 46, 31, ...).

Counterpart of fhe_si_tpu/ops/ntt.py.  The JAX package splits the
context's integer tables (FheContext.ntt_tables) into int8 digit planes
and runs them as Karatsuba matmuls on the MXU with a Barrett-Horner
combine; every output there is the canonical residue in [0, q), so any
exact method gives the same tensors.  Here each prime's product is one
float64 matmul, exact while every partial sum stays below 2^53 (integer
products and sums below 2^53 are exact in float64 whatever the order of
the additions, so cuBLAS on the card and BLAS on the CPU agree bit for
bit).  The digit-plane helpers of the JAX package (chunk_matrix,
chunk_x*, karatsuba_groups, horner_combine, digit_cross_groups) are the
MXU's encoding of these residues and have no counterpart here.

A product sums n_in terms below (q_max - 1)^2 (below (q_max - 1) * y_max
for inputs in [0, y_max], as the Cooley-Tukey route's digit stage has,
ops/ntt_ct_matmul.py):
  narrow lane (q < 2^20): n_in * 2^40 < 2^53 for n_in <= 8192, and the
    dense family stops at phim = 4096 (context.py), so one matmul;
  wide lane (q < 2^23): one matmul only below n_in = 128.  Past it the
    table is split at 12 bits into two exact matmuls (n_in * 2^11 * 2^23
    and n_in * 2^12 * 2^23 stay below 2^53 for n_in < 2^18), joined mod q
    as ops/ntt_ct._stage does.
`operands` makes the float64 operands of a table once (DeviceContext
keeps them on the device, built by `device_operands`); `modmatmul` runs
them.
"""
from __future__ import annotations

import numpy as np
import torch

from ..profiling import annotate

F64_EXACT = 1 << 53
SPLIT_BITS = 12
SPLIT_MASK = (1 << SPLIT_BITS) - 1


def needs_split(n_in: int, q_max: int, y_max: int | None = None) -> bool:
    """True when one float64 matmul of n_in terms, each a table entry
    below q_max times an input in [0, y_max] (default q_max - 1: a
    residue), could leave the exact range (the module header's lane
    bounds)."""
    y_max = q_max - 1 if y_max is None else y_max
    return n_in * y_max * (q_max - 1) >= F64_EXACT


def operands(tab, q_max: int, y_max: int | None = None) -> tuple:
    """Integer table [L, n_out, n_in] (entries in [0, q)) -> the float64
    operands of modmatmul for inputs in [0, y_max] (default residues):
    (tab,) when one matmul is exact, else the 12-bit split (tab >> 12,
    tab & 4095)."""
    tab = torch.as_tensor(np.asarray(tab, dtype=np.int64))
    if needs_split(tab.shape[-1], q_max, y_max):
        return ((tab >> SPLIT_BITS).to(torch.float64),
                (tab & SPLIT_MASK).to(torch.float64))
    return (tab.to(torch.float64),)


def device_operands(slabs, count: int, q_max: int, device,
                    y_max: int | None = None) -> tuple:
    """The operands of a table of `count` primes on `device`, made from
    its integer slabs [1, n_out, n_in] one prime at a time, so the host
    holds one float64 slab and the device one copy of each operand."""
    out = None
    for l, slab in enumerate(slabs):
        ops = operands(slab, q_max, y_max)
        if out is None:
            out = tuple(torch.empty((count,) + op.shape[1:], dtype=op.dtype,
                                    device=device) for op in ops)
        for o, op in zip(out, ops):
            o[l] = op[0]
    return out


def with_crt_premultiplier(tab: np.ndarray, binv, q) -> np.ndarray:
    """tab[l] * binv[l] mod q[l] for an integer table [L, n_out, n_in],
    with 1 in place of the redundant row's binv of 0: the per-row CRT
    premultiplier folded into an inverse table on the host, so its output
    feeds crt.residues_to_limbs_fast(prescaled=True).  Host-side
    equivalent of the JAX package's on-device prescale_planes
    (device.py prescale_inv), as ntt_ct.with_crt_premultiplier is for
    the CT tables; one prime at a time keeps the int64 temporaries at
    one slab."""
    binv = np.asarray(binv, dtype=np.int64)
    scale = np.where(binv == 0, 1, binv)
    q = np.asarray(q, dtype=np.int64).reshape(-1)
    out = np.empty(tab.shape, dtype=np.int32)
    for l in range(tab.shape[0]):
        out[l] = tab[l].astype(np.int64) * int(scale[l]) % int(q[l])
    return out


def modmatmul(tab, x, q):
    """Exact (tab @ x) mod q per prime.

    tab: the operands of one table from `operands` (a tuple of float64
         [L, n_out, n_in] tensors on x's device)
    x:   int32 [..., L, n_in], residues in [0, q)
    q:   [L, 1] integer tensor of the primes
    returns int32 [..., L, n_out], canonical residues.

    The lead dims fold into the matmul's column dimension, so each prime
    is one [n_out, n_in] x [n_in, rows] product, batched over L (the JAX
    package flattens its lead dims for the same reason, ntt.py:356-366).
    """
    with annotate("fhe.modmatmul"):
        q64 = q.to(torch.int64)
        *lead, L, n_in = x.shape
        n_out = tab[0].shape[-2]
        if tab[0].shape[-1] != n_in or tab[0].shape[0] != L:
            raise ValueError(f"modmatmul: table {tuple(tab[0].shape)} does "
                             f"not take input {tuple(x.shape)}")
        cols = x.reshape(-1, L, n_in).permute(1, 2, 0).to(torch.float64)
        if len(tab) == 1:
            r = torch.matmul(tab[0], cols).to(torch.int64) % q64[..., None]
        else:
            hi = torch.matmul(tab[0], cols).to(torch.int64) % q64[..., None]
            lo = torch.matmul(tab[1], cols).to(torch.int64)
            r = (hi * (1 << SPLIT_BITS) + lo) % q64[..., None]
        return r.permute(2, 0, 1).to(torch.int32).reshape(*lead, L, n_out)
