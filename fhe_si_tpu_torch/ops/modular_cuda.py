"""Hopper kernels for the evaluation-domain products of mul+relin, and
their wrappers.

The JAX package has no Pallas kernel here: the tensor product of
fhe_si_tpu/device.py _tensor_mul (:558-582: every a-part scaled by p,
then out[k] = sum_{i+j=k} a_i b_j, by ops/modular.py mod_mul and
mod_add) and the keyswitch dot of _keyswitch_digits (:693, ops/modular.py
mod_dot) are jnp code that XLA fuses on the TPU.  Run eagerly, the plain
versions (the *_plain functions here, made of ops/modular.py as
DeviceContext composed them) are dozens of launches over the whole
[..., L, phim] tensor per product.  Two kernels of
fhe_si_tpu_torch/csrc/modular.cu take their place, built and loaded like
the other sources of csrc/ (cuda_build.library) and launched through
cuda_build.launch:

  tensor_product  p*a tensored with b, a [..., na, L, phim] and
                  b [..., nb, L, phim] -> [..., na+nb-1, L, phim]; a and b
                  may be the two halves of one lifted tensor (views, read
                  through their lead strides, no copy);
  keyswitch_dot   the key matrix [2, K, L, phim] dotted with the digits'
                  evaluations [..., K, L, phim] over K -> [..., 2, L, phim],
                  the lead axes broadcast inside the kernel.

Dispatch: a tensor on the CPU takes the plain version; a tensor on a CUDA
device launches the kernel, or raises.  There is no fallback.  The host
checks dtypes, layouts, shapes and what the kernels' exactness rests on
(modular.cu header): primes in [2, 2^23), at most MAX_PARTS parts a side,
at most MAX_TERMS terms in a dot.  DeviceContext checks its bases' primes
and its keyswitch width (check_shape, on the host tables) when it is
built on a CUDA device.  Both kernels read a basis' kernel_table
(T['k_mod'], which DeviceContext builds); the plain versions read T's
q, qinv_f and p_mod_q.
cuda_build.LAUNCHES counts the launches of each kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from ..profiling import annotate
from . import modular
from .cuda_build import check_primes, launch, on_cuda

# modular.cu kMaxParts: a side of the tensor product.  The repo's callers
# pass at most 3 (a ScaleDown view of a product times a ciphertext,
# tests/test_torch_scheme_ops.py add_tensored_tail); 4 is the most parts a
# ciphertext may have and still be relinearized (context.MAX_KSW_PARTS).
MAX_PARTS = 4
# modular.cu kMaxTerms: MAX_KSW_PARTS times the most digits a context the
# limb/CRT kernels take can make (logQ below 16 * 48 bits in 8-bit digits,
# decompSize 1: 96 digits); the sum of as many products stays below 2^55.
MAX_TERMS = 4 * 96
ROW_WORDS = 4          # per row: q, p mod q, floor(2^64 / q) lo, hi


def kernel_table(primes, p: int) -> np.ndarray:
    """The table both kernels read, per residue row: int32 words q,
    p mod q and mu = floor(2^64 / q) as its low and high words (the bit
    patterns of uint32), [rows, ROW_WORDS]."""
    q = [int(v) for v in np.asarray(primes).ravel()]
    words = [[v, p % v, ((1 << 64) // v) & 0xFFFFFFFF, (1 << 64) // v >> 32]
             for v in q]
    return np.array(words, np.uint64).astype(np.uint32).view(np.int32)


def check_shape(name: str, shape, primes, terms: int | None = None):
    """Raise ValueError, with the input's shape, unless every prime of a
    basis (a numpy array) lies in [2, 2^23) and, where given, a dot of
    `terms` terms is within MAX_TERMS."""
    check_primes(name, shape, primes)
    if terms is not None and not 1 <= terms <= MAX_TERMS:
        raise ValueError(f"{name}: input {tuple(shape)}: a dot of {terms} "
                         f"terms; the kernel takes at most {MAX_TERMS}")


# ------------------------------------------------------- plain versions
def tensor_product_plain(a, b, p_mod_q, q, qinv_f, wide: bool = False):
    """p * a tensored with b with ops/modular.py: [..., na, L, phim] x
    [..., nb, L, phim] -> [..., na+nb-1, L, phim]."""
    na, nb = a.shape[-3], b.shape[-3]
    a = modular.mod_mul(a, p_mod_q, q, qinv_f, wide)
    out = [None] * (na + nb - 1)
    for i in range(na):
        for j in range(nb):
            pr = modular.mod_mul(a[..., i, :, :], b[..., j, :, :], q, qinv_f,
                                 wide)
            k = i + j
            out[k] = pr if out[k] is None else modular.mod_add(out[k], pr, q)
    return torch.stack(out, dim=-3)


def keyswitch_dot_plain(mat, digits, q, qinv_f, wide: bool = False):
    """ops/modular.py mod_dot of mat [2, K, L, phim] with digits
    [..., K, L, phim] broadcast over the matrix rows -> [..., 2, L, phim]."""
    return modular.mod_dot(mat, digits[..., None, :, :, :], q, qinv_f,
                           axis=-3, wide=wide)


# ------------------------------------------------------------- launches
def _table(name: str, T: dict, shape, L: int):
    tab = T.get('k_mod')
    if tab is None or tuple(tab.shape) != (L, ROW_WORDS):
        raise ValueError(f"{name}: input {tuple(shape)}: the tables lack k_mod "
                         f"for {L} rows; build it with modular_cuda."
                         "kernel_table (DeviceContext does)")
    return tab


def _parts(x, L: int, phim: int):
    """x [..., k, L, phim] as [R, k, L, phim] whose parts are contiguous
    [L, phim] blocks (a view where x is one, such as a slice of the parts
    axis), and its lead stride in words: the kernels read the parts
    through it, so the launch checks no operand's contiguity."""
    x = x.reshape((-1,) + tuple(x.shape[-3:]))
    if any(s != want for s, want, n in zip(x.stride()[1:], (L * phim, phim, 1),
                                           x.shape[1:]) if n > 1):
        x = x.contiguous()
    return x, x.stride(0)


def tensor_product_operands(a, b, T: dict):
    """The host checks of tensor_product: (a, b as [R, k, L, phim] with
    their lead strides, the table, the output's shape)."""
    name = "tensor_product"
    if a.dim() < 3 or a.shape[:-3] != b.shape[:-3] \
            or a.shape[-2:] != b.shape[-2:]:
        raise ValueError(f"{name}: parts {tuple(a.shape)} and {tuple(b.shape)}"
                         " differ in their lead or residue shapes")
    na, nb = a.shape[-3], b.shape[-3]
    if not (1 <= na <= MAX_PARTS and 1 <= nb <= MAX_PARTS):
        raise ValueError(f"{name}: parts {tuple(a.shape)} x {tuple(b.shape)}; "
                         f"the kernel takes 1 to {MAX_PARTS} parts a side")
    L, phim = a.shape[-2:]
    tab = _table(name, T, a.shape, L)
    (a2, sa), (b2, sb) = _parts(a, L, phim), _parts(b, L, phim)
    return a2, sa, b2, sb, tab, a.shape[:-3] + (na + nb - 1, L, phim)


def tensor_product(a, b, T: dict, wide: bool = False):
    """p * a tensored with b over the rows of basis T: a [..., na, L, phim]
    and b [..., nb, L, phim] canonical residues -> [..., na+nb-1, L, phim],
    element for element tensor_product_plain with T's p_mod_q."""
    with annotate("fhe.tensor_product"):
        if not on_cuda(a):
            return tensor_product_plain(a, b, T['p_mod_q'], T['q'],
                                        T['qinv_f'], wide)
        a2, sa, b2, sb, tab, shape = tensor_product_operands(a, b, T)
        out = torch.empty(shape, dtype=torch.int32, device=a.device)
        if out.numel():
            R, na, L, phim = a2.shape
            launch("tensor_product", "fsi_tensor_product", (a2, b2, tab, out),
                   (sa, sb, R, L, phim, na, b2.shape[1]), int32=True)
        return out


def keyswitch_dot_operands(mat, digits, T: dict):
    """The host checks of keyswitch_dot: (mat, digits as [R, K, L, phim],
    the table, the output's shape)."""
    name = "keyswitch_dot"
    if mat.dim() != 4 or mat.shape[0] != 2 or digits.dim() < 3 \
            or digits.shape[-3:] != mat.shape[1:]:
        raise ValueError(f"{name}: matrix {tuple(mat.shape)} and digits "
                         f"{tuple(digits.shape)}: expected [2, K, L, phim] and "
                         "[..., K, L, phim]")
    K, L, phim = mat.shape[1:]
    if not 1 <= K <= MAX_TERMS:
        raise ValueError(f"{name}: digits {tuple(digits.shape)}: a dot of {K} "
                         f"terms; the kernel takes at most {MAX_TERMS}")
    tab = _table(name, T, digits.shape, L)
    return (mat.contiguous(), digits.reshape(-1, K, L, phim).contiguous(), tab,
            digits.shape[:-3] + (2, L, phim))


def keyswitch_dot(mat, digits, T: dict, wide: bool = False):
    """sum_k mat[j, k] * digits[..., k] mod q over the rows of basis T:
    mat [2, K, L, phim], digits [..., K, L, phim] canonical residues ->
    [..., 2, L, phim], element for element keyswitch_dot_plain."""
    with annotate("fhe.keyswitch_dot"):
        if not on_cuda(digits):
            return keyswitch_dot_plain(mat, digits, T['q'], T['qinv_f'], wide)
        mat, dig, tab, shape = keyswitch_dot_operands(mat, digits, T)
        out = torch.empty(shape, dtype=torch.int32, device=digits.device)
        if out.numel():
            R, K, L, phim = dig.shape
            launch("keyswitch_dot", "fsi_keyswitch_dot", (mat, dig, tab, out),
                   (R, L, phim, K), int32=True)
        return out
