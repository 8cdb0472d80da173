"""The matmul route's boundary kernels on a split N x 1, and their
wrappers.

On the reference's rings m = p - 1 with N = m/2 prime the Cooley-Tukey
split is N x 1: stage 1 of every transform is a 1 x 1 table per prime,
one residue, and stage 2 one N x N float64 GEMM per prime
(ops/ntt_ct_matmul.py).  `folded_table` folds the 1 x 1 stage into the
twiddle on the host, once; a transform is then three launches: `enter`,
the GEMM, `leave`.  enter writes the GEMM's float64 operand from int32
residues (the forward: pad_to_N, the folded twiddle; the digits: the same
from prime-independent digits, read once for all primes; the inverse:
insert_excluded), leave reduces the GEMM's exact float64 output mod q and
writes int32 residues (the forward: drop_excluded; the inverse: the
folded inverse twiddle and fold_mod_phim).  The JAX package has no
Pallas kernel here: there these steps are XLA-fused around its stage
products (fhe_si_tpu/ops/ntt_ct.py:327-380).  route_enter_kernel and
route_leave_kernel of fhe_si_tpu_torch/csrc/route.cu take their place,
built and loaded like the other sources of csrc/ (cuda_build.library)
and launched through cuda_build.launch.

Layouts (R rows, L primes, phim = N - 1):
  enter: x [R, L, phim] ("fwd", "inv") or [R, phim] ("fwd_digits")
         -> y [R, L, N] float64, whose [L, N, R] view is the GEMM's operand
  leave: z [L, N, R] float64, the GEMM's output -> [R, L, phim] int32

Dispatch: a tensor on the CPU takes the plain version (enter_plain,
leave_plain: the same function in int64 torch); a tensor on a CUDA
device launches the kernel, or raises.  There is no fallback.  The host
checks dtypes, shapes and what the kernels rest on (route.cu header): a
split N x 1 of an odd N (phim = N - 1) and at most MAX_ROWS primes; the
chain's primes lie below 2^23 (ntt_ct.Q_MAX) and the route builds its
folded tables only where the GEMM's outputs stay below 2^53
(ntt_ct_matmul.stage_operands, ops/ntt.needs_split).
cuda_build.LAUNCHES counts the kernels' launches under route_enter and
route_leave; the spans fhe.route_enter and fhe.route_leave mark each
call on either device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..profiling import annotate
from .cuda_build import MAX_ROWS, launch, on_cuda
from .ntt_ct import CtMeta, drop_excluded, fold_mod_phim, insert_excluded, \
    pad_to_N

ENTER_MODES = {"fwd": 0, "fwd_digits": 1, "inv": 2}
LEAVE_MODES = {"fwd": 0, "inv": 1}


def folded_table(tw, scale, q) -> np.ndarray:
    """A twiddle with a 1 x 1 stage folded in, as the kernels read it:
    tw [L, N] and scale [L] residues, q [L] primes -> int32 [2, L, N],
    plane 0 tw * scale mod q, plane 1 its Shoup quotient
    floor(plane 0 * 2^32 / q) (the bits of a uint32)."""
    q = np.asarray(q, np.int64).reshape(-1, 1)
    w = (np.asarray(tw, np.int64) * np.asarray(scale, np.int64).reshape(-1, 1)
         % q)
    shoup = ((w << 32) // q).astype(np.uint32).view(np.int32)
    return np.stack([w.astype(np.int32), shoup])


def enter_plain(x, tab, q, meta: CtMeta, mode: str):
    """enter in int64 torch on x's device (module header)."""
    if mode == "inv":
        return insert_excluded(x, meta).to(torch.float64)
    x = pad_to_N(x, meta).to(torch.int64)
    if mode == "fwd_digits":
        x = x[:, None, :]
    return (x * tab[0] % q).to(torch.float64)


def leave_plain(z, tab, q, meta: CtMeta, mode: str):
    """leave in int64 torch on z's device (module header)."""
    q64 = q.to(torch.int64)
    r = (z.to(torch.int64) % q64[..., None]).permute(2, 0, 1)    # [R, L, N]
    if mode == "fwd":
        return drop_excluded(r, meta).to(torch.int32)
    return fold_mod_phim((r * tab[0] % q64).to(torch.int32), q, meta)


def _check(name: str, t, dtype, shape, tab, q, meta: CtMeta):
    """Raise ValueError, with the operand's shape, unless the kernel takes
    these operands."""
    L, N = q.shape[0], meta.N
    if meta.N2 != 1 or meta.q_odd != N or meta.phim != N - 1:
        raise ValueError(f"{name}: input {tuple(t.shape)}: the kernel takes "
                         f"a split N x 1 of an odd prime N, not {meta}")
    if not 1 <= L <= MAX_ROWS:
        raise ValueError(f"{name}: input {tuple(t.shape)}: {L} primes; the "
                         f"kernel takes 1 to {MAX_ROWS}")
    if t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(f"{name}: input {tuple(t.shape)} {t.dtype}: the "
                         f"kernel takes {dtype} {shape}")
    if tab is not None and tuple(tab.shape) != (2, L, N):
        raise ValueError(f"{name}: table {tuple(tab.shape)}: the kernel "
                         f"takes [2, {L}, {N}]")


def enter(x, tab, q, meta: CtMeta, mode: str):
    """The GEMM's operand y [R, L, N] float64 from x (module header); tab
    the folded twiddle (folded_table; None for "inv"), q [L, 1] int32."""
    with annotate("fhe.route_enter"):
        if not on_cuda(x):
            return enter_plain(x, tab, q, meta, mode)
        x = x.contiguous()
        L, R = q.shape[0], x.shape[0]
        shape = (R, meta.phim) if mode == "fwd_digits" else (R, L, meta.phim)
        _check("route_enter", x, torch.int32, shape, tab, q, meta)
        y = torch.empty((R, L, meta.N), dtype=torch.float64, device=x.device)
        if R:
            launch("route_enter", "fsi_route_enter", (x, tab, q, y),
                   (R, L, meta.N, ENTER_MODES[mode]), int32=(0, 1, 2),
                   contiguous=True)
        return y


def leave(z, tab, q, meta: CtMeta, mode: str):
    """Residues [R, L, phim] int32 from the GEMM's output z [L, N, R]
    (module header); tab the folded inverse twiddle (None for "fwd"),
    q [L, 1] int32."""
    with annotate("fhe.route_leave"):
        if not on_cuda(z):
            return leave_plain(z, tab, q, meta, mode)
        L, R = q.shape[0], z.shape[-1]
        _check("route_leave", z, torch.float64, (L, meta.N, R), tab, q, meta)
        out = torch.empty((R, L, meta.phim), dtype=torch.int32,
                          device=z.device)
        if R:
            launch("route_leave", "fsi_route_leave", (z, tab, q, out),
                   (R, L, meta.N, LEAVE_MODES[mode]), int32=(1, 2, 3),
                   contiguous=True)
        return out

