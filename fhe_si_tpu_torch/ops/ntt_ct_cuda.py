"""Hopper kernels for the three Cooley-Tukey transforms, and their
wrappers.

Stands in for fhe_si_tpu/ops/ntt_ct_pallas.py.  The kernels live in
fhe_si_tpu_torch/csrc/ct_ntt.cu (CUDA C++ for sm_90a, a plain C
interface); the first launch compiles them with nvcc into
fhe_si_tpu_torch/_build/ and loads the library with ctypes
(ops/cuda_build.py, which builds every source of csrc/).  Nothing is
compiled or loaded at import, so this module imports on a machine
without nvcc.  All three transforms run one tensor-core kernel (int8
byte planes) on the N-point transform of every ring
m = 2^a * q^b whose split N1 x N2 it takes (check_kernel_shape: both
sides at least 2 and the layout inside shared memory; every power of two
from m = 8 to 2^15, m = 20480 = 128 x 80, m = 13122 = 81 x 81).  On a
mixed-radix ring (phim < N) the kernel also does the phim <-> N steps
of ops/ntt_ct.py in its loads and stores (pad and drop forward, insert
and fold inverse; ct_ntt.cu, "the phim <-> N steps"), so each wrapper
launches once on phim-wide tensors and runs no plain op; PHIM_FUSED
counts those launches.  The inverse's fold keeps N/q words in shared
memory, which check_kernel_shape counts (fold_words).  Where the byte
planes leave no room for the twiddle pairs beside them (m = 2^15 on
128 x 128, both orientations of m = 20480), the kernel reads the
twiddle from global memory; twiddle_in_global states the rule and
TWIDDLE_GLOBAL counts those launches.  On the sync and rowsplit
schedules each prime gets the row tiles that sync_tiles chooses from the
card's resident blocks, so that no launch leaves a short last wave where
one block fits an SM (m = 2^15, m = 20480); launch_grid reads a launch's
grid from ct_ntt.cu.  The kernel reads
the byte planes and Shoup reciprocals that kernel_tables prepares here
on the host and DeviceContext keeps beside the tables (T['ct']); tables
without them raise on a CUDA tensor.

Dispatch: a tensor on the CPU takes the plain version of ops/ntt_ct.py;
a tensor on a CUDA device launches the kernel, or raises.  There is no
fallback from a failed launch or a split the kernel cannot take: the
splits it cannot take (N x 1 for N prime, as every reference ring
m = p - 1 past p = 4079 gives, and m = 2^16) never reach these wrappers
from DeviceContext, which sends them to ops/ntt_ct_matmul.py, chosen by
kernel_takes before any launch.
cuda_build.launch launches the kernel; cuda_build.LAUNCHES counts the
launches of each wrapper, cuda_build.SCHEDULES the same launches by the
kernel's schedule: the ping-pong on asynchronous wgmma where both sides
of the split are multiples of 64 and two rows fit (m = 8192 and 2^14,
each warpgroup a row of its own); the rowsplit schedule, asynchronous
wgmma on one row at a time, where both sides are multiples of 64, N is a
power of two above 8192 and one row fits (m = 2^15, 128 x 128: each
warpgroup takes half of each stage and reduces its tiles while the
other's products run); the sync schedule (mma.sync) on every other split and
on every launch with the phim <-> N steps.  ct_ntt.cu chooses it
(fsi_ct_schedule); kernel_schedule mirrors the rule.

What the kernels' exactness rests on (ct_ntt.cu header; the limits of
cuda_build) is checked on the host: every prime in [2, 2^23), either
residue lane, by kernel_tables, without whose tables no launch runs;
keyswitch digits of at most 24 bits by ct_fwd_digits.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..profiling import annotate
from . import ntt_ct
from .cuda_build import MAX_DIGIT_BITS, check_primes, launch, library, on_cuda
from .ntt_ct import CtMeta


# ---------------------------------------------- tensor-core kernel tables
KERNEL_CONSTS = 10   # per prime: q, floor(2^32/q), 2^(8d) mod q, reciprocals


def _pad(x: int, a: int) -> int:
    return -(-x // a) * a


def _reciprocal(w, q):
    """Shoup's floor(w 2^32 / q) for 0 <= w < q < 2^23, int64."""
    return (np.asarray(w, np.int64) << 32) // q


def byte_planes(tab) -> np.ndarray:
    """Square tables [L, M, M] with entries below 2^24 as the kernel's
    A operand: uint8 [L, 3, pad16(M), pad32(M) + 16], plane p holding
    byte p of each entry, zero in the padding."""
    tab = np.asarray(tab, np.int64)
    L, M, _ = tab.shape
    out = np.zeros((L, 3, _pad(M, 16), _pad(M, 32) + 16), np.uint8)
    for p in range(3):
        out[:, p, :M, :M] = (tab >> (8 * p)) & 255
    return out


def tw_stride(R: int) -> int:
    """Words per twiddle row (ct_ntt.cu Geo::tws): the R (w, w') pairs
    and at least 16 words of zero padding, rounded up to a multiple of 4
    so that every 16-byte twiddle load, and every prime's base, is
    aligned whatever the parity of R."""
    return _pad(2 * R + 16, 4)


def twiddle_pairs(tw, q) -> np.ndarray:
    """Twiddle [L, S, R] (rows as the kernel's stage-1 output) as int32
    bit patterns of uint32 [L, S, tw_stride(R)]: (w, floor(w 2^32 / q))
    pairs, zero in the padding."""
    tw = np.asarray(tw, np.int64)
    L, S, R = tw.shape
    out = np.zeros((L, S, tw_stride(R)), np.int64)
    out[..., 0:2 * R:2] = tw
    out[..., 1:2 * R:2] = _reciprocal(tw, np.asarray(q, np.int64)[:, None, None])
    return out.astype(np.uint32).view(np.int32)


def prime_consts(q) -> np.ndarray:
    """Per prime: q, floor(2^32/q), c_d = 2^(8d) mod q for d = 1..4 and
    their reciprocals floor(c_d 2^32 / q); int32 bit patterns of uint32
    [L, KERNEL_CONSTS]."""
    q = np.asarray(q, np.int64)[:, None]
    c = (1 << (8 * np.arange(1, 5, dtype=np.int64))) % q
    out = np.concatenate([q, (1 << 32) // q, c, _reciprocal(c, q)], axis=1)
    return out.astype(np.uint32).view(np.int32)


def kernel_tables(ct: dict) -> dict:
    """What the tensor-core kernel reads, from the numpy tables of
    ntt_ct.ct_tables (and t2i_crt where present): k_<table> byte planes
    of t1, t2, t1i, t2i, t2i_crt; k_tw the forward twiddle transposed to
    the forward transforms' [N2, N1] stage-1 layout, k_twi the inverse one
    [N1, N2], both with reciprocals; k_consts per prime.  Raises unless
    every prime lies in [2, 2^23)."""
    q = np.asarray(ct['q'], np.int64).reshape(-1)
    check_primes("kernel_tables", q.shape, q)
    out = {'k_consts': prime_consts(q),
           'k_tw': twiddle_pairs(np.swapaxes(ct['tw'], 1, 2), q),
           'k_twi': twiddle_pairs(ct['twi'], q)}
    for name in ('t1', 't2', 't1i', 't2i', 't2i_crt'):
        if name in ct:
            out['k_' + name] = byte_planes(ct[name])
    return out


SMEM_MAX = 232448       # ct_ntt.cu kSmemMax: an H100 block's opt-in bytes


def _pingpong_planes(S: int, R: int) -> int:
    """ct_ntt.cu PGeo: the prime's A1 and A2 planes and two warpgroups'
    B1 and B2 planes, unpadded."""
    return 3 * (S * S + R * R) + 2 * 2 * 3 * S * R


def _rowsplit_planes(S: int, R: int) -> int:
    """ct_ntt.cu rowsplit_bytes: the prime's A1 and A2 planes and one
    row's B1 and B2 planes, unpadded."""
    return 3 * (S * S + R * R) + 2 * 3 * S * R


def kernel_schedule(S: int, R: int) -> str:
    """The schedule ct_mma_kernel runs a row [S][R] on (ct_ntt.cu
    pingpong_takes and rowsplit_takes, which fsi_ct_schedule reports):
    'pingpong' where both sides are multiples of 64, S * R <= 8192 and
    the two-row planes fit in SMEM_MAX (m = 8192: 64 x 64; m = 2^14:
    64 x 128 and 128 x 64); 'rowsplit' where both sides are multiples of
    64, S * R is a power of two above 8192 and one row's planes fit
    (m = 2^15: 128 x 128); 'sync' otherwise.  A launch with the
    phim <-> N steps runs the sync schedule whatever the split: none of
    these splits has them."""
    if S % 64 == 0 and R % 64 == 0:
        N = S * R
        if N <= 8192 and _pingpong_planes(S, R) <= SMEM_MAX:
            return "pingpong"
        if (N > 8192 and N & (N - 1) == 0
                and _rowsplit_planes(S, R) <= SMEM_MAX):
            return "rowsplit"
    return "sync"


def _planes(S: int, R: int, fold: int) -> int:
    """kernel_smem without the twiddle pairs."""
    schedule = "sync" if fold else kernel_schedule(S, R)
    if schedule == "pingpong":
        return _pingpong_planes(S, R)
    if schedule == "rowsplit":
        return _rowsplit_planes(S, R)
    ks1, ks2 = _pad(S, 32) + 16, _pad(R, 32) + 16
    return 3 * (_pad(S, 16) * ks1 + _pad(R, 16) * ks2
                + _pad(R, 16) * ks1 + _pad(S, 16) * ks2) + _pad(4 * fold, 16)


@functools.cache
def twiddle_in_global(S: int, R: int, fold: int = 0) -> bool:
    """True where ct_mma_kernel's layout for a row [S][R] (with `fold`
    words of the fold's tail) leaves the twiddle pairs in global memory:
    the byte planes and S * tw_stride(R) * 4 bytes of twiddle exceed
    SMEM_MAX (ct_ntt.cu Geo::tw_shared, PGeo::tw_shared)."""
    return _planes(S, R, fold) + S * tw_stride(R) * 4 > SMEM_MAX


def kernel_smem(S: int, R: int, fold: int = 0) -> int:
    """Dynamic shared memory of ct_mma_kernel for a row [S][R] on its
    schedule: PGeo's, rowsplit_bytes' or Geo's formula in ct_ntt.cu
    (fsi_ct_mma_smem
    returns the same number on the card).  The byte-plane blocks, the
    fold's tail of `fold` words rounded up to 16 bytes (the inverse on a
    mixed-radix ring, fold_words(meta); only the sync schedule folds),
    and the twiddle pairs where the whole layout fits in SMEM_MAX
    (twiddle_in_global)."""
    planes = _planes(S, R, fold)
    if twiddle_in_global(S, R, fold):
        return planes
    return planes + S * tw_stride(R) * 4


def fold_words(meta: CtMeta) -> int:
    """Words of the inverse's fold that ct_mma_kernel keeps in shared
    memory: the tail s = N/q of a mixed-radix ring, 0 on m = 2^k."""
    return meta.N // meta.q_odd if meta.q_odd > 1 else 0


def _fits(S: int, R: int, limit: int, fold: int = 0) -> bool:
    return min(S, R) >= 2 and kernel_smem(S, R, fold) <= limit


def check_kernel_shape(name: str, shape, S: int, R: int,
                       limit: int = SMEM_MAX, fold: int = 0):
    """Raise ValueError, with the input's shape, unless ct_mma_kernel
    takes a row [S][R] (S = N2, R = N1 forward; S = N1, R = N2 inverse,
    with `fold` words of the fold's tail on a mixed-radix ring): both
    sides at least 2 and the layout inside `limit` bytes of shared
    memory per block.  Every such split also keeps the kernel's launch
    limits (sides up to 224 of its 1024, at most 16 input tiles per warp,
    N below 2^16).  The wrappers call it before every launch; the plain
    versions take every split."""
    if _fits(S, R, limit, fold):
        return
    split = f"input {tuple(shape)} (N1 x N2 = {max(S, R)} x {min(S, R)})"
    if min(S, R) < 2:
        raise ValueError(f"{name}: {split}: the tensor-core kernel needs "
                         "N1, N2 >= 2")
    raise ValueError(f"{name}: {split} needs {kernel_smem(S, R, fold)} bytes "
                     f"of shared memory per block; the card allows {limit}")


def kernel_takes(meta: CtMeta, limit: int = SMEM_MAX) -> bool:
    """True when ct_mma_kernel takes the split of `meta` in both
    orientations (forward S = N2, R = N1; inverse S = N1, R = N2), by
    check_kernel_shape's rule against `limit` bytes of shared memory.
    Reads no device: DeviceContext picks its transform route with it
    (chip_smoke.py checks that the card's opt-in limit is at least
    SMEM_MAX)."""
    return (_fits(meta.N2, meta.N1, limit)
            and _fits(meta.N1, meta.N2, limit))


def folds_in_kernel(meta: CtMeta, limit: int = SMEM_MAX) -> bool:
    """True when ct_inv on a mixed-radix ring folds inside the kernel:
    the fold's tail (fold_words) fits beside the inverse's layout in
    `limit` bytes.  Every mixed split the kernel takes but two does
    (125 x 125 and 128 x 125, m = 31250 and 32000), and on those ct_inv
    runs the plain insert and fold of ops/ntt_ct.py around the N-point
    kernel.  The forward transforms' pad and drop need no shared memory:
    every mixed split takes them in the kernel."""
    return meta.q_odd > 1 and _fits(meta.N1, meta.N2, limit,
                                    fold_words(meta))


# the input and the output of a launch (x, four tables, out); the byte
# planes of the tables are uint8
_INT32 = (0, 5)

# launches that did the phim <-> N steps in the kernel (a mixed-radix
# ring), per transform: a mul+relin counts 1, 1 and 2; none on m = 2^k
PHIM_FUSED = dict.fromkeys(("ct_fwd", "ct_fwd_digits", "ct_inv"), 0)


def reset_phim_fused():
    for k in PHIM_FUSED:
        PHIM_FUSED[k] = 0


# launches whose layout left the twiddle pairs in global memory
# (twiddle_in_global), per transform: a mul+relin counts 1, 1 and 2 at
# m = 2^15 and m = 20480, none at m = 8192
TWIDDLE_GLOBAL = dict.fromkeys(("ct_fwd", "ct_fwd_digits", "ct_inv"), 0)


def reset_twiddle_global():
    for k in TWIDDLE_GLOBAL:
        TWIDDLE_GLOBAL[k] = 0


def sync_tiles(rows: int, L: int, slots: int) -> int:
    """The row tiles each of L primes gets on the sync and rowsplit
    schedules, on a
    card of `slots` resident blocks (ct_ntt.cu sync_tiles, which
    launch_mma_tpw applies): the smallest t in 1 .. min(rows, slots) of
    least ceil(L t / slots) waves x (ceil(rows / t) + 1), the rows a block
    takes and about one more for its table load and first fetch."""
    return min(range(1, min(rows, slots) + 1),
               key=lambda t: -(-L * t // slots) * (-(-rows // t) + 1))


def tile_grid(rows: int, tiles: int) -> tuple[int, int]:
    """(tiles launched, rows a tile) of `rows` rows cut into `tiles`
    tiles, as launch_mma_tpw cuts them: ceil(rows / tiles) rows a tile and
    as few tiles as hold them."""
    per_tile = -(-rows // tiles)
    return -(-rows // per_tile), per_tile


_KIND = {"ct_fwd": 0, "ct_fwd_digits": 1, "ct_inv": 2}


@functools.cache
def launch_grid(name: str, ints: tuple, device: torch.device) -> tuple:
    """(tiles a prime, rows a tile, slots) of the launch of fsi_<name>
    with the integer arguments `ints` (rows, L, N1, N2, width, q_odd) on
    `device`, as ct_ntt.cu chooses them (fsi_ct_tiles, fsi_ct_slots):
    the grid is L x tiles blocks, slots of which are resident at once."""
    lib = library("ct_ntt")
    rows, _, *split = ints
    with torch.cuda.device(device):
        tiles = lib.fsi_ct_tiles(_KIND[name], *ints)
        slots = lib.fsi_ct_slots(_KIND[name], *split)
    if tiles < 1 or slots < 1:
        raise RuntimeError(f"fsi_ct_tiles / fsi_ct_slots {name} {ints}: CUDA "
                           f"error {-min(tiles, slots)}")
    return tiles, -(-rows // tiles), slots


# ct_mma_kernel's schedules by fsi_ct_schedule's code (ct_ntt.cu kSync,
# kPingpong, kRowsplit)
_SCHEDULE_CODES = ("sync", "pingpong", "rowsplit")


@functools.cache
def _schedule(S: int, R: int) -> str:
    return _SCHEDULE_CODES[library("ct_ntt").fsi_ct_schedule(S, R)]


def _check(name, x, tail: tuple):
    if tuple(x.shape[-len(tail):]) != tail:
        raise ValueError(f"{name}: expected [..., {', '.join(map(str, tail))}]"
                         f", got {tuple(x.shape)}")


@functools.cache
def _smem_limit(device: torch.device) -> int:
    with torch.cuda.device(device):
        return library("ct_ntt").fsi_smem_optin()


def _mma_tables(name, x, T: dict, keys, S: int, R: int, fold: int = 0):
    """The tensor-core kernel's tables, after checking that it takes the
    split (check_kernel_shape, against the card's shared memory) and
    before looking for them: a split the kernel cannot take raises with
    its shape whatever tables it was handed."""
    check_kernel_shape(name, x.shape, S, R, _smem_limit(x.device), fold)
    missing = [k for k in keys if k not in T]
    if missing:
        raise ValueError(f"{name}: the tables lack {missing}; build them "
                         "with ntt_ct_cuda.kernel_tables (DeviceContext does)")
    return tuple(T[k] for k in keys)


def _launch(name, x, tabs, out, L: int, meta: CtMeta, S: int, R: int,
            width: int, fold: int = 0):
    """One launch of the kernel's entry fsi_<name> on rows `width` words
    wide: phim, with the phim <-> N steps inside where phim < N (counted
    in PHIM_FUSED), or N, the N-point transform alone; a layout of row
    [S][R] and `fold` words that leaves the twiddle in global memory is
    counted in TWIDDLE_GLOBAL."""
    if not out.numel():
        return out
    ints = (out.numel() // (L * width), L, meta.N1, meta.N2, width,
            meta.q_odd)
    launch(name, "fsi_" + name, (x, *tabs, out), ints, int32=_INT32,
           contiguous=True, schedule=_schedule(S, R))
    if width < meta.N:
        PHIM_FUSED[name] += 1
    if twiddle_in_global(S, R, fold):
        TWIDDLE_GLOBAL[name] += 1
    return out


def ct_fwd(T: dict, x, meta: CtMeta):
    """Forward transform of residues int32 [..., L, phim] in [0, q)."""
    with annotate("fhe.ct_fwd"):
        if not on_cuda(x):
            return ntt_ct.ct_fwd(T, x, meta)
        L = T['q'].shape[0]
        _check("ct_fwd", x, (L, meta.phim))
        tabs = _mma_tables("ct_fwd", x, T,
                           ('k_t2', 'k_t1', 'k_tw', 'k_consts'), meta.N2,
                           meta.N1)
        x = x.contiguous()
        return _launch("ct_fwd", x, tabs, torch.empty_like(x), L, meta,
                       meta.N2, meta.N1, meta.phim)


def ct_fwd_digits(T: dict, digits, meta: CtMeta, digit_bits: int):
    """Forward transform of prime-independent digits int32 [..., phim] in
    [0, 2^digit_bits) -> [..., L, phim]."""
    with annotate("fhe.ct_fwd_digits"):
        if not on_cuda(digits):
            return ntt_ct.ct_fwd_digits(T, digits, meta, digit_bits)
        if digit_bits > MAX_DIGIT_BITS:
            raise NotImplementedError(f"digit radix above 2^{MAX_DIGIT_BITS}")
        L = T['q'].shape[0]
        _check("ct_fwd_digits", digits, (meta.phim,))
        tabs = _mma_tables("ct_fwd_digits", digits, T,
                           ('k_t2', 'k_t1', 'k_tw', 'k_consts'), meta.N2,
                           meta.N1)
        digits = digits.contiguous()
        out = torch.empty(digits.shape[:-1] + (L, meta.phim),
                          dtype=torch.int32, device=digits.device)
        return _launch("ct_fwd_digits", digits, tabs, out, L, meta, meta.N2,
                       meta.N1, meta.phim)


def ct_inv(T: dict, evals, meta: CtMeta, t2i_key: str = 't2i'):
    """Inverse transform [..., L, phim] -> coefficients; t2i_key='t2i_crt'
    folds in the CRT premultiplier."""
    with annotate("fhe.ct_inv"):
        if not on_cuda(evals):
            return ntt_ct.ct_inv(T, evals, meta, t2i_key)
        L = T['q'].shape[0]
        _check("ct_inv", evals, (L, meta.phim))
        fold = folds_in_kernel(meta, _smem_limit(evals.device))
        words = fold_words(meta) if fold else 0
        tabs = _mma_tables("ct_inv", evals, T,
                           ('k_t1i', 'k_' + t2i_key, 'k_twi', 'k_consts'),
                           meta.N1, meta.N2, words)
        if fold or meta.q_odd == 1:
            evals = evals.contiguous()
            return _launch("ct_inv", evals, tabs, torch.empty_like(evals), L,
                           meta, meta.N1, meta.N2, meta.phim, words)
        # the fold's tail does not fit (folds_in_kernel): the plain steps
        evals = ntt_ct.insert_excluded(evals, meta).contiguous()
        out = _launch("ct_inv", evals, tabs, torch.empty_like(evals), L,
                      meta, meta.N1, meta.N2, meta.N)
        return ntt_ct.fold_mod_phim(out, T['q'], meta)
