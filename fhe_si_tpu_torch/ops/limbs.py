"""Fixed-width big-int arithmetic in 16-bit limbs on int32 tensors.

Counterpart of fhe_si_tpu/ops/limbs.py: values mod 2^(16n) as n
little-endian limbs in [0, 2^16), two's complement for signed values,
limbs on the LAST axis.  Reduce's mask/sign-fix (Util.cpp:3-26) is limb
masking, ScaleDown's floor((2x+q)/2q) (Ciphertext.cpp:194-218) an
arithmetic shift, and ByteDecomp's radix-2^24 digits
(Ciphertext.cpp:82-121) static bit slices.  `>>` on a negative int32
tensor is an arithmetic shift in torch as in jnp, which the signed
carries of `normalize` rely on.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1


def _shift_up(x, k: int = 1):
    """x moved k limbs up along the last axis, zeros shifted in (the
    carry of limb i lands on limb i+k)."""
    return F.pad(x[..., :-k], (k, 0))


def normalize(acc):
    """Carry-propagate int32 partial limbs into canonical [0, 2^16) limbs.
    Works for signed partials: the arithmetic >> propagates borrows, and
    the final truncation is exactly arithmetic mod 2^(16n)."""
    n = acc.shape[-1]
    out = []
    carry = torch.zeros_like(acc[..., 0])
    for k in range(n):
        v = acc[..., k] + carry
        out.append(v & LIMB_MASK)
        carry = v >> LIMB_BITS
    return torch.stack(out, dim=-1)


def add(a, b):
    return normalize(a + b)


def sub(a, b):
    return normalize(a - b)


def neg(a):
    return normalize(-a)


def is_negative(a):
    """Sign of the two's complement value (top bit of top limb)."""
    return (a[..., -1] >> (LIMB_BITS - 1)) & 1


def reduce_mod_q(a, log_q: int, positive: bool, q_limbs,
                 out_width: int | None = None):
    """Reduce semantics (Util.cpp:3-26) on limbs: a mod 2^logQ in [0, q)
    when positive, else mapped into [-q/2, q/2).  q_limbs: limbs of
    2^logQ, width >= needed.  Any out_width with 16*out_width > logQ is
    exact."""
    n = a.shape[-1]
    nw = out_width if out_width is not None else n
    if LIMB_BITS * nw <= log_q or LIMB_BITS * n < log_q:
        raise ValueError("limb width too narrow for logQ")
    hi_limb, hi_bits = divmod(log_q, LIMB_BITS)
    masked = []
    for k in range(nw):
        if k < hi_limb and k < n:
            masked.append(a[..., k])
        elif k == hi_limb and hi_bits and k < n:
            masked.append(a[..., k] & ((1 << hi_bits) - 1))
        else:
            masked.append(torch.zeros_like(a[..., 0]))
    m = torch.stack(masked, dim=-1)
    if positive:
        return m
    sb_limb, sb_off = divmod(log_q - 1, LIMB_BITS)
    sign = (m[..., sb_limb] >> sb_off) & 1
    return normalize(m - sign[..., None] * q_limbs[..., :nw])


def match_width(a, n: int):
    """Sign-extend (or truncate) two's complement limbs to width n."""
    cur = a.shape[-1]
    if cur == n:
        return a
    if cur > n:
        return a[..., :n]
    fill = (0 - is_negative(a)) & LIMB_MASK        # 0x0000 / 0xffff
    ext = fill[..., None].expand(a.shape[:-1] + (n - cur,))
    return torch.cat([a, ext], dim=-1)


def arith_shift_right(a, shift: int):
    """floor(x / 2^shift) for the signed two's complement value x."""
    n = a.shape[-1]
    ls, bs = divmod(shift, LIMB_BITS)
    sign_fill = (0 - is_negative(a)) & LIMB_MASK

    def limb(k):
        return a[..., k] if k < n else sign_fill

    out = []
    for k in range(n):
        lo = limb(k + ls)
        if bs == 0:
            out.append(lo)
        else:
            hi = limb(k + ls + 1)
            out.append(((lo >> bs) | (hi << (LIMB_BITS - bs))) & LIMB_MASK)
    return torch.stack(out, dim=-1)


def shift_left(a, shift: int):
    """x * 2^shift mod 2^(16n)."""
    n = a.shape[-1]
    ls, bs = divmod(shift, LIMB_BITS)
    zero = torch.zeros_like(a[..., 0])

    def limb(k):
        return a[..., k] if 0 <= k < n else zero

    out = []
    for k in range(n):
        lo = limb(k - ls)
        if bs == 0:
            out.append(lo)
        else:
            hi = limb(k - ls - 1)
            out.append(((lo << bs) | (hi >> (LIMB_BITS - bs))) & LIMB_MASK)
    return torch.stack(out, dim=-1)


def mul_small(a, c):
    """a * c for nonnegative c < 2^30 (int broadcastable to a[..., 0]).
    A 3 x 10-bit digit split keeps every product < 2^27."""
    c = torch.as_tensor(c, dtype=torch.int32, device=a.device)
    c2, c1, c0 = c >> 20, (c >> 10) & 1023, c & 1023
    p0 = a * c0[..., None]                 # < 2^26
    p1 = a * c1[..., None]                 # < 2^26, weight 2^10
    p2 = a * c2[..., None]                 # < 2^26, weight 2^20
    # weight-2^20 plane lands at limb k+1 with a 4-bit in-limb shift
    acc = ((p0 & LIMB_MASK)
           + ((p1 & ((1 << (LIMB_BITS - 10)) - 1)) << 10))
    hi = (p0 >> LIMB_BITS) + (p1 >> (LIMB_BITS - 10))
    hi = hi + ((p2 & ((1 << (LIMB_BITS - 4)) - 1)) << 4)
    hi2 = p2 >> (LIMB_BITS - 4)
    acc = acc + _shift_up(hi) + _shift_up(hi2, 2)
    return normalize(acc)


def scale_coeffs_by_bigint(coeffs, const_limbs, const_limbs_sh10,
                           const_limbs_sh20=None):
    """coeffs[..., i] * C for nonnegative coeffs < 2^30 and a big
    constant C given as limbs (plus its 2^10- and 2^20-shifted copies;
    sh20 may be omitted when coeffs < 2^20).  floor(q/p) * message in
    encrypt (FHE-SI.cpp:31)."""
    c2, c1, c0 = coeffs >> 20, (coeffs >> 10) & 1023, coeffs & 1023
    p0 = c0[..., None] * const_limbs       # < 2^10 * 2^16 = 2^26
    p1 = c1[..., None] * const_limbs_sh10
    acc = (p0 & LIMB_MASK) + (p1 & LIMB_MASK)
    hi = (p0 >> LIMB_BITS) + (p1 >> LIMB_BITS)
    if const_limbs_sh20 is not None:
        p2 = c2[..., None] * const_limbs_sh20   # c2 < 2^10
        acc = acc + (p2 & LIMB_MASK)
        hi = hi + (p2 >> LIMB_BITS)
    return normalize(acc + _shift_up(hi))


def from_small_signed(coeffs, n: int):
    """Small signed int32 values -> two's complement limbs [..., n]
    (arithmetic >> sign-extends; shifts are clamped to 31)."""
    return torch.stack(
        [(coeffs >> min(LIMB_BITS * k, 31)) & LIMB_MASK for k in range(n)],
        dim=-1)


def byte_decomp(a, log_q: int, digit_bits: int, ndigits: int, q_limbs):
    """ByteDecomp digits (Ciphertext.cpp:82-121): positive rep mod q,
    then digit j = bits [digit_bits*j, digit_bits*(j+1)).  Returns int32
    [..., ndigits], digits < 2^digit_bits <= 2^24 (wider radixes:
    byte_decomp_planes)."""
    if digit_bits > 24:
        raise ValueError("digit radix above 2^24: use byte_decomp_planes")
    pos = reduce_mod_q(a, log_q, True, q_limbs)
    n = pos.shape[-1]
    zero = torch.zeros_like(pos[..., 0])

    def limb(k):
        return pos[..., k] if k < n else zero

    digits = []
    for j in range(ndigits):
        k0, off = divmod(digit_bits * j, LIMB_BITS)
        v = limb(k0) >> off
        got = LIMB_BITS - off
        idx = 1
        while got < digit_bits:
            v = v | (limb(k0 + idx) << got)
            got += LIMB_BITS
            idx += 1
        digits.append(v & ((1 << digit_bits) - 1))
    return torch.stack(digits, dim=-1)


def byte_decomp_planes(a, log_q: int, digit_bits: int, ndigits: int, q_limbs):
    """ByteDecomp for digit radixes past int32 values (decompSize >= 4;
    the reference accepts any decompSize, FHEContext.h:91-99): each
    radix-2^digit_bits digit as ceil(digit_bits/16) little-endian 16-bit
    planes, plane t of digit j holding bits [digit_bits*j + 16t, +16) of
    the positive representative.  Returns int32 [..., ndigits, nplanes],
    every plane in [0, 2^16)."""
    nplanes = (digit_bits + LIMB_BITS - 1) // LIMB_BITS
    pos = reduce_mod_q(a, log_q, True, q_limbs)
    n = pos.shape[-1]
    zero = torch.zeros_like(pos[..., 0])

    def limb(k):
        return pos[..., k] if k < n else zero

    digits = []
    for j in range(ndigits):
        planes = []
        for t in range(nplanes):
            width = min(LIMB_BITS, digit_bits - LIMB_BITS * t)
            k0, off = divmod(digit_bits * j + LIMB_BITS * t, LIMB_BITS)
            v = limb(k0) >> off
            if off:
                v = v | (limb(k0 + 1) << (LIMB_BITS - off))
            planes.append(v & ((1 << width) - 1))
        digits.append(torch.stack(planes, dim=-1))
    return torch.stack(digits, dim=-2)


def mod_p_bounded(y, p: int, K_bound: int):
    """y mod p in [0, p), as int32, for two's complement limbs y with
    |y| <= K_bound * p: the decrypt tail for p >= 2^20, where the 4-bit
    chunk-dot sum of limbs_to_mod_small would leave int32 (bound
    context.exact_bounds['K_dec']).

    The JAX package (ops/limbs.py mod_p_bounded) estimates the quotient in
    float32 and corrects it in the limb domain to stay in int32 lanes.
    Here |y| < 2^47 is read exactly as an int64 from the low three limbs
    (the limbs above them are sign fill) and reduced with `%`: the
    canonical residue the JAX corrections also reach."""
    m = min(y.shape[-1], 3)
    bits = LIMB_BITS * m
    if K_bound * p >= 1 << (bits - 1):
        raise ValueError("mod_p_bounded: |y| may exceed the int64 window")
    v = y[..., 0].to(torch.int64)
    for k in range(1, m):
        v = v + (y[..., k].to(torch.int64) << (LIMB_BITS * k))
    v = v - ((v >> (bits - 1)) << bits)             # sign-extend the window
    return (v % p).to(torch.int32)
