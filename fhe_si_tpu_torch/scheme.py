"""User-facing scheme layer of the port: keys, plaintexts, ciphertexts.

Counterpart of fhe_si_tpu/scheme.py.  Every object carries the
DeviceContext it lives on (and with it the torch.device), so an entry
point takes the DeviceContext once, at keygen, and reads it from its
operands afterwards.  Randomness is the host-side
sampling.RandomSource (this package's copy of fhe_si_tpu/sampling.py,
which draws the same integers), drawn in the same canonical order as
the JAX package, so both packages consume identical samples.  A
RandomSource of either package is accepted.  Results
are new tensors: no operation writes into a tensor that another
Ciphertext may share.
"""
from __future__ import annotations

import numpy as np
import torch

from . import sampling
from .context import MAX_KSW_PARTS, FheContext, ints_to_limbs, limbs_to_int
from .device import DeviceContext
from .hostmath import oracle
from .ops import limbs as lb

HWT = 64  # secret-key Hamming weight (FHE-SI.cpp:90)


def _is_source(rnd) -> bool:
    """A RandomSource (of this package or of fhe_si_tpu: both draw the same
    integers) rather than a pre-drawn randomness plan."""
    return callable(getattr(rnd, "uniform_signed_q", None))


class Plaintext:
    """Message polynomial mod p with slot packing (Plaintext.h:10-111)."""

    def __init__(self, ctx: FheContext, message=None):
        self.ctx = ctx
        msg = np.zeros(ctx.phim, dtype=np.int64)
        if message is not None:
            arr = np.asarray(message, dtype=np.int64) % ctx.p
            msg[:len(arr)] = arr
        self.message = msg

    @classmethod
    def from_slots(cls, ctx: FheContext, values, only_usable: bool = True):
        return cls(ctx, ctx.embed_in_slots(values, only_usable))

    def decode_slots(self) -> np.ndarray:
        return self.ctx.decode_slots(self.message)

    def __eq__(self, other):
        return (self.ctx is other.ctx
                and np.array_equal(self.message, other.message))

    # debug-side ops (Plaintext.h:70-107)
    def __add__(self, other):
        return Plaintext(self.ctx, (self.message + other.message) % self.ctx.p)

    def __sub__(self, other):
        return Plaintext(self.ctx, (self.message - other.message) % self.ctx.p)

    def __mul__(self, other):
        return Plaintext(self.ctx, oracle.plaintext_mul(
            self.ctx, self.message, other.message))

    def rotate(self, k: int) -> "Plaintext":
        """Plaintext::operator>>= (Plaintext.h:88-97)."""
        return Plaintext(self.ctx, oracle.plaintext_rotate(
            self.ctx, self.message, k))

    def automorph(self, t: int) -> "Plaintext":
        """Message-level X -> X^t mod (Phi_m, p): the plaintext image of
        `ciphertext >> t` (oracle.plaintext_automorph)."""
        return Plaintext(self.ctx, oracle.plaintext_automorph(
            self.ctx, self.message, t))

    def __repr__(self):
        return f"Plaintext({self.message.tolist()})"


def _i32(dev: DeviceContext, a):
    return torch.as_tensor(np.asarray(a, dtype=np.int32), device=dev.device)


def _check_parts(k: int, sk_evals):
    if k > sk_evals.shape[0]:
        # the reference dots every part against the tensored key list
        # (FHE-SI.cpp:96-103); a longer ciphertext cannot be decrypted here
        raise ValueError(
            f"ciphertext has {k} parts but the secret key holds only "
            f"{sk_evals.shape[0]} key powers; relinearize first "
            "(FHE-SI.cpp:96-103 semantics)")


class FheSecretKey:
    def __init__(self, dev: DeviceContext, sk_evals):
        self.dev = dev
        self.sk_evals = sk_evals          # [k, L, phim]

    @property
    def ctx(self) -> FheContext:
        return self.dev.ctx

    def decrypt(self, ct: "Ciphertext") -> Plaintext:
        ct = ct.relinearized_view()
        k = ct.parts.shape[0]
        _check_parts(k, self.sk_evals)
        msg = self.dev._decrypt(ct.parts, self.sk_evals[:k])
        return Plaintext(self.ctx, msg.cpu().numpy())

    def decrypt_batch(self, cts: list["Ciphertext"]) -> list[Plaintext]:
        """One batched decrypt of many 2-part ciphertexts.  Parts wider
        than n_ct are reduced mod 2^logQ first (output-invariant: the
        rounding quotient shifts by exactly t*p under d -> d + t*q)."""
        views = [ct.relinearized_view() for ct in cts]
        for v in views:
            _check_parts(v.parts.shape[0], self.sk_evals)
        n_ct = self.ctx.n_limbs_ct
        ps = [v.parts[:2] if v.parts.shape[-1] <= n_ct
              else self.dev.reduce_signed(v.parts[:2]) for v in views]
        parts = torch.stack([lb.match_width(p, n_ct) for p in ps])
        msgs = self.dev._decrypt(parts, self.sk_evals[:2]).cpu().numpy()
        return [Plaintext(self.ctx, msgs[i]) for i in range(len(cts))]


class FhePublicKey:
    def __init__(self, dev: DeviceContext, pk_evals, pk_limbs):
        self.dev = dev
        self.pk_evals = pk_evals          # [2, L, phim]
        self.pk_limbs = pk_limbs          # [2, phim, n_ct]

    @property
    def ctx(self) -> FheContext:
        return self.dev.ctx

    def encrypt(self, ptxt: Plaintext,
                rnd: sampling.EncryptRandomness | sampling.RandomSource
                ) -> "Ciphertext":
        ctx = self.ctx
        if _is_source(rnd):
            rnd = sampling.sample_encrypt(rnd, ctx.phim, ctx.stdev,
                                          self.pk_evals.shape[0])
        parts = self.dev._encrypt(self.pk_evals,
                                  _i32(self.dev, ptxt.message),
                                  _i32(self.dev, rnd.r),
                                  _i32(self.dev, np.stack(rnd.errors)))
        return Ciphertext(self.dev, parts=parts)

    def encrypt_batch(self, ptxts: list[Plaintext],
                      source: sampling.RandomSource) -> list["Ciphertext"]:
        """One batched encrypt (randomness drawn in the same canonical
        per-ciphertext order as encrypt())."""
        ctx = self.ctx
        plans = [sampling.sample_encrypt(source, ctx.phim, ctx.stdev,
                                         self.pk_evals.shape[0])
                 for _ in ptxts]
        parts = self.dev._encrypt(
            self.pk_evals,
            _i32(self.dev, np.stack([pt.message for pt in ptxts])),
            _i32(self.dev, np.stack([pl.r for pl in plans])),
            _i32(self.dev, np.stack([np.stack(pl.errors) for pl in plans])))
        return [Ciphertext(self.dev, parts=parts[i]) for i in range(len(ptxts))]


def keygen(dev: DeviceContext,
           rnd: sampling.KeyGenRandomness | sampling.RandomSource
           ) -> tuple[FheSecretKey, FhePublicKey]:
    """FHESISecKey + FHESIPubKey construction (FHE-SI.cpp:42-91) on the
    DeviceContext's device."""
    ctx = dev.ctx
    if _is_source(rnd):
        rnd = sampling.sample_keygen(rnd, ctx.phim, ctx.stdev, ctx.log_q, HWT)
    sk_evals, pk_evals, pk_limbs = dev._keygen(
        _i32(dev, rnd.s), _i32(dev, rnd.c0),
        _i32(dev, ints_to_limbs(rnd.c1, ctx.n_limbs_ct)))
    return FheSecretKey(dev, sk_evals), FhePublicKey(dev, pk_evals, pk_limbs)


class KeySwitch:
    """KeySwitchSI (FHE-SI.h:73-117): matrix held as evaluations."""

    def __init__(self, dev: DeviceContext, matrix_evals):
        self.dev = dev
        self.matrix_evals = matrix_evals  # [2, K, L, phim]

    @classmethod
    def _init(cls, src_sk_evals, dst: FheSecretKey,
              rnd: sampling.KeySwitchRandomness | sampling.RandomSource
              ) -> "KeySwitch":
        """KeySwitchSI::Init (FHE-SI.cpp:153-209) from the source key
        powers [k, L, phim] to dst's (1, s)."""
        dev, ctx = dst.dev, dst.ctx
        n_src = src_sk_evals.shape[0]
        if n_src > MAX_KSW_PARTS:
            raise ValueError(
                f"key-switch source key has {n_src} parts; the keyswitch "
                f"subset basis is provisioned for MAX_KSW_PARTS="
                f"{MAX_KSW_PARTS} (context.exact_bounds['ksw'])")
        if _is_source(rnd):
            rnd = sampling.sample_keyswitch(rnd, ctx.phim, ctx.stdev,
                                            ctx.log_q, n_src, ctx.ndigits)
        A_limbs = _i32(dev, np.stack(
            [ints_to_limbs(poly, ctx.n_limbs_ct) for poly in rnd.A]))
        matrix = dev._keyswitch_init(src_sk_evals, dst.sk_evals[1], A_limbs,
                                     _i32(dev, np.stack(rnd.e)))
        return cls(dev, matrix)

    @classmethod
    def for_relinearization(cls, sk: FheSecretKey, rnd) -> "KeySwitch":
        """InitS2 (FHE-SI.cpp:211-227): tensored key (1, s, s^2) -> (1, s)."""
        s = sk.sk_evals[1]
        return cls._init(torch.stack([sk.sk_evals[0], s,
                                      sk.dev.square_evals(s)]), sk, rnd)

    @classmethod
    def for_automorph(cls, sk: FheSecretKey, k: int, rnd) -> "KeySwitch":
        """InitAutomorph (FHE-SI.cpp:229-239): (1, s(X^k)) -> (1, s)."""
        dev = sk.dev
        return cls._init(dev.automorph_tensored(sk.sk_evals,
                                                dev.automorph_perm(k)),
                         sk, rnd)

    def apply(self, ct: "Ciphertext") -> "Ciphertext":
        """ApplyKeySwitch (FHE-SI.cpp:241-260)."""
        ct = ct.relinearized_view()                       # ScaleDown if tensored
        digit_evals = self.dev._digit_evals(ct.parts)     # [k*nd, Lk, phim]
        K = self.matrix_evals.shape[1]
        if digit_evals.shape[0] != K:
            raise ValueError(
                f"key-switch matrix width {K} != ciphertext digit count "
                f"{digit_evals.shape[0]}")
        return Ciphertext(self.dev, parts=self.dev._keyswitch_digits(
            self.matrix_evals, digit_evals))


# ------------------------------------------------------------ batched helpers
def _rotate_reduce(dev: DeviceContext, parts, rotations):
    for k, aksw in rotations:
        parts = dev.rotate_reduce_stage(parts, dev.automorph_perm(k),
                                        aksw.matrix_evals)
    return parts


def _unstack(dev: DeviceContext, parts) -> list["Ciphertext"]:
    return [Ciphertext(dev, parts=parts[i]) for i in range(parts.shape[0])]


def keyswitch_sum_batch(cts: list["Ciphertext"], ksw: KeySwitch,
                        rotations: list[tuple[int, KeySwitch]]
                        ) -> list["Ciphertext"]:
    """Batched keyswitch, then rotate-and-reduce, over same-shape
    ciphertexts: the MapAll(processFunc) loop of Regression.h:110-115.
    Equal to ksw.apply + SumBatchedData per ciphertext."""
    if not cts:
        return []
    dev = cts[0].dev
    if cts[0].scaled_up:
        parts = dev.keyswitch_tensored(torch.stack([c.tprod for c in cts]),
                                       ksw.matrix_evals)
    else:
        parts = dev.keyswitch_parts(torch.stack([c.parts for c in cts]),
                                    ksw.matrix_evals)
    return _unstack(dev, _rotate_reduce(dev, parts, rotations))


def sum_batch_only(cts: list["Ciphertext"],
                   rotations: list[tuple[int, KeySwitch]]
                   ) -> list["Ciphertext"]:
    """Batched rotate-and-reduce without a leading key switch (the n == 1
    moment path, Statistics.h:73-76)."""
    if not cts:
        return []
    dev = cts[0].dev
    parts = torch.stack([c.parts for c in cts])
    return _unstack(dev, _rotate_reduce(dev, parts, rotations))


def mul_batch(pairs: list[tuple["Ciphertext", "Ciphertext"]]
              ) -> list["Ciphertext"]:
    """One batched tensor product of same-shape non-tensored ciphertexts
    (Ciphertext.cpp:167-192 per pair)."""
    if not pairs:
        return []
    dev = pairs[0][0].dev
    a = torch.stack([x.parts for x, _ in pairs])
    b = torch.stack([y.parts for _, y in pairs])
    tens = dev._tensor_mul(a, b)
    return [Ciphertext(dev, tprod=tens[i]) for i in range(len(pairs))]


def combine_signed_batch(cts: list["Ciphertext"], signs: list[int],
                         group: int) -> list["Ciphertext"]:
    """sum_t signs[t] * cts[t] within consecutive groups of uniform size
    (tensored state): the cofactor accumulation of Matrix.cpp:224-263,
    batched."""
    dev = cts[0].dev
    tens = torch.stack([c.tprod for c in cts])
    G = len(cts) // group
    tens = tens.reshape((G, group) + tuple(tens.shape[1:]))
    s = np.asarray(signs, dtype=np.int64).reshape(G, group)
    q = np.asarray(dev.ctx.primes, dtype=np.int64)
    s_mod = np.where(s[..., None] < 0, q - 1, 1)[:, :, None, :, None]
    out = dev.signed_group_sum_tensored(tens, _i32(dev, s_mod))  # [G,k,1,L,1]
    return [Ciphertext(dev, tprod=out[i]) for i in range(G)]


def relin_batch(cts: list["Ciphertext"], ksw: KeySwitch) -> list["Ciphertext"]:
    """Batched ScaleDown + ApplyKeySwitch over tensored ciphertexts."""
    if not cts:
        return []
    dev = cts[0].dev
    return _unstack(dev, dev.keyswitch_tensored(
        torch.stack([c.tprod for c in cts]), ksw.matrix_evals))


def scalar_mul_batch(cts: list["Ciphertext"],
                     scalars: list[int]) -> list["Ciphertext"]:
    """Batched multiply-by-long over non-tensored ciphertexts: one scalar
    and one sign per ciphertext."""
    dev = cts[0].dev
    parts = torch.stack([c.parts for c in cts])
    return _unstack(dev, dev.mul_scalar(parts, [abs(s) for s in scalars],
                                        [s < 0 for s in scalars]))


class Ciphertext:
    """Ciphertext (Ciphertext.h:46-97): non-tensored parts are limb
    polynomials [k, phim, n]; tensored state holds evaluations
    [k, L, phim] with scaled_up=True."""

    def __init__(self, dev: DeviceContext, parts=None, tprod=None):
        self.dev = dev
        self.parts = parts
        self.tprod = tprod
        self.scaled_up = tprod is not None

    @property
    def ctx(self) -> FheContext:
        return self.dev.ctx

    def relinearized_view(self) -> "Ciphertext":
        """ScaleDown when tensored (Ciphertext.cpp:194-218), else self."""
        if not self.scaled_up:
            return self
        return Ciphertext(self.dev, parts=self.dev._scale_down(self.tprod))

    def num_parts(self) -> int:
        return (self.tprod if self.scaled_up else self.parts).shape[0]

    def _scaled_const(self, message, width: int):
        """floor(c * q / p) per coefficient, as limbs [phim, width]."""
        ctx = self.ctx
        return _i32(self.dev, ints_to_limbs(
            [(int(c) << ctx.log_q) // ctx.p for c in message], width))

    # -- addition (Ciphertext.cpp:123-161)
    def __add__(self, other):
        dev = self.dev
        if isinstance(other, Plaintext):
            if self.scaled_up:
                t0 = dev.add_const_tensored(
                    self.tprod[0], self._scaled_const(other.message,
                                                      self.ctx.n_limbs_ct))
                return Ciphertext(dev, tprod=torch.cat([t0[None],
                                                        self.tprod[1:]]))
            # parts may be wider than n_ct (an unreduced automorph output,
            # on which AddConstant is legal): the constant is built at the
            # parts' width and the reduced part 0 sign-extended back to it.
            # Only part 0 is reduced, as in oracle.add_const.
            nw = self.parts.shape[-1]
            p0 = lb.match_width(dev.add_const(
                self.parts[0], self._scaled_const(other.message, nw)), nw)
            return Ciphertext(dev, parts=torch.cat([p0[None], self.parts[1:]]))
        if self.scaled_up != other.scaled_up:
            raise ValueError("cannot add tensored to non-tensored ciphertext")
        if self.scaled_up:
            a, b = self.tprod, other.tprod
            k = min(a.shape[0], b.shape[0])
            out = dev.add_tensored(a[:k], b[:k])
            tail = a[k:] if a.shape[0] > k else b[k:]
            if tail.shape[0]:
                out = torch.cat([out, tail])
            return Ciphertext(dev, tprod=out)
        a, b = self.parts, other.parts
        if a.shape[-1] != b.shape[-1]:
            # width-ragged operands (an unreduced automorph output):
            # sign-extend the narrower one; add reduces mod 2^logQ anyway
            nw = max(a.shape[-1], b.shape[-1])
            a, b = lb.match_width(a, nw), lb.match_width(b, nw)
        k = min(a.shape[0], b.shape[0])
        out = dev.add(a[:k], b[:k])
        tail = a[k:] if a.shape[0] > k else b[k:]
        if tail.shape[0]:
            # the reference copies the unpaired tail unreduced
            # (Ciphertext.cpp:123-145): widen the sums to the tail's width
            nw = max(out.shape[-1], tail.shape[-1])
            out = torch.cat([lb.match_width(out, nw),
                             lb.match_width(tail, nw)])
        return Ciphertext(dev, parts=out)

    # -- multiplication (Ciphertext.cpp:167-262)
    def __mul__(self, other):
        dev = self.dev
        if isinstance(other, Ciphertext):
            if self.scaled_up or other.scaled_up:
                raise ValueError("tensor multiply requires non-tensored "
                                 "operands")
            return Ciphertext(dev, tprod=dev._tensor_mul(self.parts,
                                                         other.parts))
        if isinstance(other, Plaintext):
            const_evals = dev.small_to_evals(_i32(dev, other.message))
            if self.scaled_up:
                return Ciphertext(dev, tprod=dev.mul_const_tensored(
                    self.tprod, const_evals))
            return Ciphertext(dev, parts=dev.mul_const(self.parts,
                                                       const_evals))
        ell = int(other)
        if self.scaled_up:
            s_mod = _i32(dev, (ell % self.ctx.primes)[:, None])
            return Ciphertext(dev, tprod=dev.mul_scalar_tensored(self.tprod,
                                                                 s_mod))
        return Ciphertext(dev, parts=dev.mul_scalar(self.parts, abs(ell),
                                                    ell < 0))

    # -- automorphism / rotation (Ciphertext.cpp:264-275)
    def automorph(self, k: int) -> "Ciphertext":
        dev = self.dev
        perm = dev.automorph_perm(k)
        if self.scaled_up:
            return Ciphertext(dev, tprod=dev.automorph_tensored(self.tprod,
                                                                perm))
        return Ciphertext(dev, parts=dev.automorph(self.parts, perm))

    __rshift__ = automorph

    def to_python_parts(self) -> list[list[int]]:
        """Coefficient lists (Python ints) for oracle comparison."""
        if self.scaled_up:
            raise ValueError("tensored ciphertext has no coefficient parts")
        parts = self.parts.cpu().numpy()
        return [[limbs_to_int(parts[i, j]) for j in range(parts.shape[1])]
                for i in range(parts.shape[0])]

    def __repr__(self):
        state = "tensored" if self.scaled_up else "parts"
        return (f"Ciphertext({state}={self.num_parts()}, "
                f"phim={self.ctx.phim}, logQ={self.ctx.log_q})")
