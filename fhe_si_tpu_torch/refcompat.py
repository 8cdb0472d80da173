"""Bridges between reference-format artifacts and the port's objects.

Counterpart of fhe_si_tpu/refcompat.py.  The reference stores keys as
DoubleCRT residues in ITS prime basis (~60-bit NTL primes, evaluations
at (root^2)^{t_j} per bluestein.h:26: BluesteinFFT(...,root,...) =
DFT(...,root^2,...)).  Ciphertexts are stored in the coefficient domain
(ScaleDown before export), so they convert directly; keys are re-based
exactly: interpolate per reference prime, CRT across the reference
chain, then re-encode in the port's basis through DeviceContext.from_poly
(or read back through DeviceContext.to_poly).  All re-basing is
host-side exact Python-int math (import and export are set-up
operations).  Import functions take the DeviceContext the objects will
live on.
"""
from __future__ import annotations

import numpy as np
import torch

from . import refserial, scheme
from .apps.matrix import Matrix
from .context import MAX_KSW_PARTS, FheContext, ints_to_limbs, limbs_to_int
from .device import DeviceContext
from .hostmath import numbth


def context_from_reference(ref: refserial.RefContext) -> FheContext:
    """An equivalent context (same scheme parameters; the port's own
    device prime basis: the chain is an internal exact-arithmetic device,
    SURVEY §1)."""
    return FheContext(m=ref.m, log_q=ref.log_q, p=ref.p,
                      generator=ref.generator, decomp_size=ref.decomp_size)


# ------------------------------------------------------- reference NTT basis
def _ref_eval_points(ref: refserial.RefContext, ctx: FheContext, q: int,
                     root: int) -> list[int]:
    """omega^t for t in (Z/mZ)* ascending, omega = root^2 mod q."""
    omega = root * root % q
    pw = [1] * ref.m
    for i in range(1, ref.m):
        pw[i] = pw[i - 1] * omega % q
    return [pw[int(t)] for t in ctx.zms], pw


def _interpolate_mod_prime(row: np.ndarray, ref: refserial.RefContext,
                           ctx: FheContext, q: int, root: int) -> list[int]:
    """Inverse of the reference FFT for one prime: the deg<phim poly with
    f(omega^{t_j}) = row[j] mod q.  Zero-extend the evals over all m
    indices, full inverse DFT, reduce mod Phi_m (any filler values at
    non-primitive indices give the same class mod Phi_m; zeros chosen)."""
    m, phim = ref.m, ctx.phim
    omega = root * root % q
    # inverse DFT: c_k = m^{-1} sum_j y_{t_j} omega^{-k t_j}
    minv = numbth.modinv(m, q)
    pw = [1] * m
    winv = numbth.modinv(omega, q)
    for i in range(1, m):
        pw[i] = pw[i - 1] * winv % q
    full = [0] * m
    for k in range(m):
        acc = 0
        for j, t in enumerate(ctx.zms):
            acc += int(row[j]) * pw[(k * int(t)) % m]
        full[k] = acc % q * minv % q
    # reduce mod Phi_m over Z_q
    phi = [c % q for c in ctx.phim_x]
    for i in range(m - 1, phim - 1, -1):
        c = full[i]
        if c:
            for d in range(phim + 1):
                full[i - phim + d] = (full[i - phim + d] - c * phi[d]) % q
    return full[:phim]


def dcrt_to_poly(dcrt: dict[int, np.ndarray], ref: refserial.RefContext,
                 ctx: FheContext) -> list[int]:
    """Reference DoubleCRT residues -> exact centered coefficients
    (toPoly semantics, DoubleCRT.cpp:349-398, over the reference chain)."""
    polys = []
    primes = []
    for idx in sorted(dcrt):
        q, root = ref.chain[idx]
        polys.append(_interpolate_mod_prime(dcrt[idx], ref, ctx, q, root))
        primes.append(q)
    P = 1
    out = [0] * ctx.phim
    for r, q in enumerate(primes):
        if r == 0:
            out = [c % q for c in polys[0]]
            P = q
            continue
        pinv = numbth.modinv(P % q, q)
        for j in range(ctx.phim):
            delta = (polys[r][j] - out[j]) * pinv % q
            out[j] += P * delta
        P *= q
    half = P // 2
    return [c - P if c % P > half else c % P for c in [v % P for v in out]]


def poly_to_dcrt(coeffs: list[int], ref: refserial.RefContext,
                 ctx: FheContext) -> dict[int, np.ndarray]:
    """Exact coefficients -> reference-basis DoubleCRT residues (the
    reference's FFT, for exporting keys to its format)."""
    out = {}
    for idx, (q, root) in enumerate(ref.chain):
        points, pw = _ref_eval_points(ref, ctx, q, root)
        red = [int(c) % q for c in coeffs[:ctx.phim]]
        row = np.zeros(ctx.phim, dtype=np.int64)
        for j, t in enumerate(ctx.zms):
            acc = 0
            for k, c in enumerate(red):
                if c:
                    acc += c * pw[(int(t) * k) % ref.m]
            row[j] = acc % q
        out[idx] = row
    return out


def _signed(poly: list[int], q: int) -> list[int]:
    """Each value's representative in [-q/2, q/2)."""
    half = q // 2
    return [(v % q) - q if (v % q) >= half else (v % q) for v in poly]


def _i32(dev: DeviceContext, a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.int32), device=dev.device)


def _limbs_rows_to_ints(limbs: np.ndarray) -> list[int]:
    return [limbs_to_int(limbs[j]) for j in range(limbs.shape[0])]


def _parts_to_limbs(parts: list[list[int]], ctx: FheContext) -> np.ndarray:
    """Reference ciphertext parts (coefficients in [0, q), Reduce-positive
    before export) as [k, phim, n_ct] limbs: they fit the ciphertext width
    as nonnegative two's complement."""
    return np.stack([
        ints_to_limbs((part + [0] * (ctx.phim - len(part)))[:ctx.phim],
                      ctx.n_limbs_ct)
        for part in parts])


# ----------------------------------------------------------- object bridges
def import_ciphertext(buf: bytes, dev: DeviceContext) -> scheme.Ciphertext:
    parts = refserial.read_ciphertext(buf)
    return scheme.Ciphertext(dev, parts=_i32(dev, _parts_to_limbs(parts,
                                                                  dev.ctx)))


def export_ciphertext(ct: scheme.Ciphertext) -> bytes:
    return refserial.write_ciphertext(ct.relinearized_view().to_python_parts())


def import_public_key(buf: bytes, ref: refserial.RefContext,
                      dev: DeviceContext) -> scheme.FhePublicKey:
    """FHESIPubKey::Import (FHE-SI.cpp:72-78): vector<DoubleCRT> in the
    reference basis -> FhePublicKey with exact re-basing.

    The imported coefficients are re-reduced to the signed representative
    in [-q/2, q/2) (the library invariant for n_ct-width parts).  Encrypt
    outputs are unchanged by the representative choice: pk -> pk + t*q
    shifts pk*r + p*e by t*q*r, which the final Reduce mod 2^logQ
    erases exactly."""
    ctx = dev.ctx
    rows = [ints_to_limbs(_signed(dcrt_to_poly(d, ref, ctx), ctx.q),
                          ctx.n_limbs_ct)
            for d in refserial.read_key(buf)]
    pk_limbs = _i32(dev, np.stack(rows))
    return scheme.FhePublicKey(dev, dev.from_poly(pk_limbs), pk_limbs)


def export_public_key(pk: scheme.FhePublicKey,
                      ref: refserial.RefContext) -> bytes:
    """FHESIPubKey::Export (FHE-SI.cpp:72-78) in the reference basis."""
    arr = pk.pk_limbs.cpu().numpy()
    return refserial.write_key([
        poly_to_dcrt(_limbs_rows_to_ints(arr[i]), ref, pk.ctx)
        for i in range(arr.shape[0])])


def import_keyswitch(buf: bytes, ref: refserial.RefContext,
                     dev: DeviceContext) -> scheme.KeySwitch:
    """KeySwitchSI::Import (FHE-SI.cpp:270-276): the 2 x K matrix of
    DoubleCRTs, re-based exactly and re-reduced to the signed
    representative (the derived ksw bound assumes |M| <= q/2; keyswitch
    outputs are invariant to the representative because the final Reduce
    mod 2^logQ erases q-multiples of the digit dot)."""
    ctx = dev.ctx
    rows = refserial.read_keyswitch(buf)
    assert len(rows) == 2, "keyswitch matrix must have 2 rows"
    K = len(rows[0])
    if K > MAX_KSW_PARTS * ctx.ndigits:
        raise ValueError(
            f"imported keyswitch matrix has {K} columns; the subset basis "
            f"is provisioned for MAX_KSW_PARTS={MAX_KSW_PARTS} parts "
            f"({MAX_KSW_PARTS * ctx.ndigits} columns)")
    limbs = np.empty((2, K, ctx.phim, ctx.n_limbs_ct), dtype=np.int32)
    for i in range(2):
        for k in range(K):
            limbs[i, k] = ints_to_limbs(
                _signed(dcrt_to_poly(rows[i][k], ref, ctx), ctx.q),
                ctx.n_limbs_ct)
    return scheme.KeySwitch(dev, dev.from_poly(_i32(dev, limbs)))


def export_keyswitch(ksw: scheme.KeySwitch,
                     ref: refserial.RefContext) -> bytes:
    """KeySwitchSI::Export (FHE-SI.cpp:270-276) in the reference basis.
    Matrix entries are reduce_signed representatives (|v| <= q/2), so the
    full-chain toPoly reconstruction is exact."""
    limbs = ksw.dev.to_poly(ksw.matrix_evals).cpu().numpy()
    return refserial.write_keyswitch([
        [poly_to_dcrt(_limbs_rows_to_ints(limbs[i, k]), ref, ksw.dev.ctx)
         for k in range(limbs.shape[1])]
        for i in range(limbs.shape[0])])


def export_ciphertext_matrix(mat) -> bytes:
    """Matrix<Ciphertext> app state (Regression/Statistics blocks) in the
    reference's templated Matrix framing (Serialization.h:58-81):
    ciphertexts are ScaleDown'd before export (Serialization.cpp:109-114
    semantics, via relinearized_view)."""
    return refserial.write_ciphertext_matrix([
        [mat.at(r, c).relinearized_view().to_python_parts()
         for c in range(mat.num_cols())]
        for r in range(mat.num_rows())])


def import_ciphertext_matrix(buf: bytes, dev: DeviceContext) -> Matrix:
    """Inverse of export_ciphertext_matrix -> apps.matrix.Matrix of
    scheme.Ciphertext."""
    return Matrix([
        [scheme.Ciphertext(dev, parts=_i32(dev, _parts_to_limbs(parts,
                                                                dev.ctx)))
         for parts in row]
        for row in refserial.read_ciphertext_matrix(buf)])


def import_secret_key(buf: bytes, ref: refserial.RefContext,
                      dev: DeviceContext) -> scheme.FheSecretKey:
    ctx = dev.ctx
    evals = []
    for d in refserial.read_key(buf):
        poly = dcrt_to_poly(d, ref, ctx)
        # centered values from the reference basis can exceed the narrow
        # ct width; size the limbs to the actual coefficients
        need = max((abs(v).bit_length() for v in poly), default=1) + 2
        nw = min(max(ctx.n_limbs_ct, (need + 15) // 16), ctx.n_limbs)
        evals.append(dev.from_poly(_i32(dev, ints_to_limbs(poly, nw))))
    return scheme.FheSecretKey(dev, torch.stack(evals))


def export_secret_key(sk: scheme.FheSecretKey,
                      ref: refserial.RefContext) -> bytes:
    dcrts = []
    for i in range(sk.sk_evals.shape[0]):
        limbs = sk.dev.to_poly(sk.sk_evals[i]).cpu().numpy()
        dcrts.append(poly_to_dcrt(_limbs_rows_to_ints(limbs), ref, sk.ctx))
    return refserial.write_key(dcrts)


def export_reference_context(ctx: FheContext,
                             chain: list[tuple[int, int]] | None = None
                             ) -> bytes:
    """Write an SI-context stream.  With chain=None, exports the port's
    device chain (q, root-of-order-m), readable by this library and
    fhe_si_tpu; to target the actual reference binaries pass a chain of
    NTL-sized primes with 2m-th roots, as they assert p % 2m == 1
    (FHEContext.cpp:30-43)."""
    if chain is None:
        chain = [(int(q), int(r)) for q, r in zip(ctx.primes, ctx.roots)]
    return refserial.write_context(refserial.RefContext(
        ctx.m, ctx.log_q, ctx.p, ctx.generator, ctx.decomp_size, chain))
