"""FheContext: static, explicit context of the FHE-SI scheme, computed once
on the host (Python ints + numpy).

The port's own copy of fhe_si_tpu/context.py, so that the port imports
nothing of the JAX package.  It differs from it in two places only:
ct_supported comes from the numpy-only ops/ntt_ct.py of this package,
and the fast CRT tables carry no B_chunks (int8 planes whose only reader
is the JAX package's MXU reconstruction path, which is not ported).
Every other table and bound is computed by the same code, and
tests/test_torch_host.py holds the two contexts equal.

Replaces the reference's mutable global ``activeContext`` pattern
(FHEContext.h:43, FHEContext.cpp:21) with an explicit immutable object that
is computed once on the host (Python arbitrary-precision ints + numpy) and
baked into jit-compiled device programs as static tables.

Reference components covered here (file:line into the C++ fhe-si sources):
  - PAlgebra (structure of (Z/mZ)*): PAlgebra.h:53-88, PAlgebra.cpp:40-56
  - PlaintextSpace (slot CRT packing): PlaintextSpace.cpp:22-134
  - FHEcontext (moduli chain, q=2^logQ, digit params): FHEContext.h:45-206
  - SetUpSIContext prime budget: FHEContext.cpp:83-115
  - Cmodulus per-prime transform tables: CModulus.cpp:59-137

TPU-first representational choices (see SURVEY §1, §7):
  - The ciphertext modulus is q = 2^logQ; the odd-prime chain is an exact
    arithmetic device only.  Bit-exactness targets coefficient-domain
    results, so the chain uses 20-bit primes ≡ 1 (mod m) that fit int32
    lanes (reference uses ~60-bit NTL primes ≡ 1 mod 2m; the basis is an
    internal choice, SURVEY.md §1 "may legally use a different prime
    basis as long as the product bound holds").
  - The per-prime NTT (evaluate at primitive m-th roots / interpolate
    back) is materialised as a pair of phim x phim integer matrices per
    prime: on TPU an exact modular matmul on the MXU beats a Bluestein
    chirp pipeline on the VPU for every m this library targets.  The
    inverse matrix is built in closed form (full inverse DFT restricted
    to primitive columns, then reduction mod Phi_m) — no matrix
    inversion needed.
  - Big coefficients mod 2^logQ (and CRT-reconstruction intermediates)
    live as 16-bit limbs in int32 lanes; this module precomputes every
    limb-domain constant the device kernels need.
"""
from __future__ import annotations

import math
from functools import cached_property

import numpy as np

from .hostmath import numbth

LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1
PRIME_MAX_BITS = 20  # chain primes < 2^20: 10-bit split modmul stays int32-exact
# Wide residue lane: primes < 2^23 (ops/ntt.py wide-lane header derives
# every bound from exactly this cap).  Selected automatically when the
# 20-bit window cannot fund the chain — at m = 2^14 only 9 primes q = 1
# (mod m) exist below 2^20, but ~65 below 2^23 (the reference's 60-bit
# NTL window never starves; the basis is an internal choice, SURVEY §1).
PRIME_MAX_BITS_WIDE = 23
PRIME_MIN_BITS = 14  # f32-Barrett quotient error budget needs q >= 2^14

# Plaintext modulus cap.  p rides very different lanes than the chain
# primes: it enters the device only as p mod q_l (evaluation domain),
# as the limb constants floor(q/p) and 2p (mod-2^logQ domain), and in
# the decrypt tail's final mod-p (ops/limbs.mod_p_bounded quotient
# estimation for p >= 2^20, whose correction adds need p < 2^30 to stay
# int32-exact).  The reference's p is an NTL ZZ (FHEContext.h:91-99).
PLAINTEXT_MAX_BITS = 30

# Worst-case part count any key-switch matrix may carry (relinearization
# uses 3: the tensored key (1, s, s^2), FHE-SI.cpp:211-227; automorph
# uses 2).  Enforced at KeySwitch build/apply time, and the keyswitch
# subset basis (ksw_value_primes) is provisioned for exactly this cap —
# a larger matrix would breach the derived exactness bound, so it is
# rejected, never silently corrupted.
MAX_KSW_PARTS = 4

# Mixed-radix rings (even m, prime-power odd part) switch from the dense
# transform family to the O(L*m) Cooley-Tukey family above this phim:
# below it the dense MXU DFT is the measured-faster path (23.5% MFU at
# phim=2002, BASELINE.md) and its tables fit comfortably.
CT_PHIM_THRESHOLD = 2048

# Structural bound on every Gaussian sample: sampling.gaussian_poly clamps
# the Box-Muller radius at r2 >= 1e-300, so |sample| <= sqrt(-2*ln 1e-300)
# * stdev + 1 < 37.2*stdev + 1.  (NumbTh.cpp:387-402 has the same shape;
# NTL's PRG cannot produce r2 = 0 either.)
GAUSS_BOUND_FACTOR = 38


def int_to_limbs(x: int, n: int) -> np.ndarray:
    """x mod 2^(16n) as n little-endian 16-bit limbs (two's complement)."""
    x &= (1 << (LIMB_BITS * n)) - 1
    return np.array([(x >> (LIMB_BITS * i)) & LIMB_MASK for i in range(n)],
                    dtype=np.int32)


def ints_to_limbs(values, n: int) -> np.ndarray:
    """Vectorized int_to_limbs for a flat iterable of Python ints ->
    int32 [len, n].  Uses int.to_bytes (C speed) instead of per-limb
    Python shifts — the setup-time hot path for key material."""
    mask = (1 << (LIMB_BITS * n)) - 1
    nbytes = 2 * n
    buf = b"".join((v & mask).to_bytes(nbytes, "little") for v in values)
    arr = np.frombuffer(buf, dtype="<u2").reshape(-1, n)
    return arr.astype(np.int32)


def exact_modmatmul_f64(a: np.ndarray, b: np.ndarray, q: int,
                        k_chunk: int | None = None) -> np.ndarray:
    """Exact (a @ b) mod q for entries < q using float64 BLAS.

    Per-chunk products are < q^2 * k_chunk < 2^52 — exactly representable
    in f64, so dgemm is exact; chunks are reduced mod q before summing.
    The chunk length is derived from q (2048 for 20-bit primes, 64 for
    23-bit).  ~100x faster than numpy's loop-based int64 matmul.
    """
    if k_chunk is None:
        k_chunk = max(1, (1 << 52) // (q * q))
    out = np.zeros((a.shape[0], b.shape[1]), dtype=np.int64)
    af = a.astype(np.float64)
    bf = b.astype(np.float64)
    for s in range(0, a.shape[1], k_chunk):
        part = af[:, s:s + k_chunk] @ bf[s:s + k_chunk]
        out = (out + part.astype(np.int64) % q) % q
    return out


def matmul_mod_blocked(A: np.ndarray, v: np.ndarray, p: int) -> np.ndarray:
    """Exact (A @ v) % p for int64 entries in [0, p): partial sums are
    reduced every `step` columns so they stay below 2^62 (needed once
    p approaches the 2^30 plaintext cap)."""
    k = A.shape[1]
    if p * p * max(1, k) < (1 << 62):
        return (A @ v) % p
    step = max(1, (1 << 62) // (p * p))
    out = np.zeros(A.shape[:1] + v.shape[1:], dtype=np.int64)
    for s in range(0, k, step):
        out = (out + A[:, s:s + step] @ v[s:s + step]) % p
    return out


def limbs_to_int(limbs, signed: bool = True) -> int:
    """Inverse of int_to_limbs; interprets as two's complement if signed."""
    limbs = np.asarray(limbs)
    n = limbs.shape[-1]
    x = 0
    for i in range(n - 1, -1, -1):
        x = (x << LIMB_BITS) | (int(limbs[..., i]) & LIMB_MASK)
    if signed and x >= 1 << (LIMB_BITS * n - 1):
        x -= 1 << (LIMB_BITS * n)
    return x


class FheContext:
    """Immutable scheme context.

    Mirrors FHEcontext::Init (FHEContext.h:105-118) + SetUpSIContext
    (FHEContext.cpp:83-85): construct with the same five parameters the
    reference tests use, and the prime chain is provisioned from the same
    budget  2*ln(q) + ln(p) + 2*ln(phim) + ln(2) + ln(xi).
    """

    def __init__(self, m: int, log_q: int, p: int, generator: int,
                 decomp_size: int = 3, xi: int = 1, stdev: float = 3.2,
                 primes: list[int] | None = None,
                 roots: list[int] | None = None,
                 num_primes_multiple: int = 1,
                 prime_bits: int | None = None):
        if p >= 1 << PLAINTEXT_MAX_BITS:
            raise NotImplementedError(
                f"plaintext modulus p={p} >= 2^{PLAINTEXT_MAX_BITS} is not "
                "supported: slot values and the Barrett corrections of the "
                "decrypt tail must fit int32 lanes")
        if log_q <= p.bit_length() + 1:
            raise ValueError(
                f"logQ={log_q} leaves no room above p={p} (the message "
                "rides the top bits: q/p must exceed 1, FHE-SI.cpp:31)")
        if not numbth.is_prime(p):
            raise ValueError(
                f"plaintext modulus p={p} must be prime (the slot "
                "structure factors Phi_m over the field Z_p, "
                "PlaintextSpace.cpp:28-30)")
        if not 1 <= decomp_size <= 8:
            raise ValueError(
                f"decompSize={decomp_size} not supported: ByteDecomp "
                "digits ride int32 lanes (<= 3 bytes) or 16-bit limb "
                "planes (4-8 bytes, ops/limbs.byte_decomp_planes); the "
                "reference constructor accepts any value but every "
                "shipped binary uses the default 3 (FHEContext.h:86-99)")
        self.m = m
        self.log_q = log_q
        self.q = 1 << log_q
        self.p = p
        self.generator = generator
        self.decomp_size = decomp_size
        self.stdev = stdev
        self.xi = xi
        # ndigits = ceil(logQ / (8*decompSize))   (FHEContext.h:114-115)
        self.ndigits = (log_q + 8 * decomp_size - 1) // (8 * decomp_size)
        self.digit_bits = 8 * decomp_size

        # ---- PAlgebra: structure of (Z/mZ)*  (PAlgebra.cpp:40-56) ----
        zms_idx = np.full(m, -1, dtype=np.int64)
        zms = [i for i in range(m) if math.gcd(i, m) == 1]
        for idx, t in enumerate(zms):
            zms_idx[t] = idx
        self.zms = np.array(zms, dtype=np.int64)      # primitive residues, ascending
        self.zms_idx = zms_idx                        # residue -> slot row, or -1
        self.phim = len(zms)
        self.phim_x = numbth.cyclotomic(m)            # Phi_m coefficients (monic)

        # ---- prime chain (SetUpSIContext budget, FHEContext.cpp:83-85) ----
        if primes is None:
            budget = (2 * log_q * math.log(2) + math.log(p)
                      + 2 * math.log(self.phim) + math.log(2) + math.log(max(xi, 1)))

            def build_chain(max_bits):
                chain = numbth.generate_prime_chain(
                    m, budget, max_bits=max_bits, exclude=(p,))
                # +1 redundant modulus for single-pass CRT reconstruction
                extra = 1
                if (len(chain) + extra) % num_primes_multiple:
                    # pad so the CRT-limb axis shards evenly over a mesh
                    extra += (num_primes_multiple
                              - (len(chain) + extra) % num_primes_multiple)
                return numbth.extend_prime_chain(chain, m, extra, exclude=(p,))

            if prime_bits is not None:
                primes = build_chain(prime_bits)
            else:
                # narrow 20-bit lane when the window funds the chain
                # (2 Barrett steps/modmul, 6 MXU dots/transform); fall
                # back to the wide 23-bit lane when it starves (m >= 2^14)
                try:
                    primes = build_chain(PRIME_MAX_BITS)
                except ValueError:
                    primes = build_chain(PRIME_MAX_BITS_WIDE)
        self.primes = np.array(primes, dtype=np.int64)
        self.num_primes = len(primes)
        self.prime_bits = max(int(q).bit_length() for q in primes)
        if self.prime_bits > PRIME_MAX_BITS_WIDE:
            raise ValueError(
                f"chain prime exceeds 2^{PRIME_MAX_BITS_WIDE}: the wide "
                "residue lane's int8 digit bounds assume q < 2^23 "
                "(ops/ntt.py)")
        if min(int(q) for q in primes) < (1 << PRIME_MIN_BITS):
            raise ValueError(
                f"chain prime below 2^{PRIME_MIN_BITS}: the f32-Barrett "
                "quotient error budget assumes q >= 2^14 (ops/modular.py)")
        # wide lane: 4x6-bit digit machinery throughout (ops/ntt.py)
        self.wide = self.prime_bits > PRIME_MAX_BITS
        if self.wide and MAX_KSW_PARTS * self.ndigits > 64:
            raise ValueError(
                f"wide lane caps keyswitch rows at 64 (mod_dot unreduced "
                f"accumulation); MAX_KSW_PARTS*ndigits = "
                f"{MAX_KSW_PARTS * self.ndigits} — increase decompSize")
        self.prime_product = math.prod(int(q) for q in primes)
        # The LAST chain prime is a redundant modulus (Shenoy-Kumaresan):
        # the value-carrying CRT basis is primes[:-1] (whose product meets
        # the SetUpSIContext budget on its own); the extra tracked row lets
        # to_poly reconstruct in one parallel pass with an exact small
        # correction factor, instead of a serial O(L^2) Garner scan.
        self.crt_product = math.prod(int(q) for q in primes[:-1])
        # order-m root of unity per prime (deterministic; Cmodulus analog,
        # CModulus.cpp:59-86 — we need order m, not 2m: the matmul-DFT uses
        # no negacyclic chirp).  Imported contexts restore their saved roots
        # so transforms rebuild identically (FHEContext.cpp:62-81 parity).
        if roots is None:
            roots = [numbth.find_element_of_order(int(q), m) for q in primes]
        self.roots = np.array(roots, dtype=np.int64)

        # ---- limb widths ----
        # Full width covers CRT-reconstructed centered values |x| < P/2
        # plus the *2p headroom of the decrypt rounding (FHE-SI.cpp:113-117):
        # |d*2p + q| adds (2p).bit_length()+1 bits over |d|.
        self._round_headroom = max(24, (2 * p).bit_length() + 4)
        self.n_limbs = ((self.prime_product.bit_length() + self._round_headroom)
                        // LIMB_BITS + 2)
        # Ciphertext width: persistent parts hold values mod 2^logQ (two's
        # complement, |v| <= q after one un-reduced add), so they only need
        # ceil((logQ+1)/16) limbs — ~2.6x narrower than the reconstruction
        # width at production scale.  Every mod-2^logQ op (add, mul_small,
        # byte_decomp, reduce) is exact at ANY width with 16n >= logQ+1
        # because 2^logQ | 2^(16n); only the exact-integer paths (CRT
        # reconstruction, ScaleDown/decrypt rounding, unreduced automorph)
        # carry wider per-basis widths (fast_crt_tables 'n_rec').
        self.n_limbs_ct = (log_q + LIMB_BITS) // LIMB_BITS

        # Scaling transform family: the scheme's NTTs run through the
        # two-level Cooley-Tukey factorization (ops/ntt_ct.py) — O(L*m)
        # tables instead of the dense O(L*phim^2) family, the only
        # memory shape that scales past phim ~ 4k (the reference scales
        # with Bluestein the same way: O(m) memory at any m,
        # bluestein.cpp:92-144).  Covered rings: power-of-two m always;
        # any even m whose odd part is an odd prime power (m = 2^a*q^b,
        # e.g. the m = p-1 family for safe primes, or 40960 = 2^13*5)
        # once phim outgrows the dense family's measured sweet spot.
        from .ops.ntt_ct import ct_supported   # numpy only
        self.use_ct = (m & (m - 1) == 0 and m >= 8) or (
            ct_supported(m) and self.phim > CT_PHIM_THRESHOLD)
        if not self.use_ct and self.phim > 4096:
            raise NotImplementedError(
                f"m={m} (phim={self.phim}) needs the dense O(L*phim^2) "
                "transform tables, which are impractical past phim ~ 4k; "
                "the scaling family covers even m with a prime-power odd "
                "part (m = 2^a*q^b, ops/ntt_ct.py)")

        # ---- plaintext space ----
        self._init_plaintext_space()

        # derived exactness bounds must hold on the provisioned chain
        self._check_chain_budget()

        self._automorph_perms: dict[int, np.ndarray] = {}

    # -------------------------------------------------------------- plaintext
    def _init_plaintext_space(self):
        """Slot structure of Z[X]/(Phi_m, p)  (PlaintextSpace.cpp:22-110).

        Two regimes, split on d = ord_m(p) (the common degree of the
        irreducible factors of Phi_m mod p):

        d == 1 (m | p-1, all shipped reference configs): Phi_m splits into
        linear factors X - zeta_j and each slot is Z_p.  Slot order is the
        generator cycle zeta_j = zeta^(g^j), which makes the automorphism
        X -> X^g a cyclic slot shift — the same property the reference
        establishes with its Frobenius-map reordering
        (PlaintextSpace.cpp:69-110).  Fast dense-matrix construction.

        d > 1 (extension-field slots): Phi_m factors into phim/d
        irreducible degree-d factors (SFCanZass analog in hostmath/gf.py)
        and each slot is GF(p^d) — slot values are degree-<d coefficient
        vectors mod p.  CRT coefficients follow PlaintextSpace.cpp:44-51;
        slots are ordered by the g-coset cycle so automorph-by-g is still
        a cyclic slot shift.
        """
        m, p, g = self.m, self.p, self.generator
        if math.gcd(p, m) != 1:
            raise ValueError(f"p={p} and m={m} must be coprime")
        if (p - 1) % m != 0:
            self._init_plaintext_space_ext()
            return
        self.slot_degree = 1
        self.total_slots = self.phim

        zeta = numbth.find_element_of_order(p, m)  # canonical primitive m-th root
        pow_zeta = np.empty(m, dtype=np.int64)
        acc = 1
        for i in range(m):
            pow_zeta[i] = acc
            acc = acc * zeta % p
        self.zeta = zeta
        self._pow_zeta = pow_zeta

        # Slot exponents t_j with zeta_j = zeta^(t_j), ordered by g-orbit
        # cycles so automorphism-by-g is a cyclic shift within each cycle
        # (the property the reference establishes with its Frobenius-map
        # reordering, PlaintextSpace.cpp:69-110).  When g generates the
        # whole of (Z/mZ)* this is one cycle t_j = g^j — every shipped
        # reference config.  For power-of-two m >= 8 the group is NOT
        # cyclic (Z/2 x Z/2^(k-2)), so no single g can generate it; the
        # slots split into total/ord(g) cycles (coset representatives in
        # ascending residue order) and usableSlots covers the first cycle.
        ord_g = numbth.multiplicative_order(g, m)
        n_cycles = self.total_slots // ord_g
        if n_cycles > 1 and numbth.is_cyclic_group(m):
            raise ValueError(
                f"generator {g} does not generate (Z/{m}Z)*: slot cycle is shorter "
                "than the slot count")
        seen = np.zeros(m, dtype=bool)
        slot_exp = []
        for rep in self.zms:
            if seen[rep]:
                continue
            t = int(rep)
            for _ in range(ord_g):
                slot_exp.append(t)
                seen[t] = True
                t = t * g % m
        assert len(slot_exp) == self.total_slots
        self.slot_cycles = n_cycles
        self.slot_exponents = np.array(slot_exp, dtype=np.int64)
        # usableSlots = largest power of two <= the g-cycle the apps can
        # rotate over (= totalSlots when g generates, PlaintextSpace.cpp:37-42)
        self.usable_slots = 1 << (ord_g.bit_length() - 1)

    # Decode matrix D[j, c] = zeta_j^c (evaluation at slot roots) and
    # embed matrix E[:, j] = Lagrange basis L_j(X) coefficients mod p,
    # L_j = (Phi_m/(X - zeta_j)) / Phi_m'(zeta_j): the CRT coefficients of
    # PlaintextSpace::Init (PlaintextSpace.cpp:44-51) for linear factors.
    # Lazy: the [phim, phim] tables cost O(phim^2) memory (0.5 GB at
    # m = 2^14) and only the slot-packing paths need them — Test_AddMul
    # style direct-coefficient workloads never build them.
    @cached_property
    def decode_matrix(self) -> np.ndarray:
        c = np.arange(self.phim, dtype=np.int64)
        return self._pow_zeta[(self.slot_exponents[:, None] * c[None, :]) % self.m]

    @cached_property
    def embed_matrix(self) -> np.ndarray:
        p, phim = self.p, self.phim
        zj = self._pow_zeta[self.slot_exponents]            # [S]
        phi = np.array([c % p for c in self.phim_x], dtype=np.int64)
        # synthetic division of Phi_m by every (X - zeta_j) at once;
        # carry*zj < p^2 < 2^60 stays int64-exact
        quot = np.empty((phim, self.total_slots), dtype=np.int64)
        carry = np.full(self.total_slots, phi[phim] % p, dtype=np.int64)
        for d in range(phim - 1, -1, -1):
            quot[d] = carry
            carry = (phi[d] + carry * zj) % p
        if carry.any():
            raise AssertionError("zeta_j is not a root of Phi_m mod p")
        denom = np.zeros(self.total_slots, dtype=np.int64)
        for d in range(phim - 1, -1, -1):
            denom = (denom * zj + quot[d]) % p
        inv = np.array([numbth.modinv(int(x), p) for x in denom],
                       dtype=np.int64)
        return quot * inv[None, :] % p

    def _init_plaintext_space_ext(self):
        """Extension-field slots (ord_m(p) = d > 1): factor Phi_m mod p by
        cosets of <p>, build crtCoeffs per degree-d factor and the slot
        embed/decode linear maps.

        Matches PlaintextSpace::Init (PlaintextSpace.cpp:22-59):
        crtCoeff_j = (Phi/f_j) * InvMod((Phi/f_j) mod f_j, f_j); embed is
        sum_j crtCoeff_j * msg_j mod Phi (PlaintextSpace.cpp:112-121,
        msg_j a degree-<d poly); decode slot j is msg mod f_j
        (PlaintextSpace.cpp:123-134)."""
        from .hostmath import gf
        m, p, g = self.m, self.p, self.generator
        d, slot_exps, factors = gf.cyclotomic_slot_factors(m, p, g)
        S = self.phim // d
        self.slot_degree = d
        self.total_slots = S
        self.slot_cycles = 1
        # usableSlots = largest power of two <= totalSlots (PlaintextSpace.cpp:37-42)
        self.usable_slots = 1 << (S.bit_length() - 1)
        self.slot_exponents = np.array(slot_exps, dtype=np.int64)
        self.slot_factors = np.array(factors, dtype=np.int64)   # [S, d+1]

        phi_mod_p = [c % p for c in self.phim_x]
        phim = self.phim

        def reduce_mod_phi(a: list[int]) -> list[int]:
            """a mod (Phi_m, p); Phi monic so no inversions needed."""
            a = list(a)
            for i in range(len(a) - 1, phim - 1, -1):
                c = a[i]
                if c:
                    for k in range(phim + 1):
                        a[i - phim + k] = (a[i - phim + k] - c * phi_mod_p[k]) % p
            return a[:phim]

        # E[:, j, e] = coeffs of (crtCoeff_j * X^e) mod Phi
        E = np.zeros((phim, S, d), dtype=np.int64)
        # Dt[j, :, c] = coeffs of X^c mod f_j
        Dt = np.zeros((S, d, phim), dtype=np.int64)
        for j in range(S):
            f_j = factors[j]
            quot, rem = gf.pdivmod(phi_mod_p, f_j, p)
            assert not rem, "slot factor does not divide Phi_m mod p"
            te = gf.pmod(quot, f_j, p)
            inv = gf.pinv_mod(te, f_j, p)
            crt = gf.pmul(quot, inv, p)          # degree <= phim-1
            col = crt + [0] * (phim - len(crt))
            for e in range(d):
                E[:, j, e] = col
                col = reduce_mod_phi([0] + col)  # * X, re-reduce
            cur = [0] * d
            cur[0] = 1
            for c in range(phim):
                Dt[j, :, c] = cur
                top = cur[d - 1]
                cur = [0] + cur[:d - 1]
                if top:
                    for k in range(d):
                        cur[k] = (cur[k] - top * f_j[k]) % p
        self.embed_matrix = E.reshape(phim, S * d)
        self.decode_tensors = Dt

    def embed_in_slots(self, values, only_usable: bool = True) -> np.ndarray:
        """Pack per-slot values mod p into a plaintext polynomial.

        Mirrors PlaintextSpace::EmbedInSlots (PlaintextSpace.cpp:112-121):
        slots beyond len(values) are zero; with only_usable, slots past
        usable_slots are zero as well.  With extension-field slots
        (slot_degree d > 1) each value may be a scalar (a GF(p) constant)
        or a length-<=d coefficient vector (an element of GF(p^d)).
        """
        limit = self.usable_slots if only_usable else self.total_slots
        d = self.slot_degree
        arr = np.asarray(values, dtype=np.int64)
        if d == 1 and arr.ndim <= 1:
            vals = np.zeros(self.total_slots, dtype=np.int64)
            use = min(len(arr), limit)
            vals[:use] = arr[:use] % self.p
            return matmul_mod_blocked(self.embed_matrix, vals, self.p)
        vals = np.zeros((self.total_slots, d), dtype=np.int64)
        use = min(len(arr), limit)
        if arr.ndim == 1:                      # per-slot constants
            vals[:use, 0] = arr[:use] % self.p
        else:
            vals[:use, :arr.shape[1]] = arr[:use] % self.p
        return matmul_mod_blocked(self.embed_matrix, vals.reshape(-1), self.p)

    def decode_slots(self, poly_mod_p) -> np.ndarray:
        """Decode every slot (DecodeSlots, PlaintextSpace.cpp:123-134).

        slot_degree == 1: evaluate at every slot root; returns [S].
        slot_degree d > 1: remainder mod each factor; returns [S, d]."""
        coeffs = np.zeros(self.phim, dtype=np.int64)
        arr = np.asarray(poly_mod_p, dtype=np.int64) % self.p
        coeffs[:len(arr)] = arr
        if self.slot_degree > 1:
            S, d = self.total_slots, self.slot_degree
            flat = matmul_mod_blocked(
                self.decode_tensors.reshape(S * d, self.phim), coeffs, self.p)
            return flat.reshape(S, d)
        return matmul_mod_blocked(self.decode_matrix, coeffs, self.p)

    def rotate_slots(self, slots: np.ndarray, k: int) -> np.ndarray:
        """Slot rotation by k positions (Plaintext::operator>>= semantics,
        Plaintext.h:88-97): one cyclic roll when g generates the group;
        with multiple g-orbit cycles (power-of-two m) each cycle rolls
        independently — the action the ciphertext automorphism X -> X^(g^k)
        induces on the slot grid."""
        slots = np.asarray(slots)
        if self.slot_cycles == 1:
            return np.roll(slots, -k, axis=0)
        cyc = self.total_slots // self.slot_cycles
        shaped = slots.reshape((self.slot_cycles, cyc) + slots.shape[1:])
        return np.roll(shaped, -k, axis=1).reshape(slots.shape)

    # -------------------------------------------------------------- automorph
    def automorph_perm(self, k: int) -> np.ndarray:
        """Row permutation of NTT slots for F(X) -> F(X^k).

        DoubleCRT::automorph semantics (DoubleCRT.cpp:439-465):
        new[zmsIdx[j]] = old[zmsIdx[j*k mod m]].
        """
        k = int(k) % self.m
        if math.gcd(k, self.m) != 1:
            raise ValueError(f"automorph: k={k} not in (Z/{self.m}Z)*")
        perm = self._automorph_perms.get(k)
        if perm is None:
            perm = np.empty(self.phim, dtype=np.int64)
            for j in self.zms:
                perm[self.zms_idx[j]] = self.zms_idx[j * k % self.m]
            self._automorph_perms[k] = perm
        return perm

    # ------------------------------------------------------------ NTT tables
    @cached_property
    def ntt_tables(self) -> tuple[np.ndarray, np.ndarray]:
        """(forward, inverse) exact modular DFT matrices, [L, phim, phim].

        forward[l] @ coeffs  == evaluations of the polynomial at the
        primitive m-th roots w_l^{t_j} mod q_l (Cmodulus::FFT semantics,
        CModulus.cpp:89-107).  inverse[l] @ evals == the unique
        representative mod Phi_m (Cmodulus::iFFT, CModulus.cpp:109-132),
        built as   (I | R) · (full inverse DFT restricted to primitive
        columns):  placing the phim evaluations at their primitive indices
        (zeros elsewhere), a full inverse DFT returns *some* degree<m poly
        that agrees with the target at every primitive root, hence is
        congruent to it mod Phi_m; R is the X^k-mod-Phi_m reduction matrix.
        """
        L, m, phim = self.num_primes, self.m, self.phim
        ks = np.arange(m, dtype=np.int64)
        cs = np.arange(phim, dtype=np.int64)
        # entries < 2^20: int32 halves host memory traffic for chunking
        fwd = np.empty((L, phim, phim), dtype=np.int32)
        inv = np.empty((L, phim, phim), dtype=np.int32)
        for l in range(L):
            q = int(self.primes[l])
            w = int(self.roots[l])
            pw = np.empty(m, dtype=np.int64)
            acc = 1
            for i in range(m):
                pw[i] = acc
                acc = acc * w % q
            # forward: F[j, c] = w^(t_j * c)
            fwd[l] = pw[(self.zms[:, None] * cs[None, :]) % m]
            # full inverse DFT restricted to primitive columns:
            # Wt[k, j] = m^{-1} * w^{-k * t_j}
            minv = numbth.modinv(m, q)
            Wt = pw[(-ks[:, None] * self.zms[None, :]) % m] * minv % q
            # reduction matrix: red[r] = coeffs of X^(phim+r) mod Phi_m (mod q)
            red = np.empty((m - phim, phim), dtype=np.int64)
            cur = np.array([c % q for c in self.phim_x[:phim]], dtype=np.int64)
            cur = (-cur) % q  # X^phim mod Phi_m = -(lower coeffs), Phi_m monic
            red[0] = cur
            for r in range(1, m - phim):
                top = cur[phim - 1]
                cur = np.roll(cur, 1)
                cur[0] = 0
                cur = (cur + top * red[0]) % q
                red[r] = cur
            if (m - phim) > 256:
                inv[l] = (Wt[:phim] + exact_modmatmul_f64(
                    red.T % q, Wt[phim:], q)) % q
            else:
                inv[l] = (Wt[:phim] + red.T @ Wt[phim:]) % q
        return fwd, inv

    # ------------------------------------------------------------ CRT tables
    @cached_property
    def garner_tables(self) -> dict:
        """Device tables for Garner mixed-radix CRT reconstruction and the
        centered reduction of DoubleCRT::toPoly (DoubleCRT.cpp:349-398)."""
        L, n = self.num_primes, self.n_limbs
        primes = [int(q) for q in self.primes]
        # invq[j, i] = q_j^{-1} mod q_i  (j < i), else 0
        invq = np.zeros((L, L), dtype=np.int64)
        for i in range(L):
            for j in range(i):
                invq[j, i] = numbth.modinv(primes[j], primes[i])
        # W_j = prod_{k<j} q_k as limbs, and 2^10-shifted copies
        W = np.zeros((L, n), dtype=np.int32)
        Wh = np.zeros((L, n), dtype=np.int32)
        acc = 1
        for j in range(L):
            W[j] = int_to_limbs(acc, n)
            Wh[j] = int_to_limbs(acc << 10, n)
            acc *= primes[j]
        P = self.prime_product
        # mixed-radix digits of floor(P/2): halfP = sum d_j W_j, 0 <= d_j < q_j
        half = P // 2
        digits = np.zeros(L, dtype=np.int64)
        for j in range(L):
            digits[j] = half % primes[j]
            half //= primes[j]
        assert half == 0
        return dict(
            invq=invq,
            W=W, Wh=Wh,
            P_limbs=int_to_limbs(P, n),
            halfP_digits=digits,
        )

    def _fast_crt_for(self, num_value_primes: int) -> dict:
        """Single-pass CRT reconstruction tables (Shenoy-Kumaresan) over
        the basis primes[:num_value_primes] plus the shared redundant
        modulus (the LAST chain prime).

        Reconstruction for basis product P:
            c_l = res_l * (P/q_l)^{-1} mod q_l
            S   = sum_l c_l * (P/q_l)          (limb domain, mod 2^16n)
            w   = (S - E) / P  = ((S mod m_r) - E_r) * P^{-1} mod m_r
            E   = S - w*P                      (exact, centered, signed)
        w is exact because 0 <= w <= L < m_r (requires |E| < P/2; S < L*P).

        Rows = value primes then the redundant row LAST, padded with zeros
        at the redundant index plus a one-hot ``er_mask``, so
        ops/crt.crt_partials is uniform per prime row and the axis shards
        over a 'limb' mesh axis (parallel/shard.py)."""
        L = num_value_primes
        L_all = L + 1
        qs = [int(q) for q in self.primes[:L]]
        mr = int(self.primes[self.num_primes - 1])
        P = math.prod(qs)
        # Per-basis reconstruction width: covers S = sum c_l*B_l < L*P
        # (the mr factor gives > L headroom), the w*P subtraction, and the
        # *2p + q decrypt-rounding headroom (same budget shape as n_limbs,
        # which this reproduces exactly for the full basis).
        n = ((P * mr).bit_length() + self._round_headroom) // LIMB_BITS + 2
        binv = np.zeros(L_all, dtype=np.int64)
        Bmodr = np.zeros(L_all, dtype=np.int64)
        B = np.zeros((L_all, n), dtype=np.int32)
        Bh = np.zeros((L_all, n), dtype=np.int32)
        er_mask = np.zeros(L_all, dtype=np.int64)
        er_mask[L] = 1
        for l, q in enumerate(qs):
            Bl = P // q
            binv[l] = numbth.modinv(Bl % q, q)
            Bmodr[l] = Bl % mr
            B[l] = int_to_limbs(Bl, n)
            Bh[l] = int_to_limbs(Bl << 10, n)
        return dict(
            binv=binv, Bmodr=Bmodr, B=B, Bh=Bh, er_mask=er_mask,
            P_limbs=int_to_limbs(P, n),
            P_limbs_sh10=int_to_limbs(P << 10, n),
            mr=mr, Pinv_r=numbth.modinv(P % mr, mr),
            n_rec=n,
        )

    @cached_property
    def fast_crt_tables(self) -> dict:
        """Full-basis single-pass CRT tables (value primes = all but the
        redundant last chain prime)."""
        return self._fast_crt_for(self.num_primes - 1)

    # ----------------------------------------------- exact reduction growth
    @cached_property
    def reduction_growth(self) -> dict:
        """Exact worst-case coefficient-growth factors of reduction
        mod Phi_m over Z — the quantities every subset-basis bound below
        is derived from (they replace round-2's '8*phim*xi with a factor
        4 of headroom' heuristic allowances).

        Let rowZ(k) = integer coefficients of X^k mod Phi_m (computed
        iteratively like ntt_tables' reduction matrix, but over Z; note
        X^m = 1 mod Phi_m, so rowZ is m-periodic and rowZ(k) for k < phim
        is the monomial itself).

          G  = 1 + max_c sum_{k=phim}^{2*phim-2} |rowZ(k)[c]|
               For ANY integer polynomial A of degree <= 2*phim-2 with
               |A[i]| <= B (every polynomial product of two degree<phim
               operands, after summing part pairs):
                   |(A mod Phi_m)[c]| <= B * G.
          H  = max_{k < m} max_c |rowZ(k)[c]|
               Per-monomial growth: for the automorphism x(X) -> x(X^g),
               |(x(X^g) mod Phi_m)[c]| <= (sum_i |x_i|) * H
               <= phim * max|x_i| * H.
          RM = max_{k < m} sum_c |rowZ(k)[c]|
               Mass growth (used for secret-key powers: mass(a*b mod Phi)
               <= mass(a)*mass(b)*RM).

        For the cyclotomics this library ships (m prime, m = 2*prime,
        power-of-two m) every rowZ coefficient is in {-1, 0, 1} and
        G <= 3 — but the values are COMPUTED per context, not assumed.
        """
        m, phim = self.m, self.phim
        if m & (m - 1) == 0 and m >= 4:
            # m = 2^k: Phi_m = X^phim + 1, rowZ(phim + r) = -X^r.  Each
            # k in [phim, 2*phim-2] contributes exactly one |-1| to
            # column k-phim (G = 2); every row is a signed monomial
            # (H = RM = 1).  The generic sweep below computes the same
            # values — this is the O(1) shortcut for phim up to 2^15.
            return dict(G=2, H=1, RM=1)
        odd = m
        while odd % 2 == 0 and odd:
            odd //= 2
        if (m % 2 == 0 and odd > 1 and len(set(numbth.factorize(odd))) == 1
                and phim > 512):
            # m = 2^a * q^b (q odd prime), large ring: closed form.  With
            # s = m/(2q), Phi_m(X) = sum_{i<q} (-1)^i X^(i*s)
            # (Phi_m = Phi_2q(X^(m/2q))), so
            #   k in [phim, m/2):  X^k = sum_{i<q-1} (-1)^(i+1) X^(i*s+r)
            #       (r = k - phim < s) — q-1 entries, each +-1;
            #   k in [m/2, m):     X^k = -X^(k-m/2), recursively a signed
            #       monomial or the negated fold — entries +-1, mass q-1.
            # Column sums over k in [phim, 2*phim-2]: each column gets
            # exactly 1 from the fold rows (the unique row with matching
            # r = c mod s) and at most 1 from the monomial rows
            # k = m/2 + c, so G = 1 + 2 = 3 whenever both kinds land in
            # range ((q-2)*s >= 2 — always at this size).  H = 1 (every
            # row is +-1-sparse); RM = q-1 (the fold mass).  Verified
            # against the generic sweep at small m in
            # tests/test_context.py::test_reduction_growth_closed_form.
            q_odd = min(set(numbth.factorize(odd)))
            assert (q_odd - 2) * (m // (2 * q_odd)) >= 2
            return dict(G=3, H=1, RM=q_odd - 1)
        if m == phim + 1:          # m prime: X^phim = -(1+X+...+X^(phim-1))
            # closed form avoids the dense row sweep; rowZ(k<phim) = X^k
            colsum = np.ones(phim, dtype=np.int64)       # the X^phim row
            # rows k in [m, 2*phim-1) are monomials X^(k-m), adding 1 each
            for k in range(m, 2 * phim - 1):
                colsum[k - m] += 1
            return dict(G=1 + int(colsum.max()), H=1, RM=phim)
        n_rows = m - phim
        rows = np.zeros((n_rows, phim), dtype=np.int64)
        cur = np.array([-int(c) for c in self.phim_x[:phim]], dtype=np.int64)
        rows[0] = cur
        for r in range(1, n_rows):
            top = cur[phim - 1]
            cur = np.roll(cur, 1)
            cur[0] = 0
            cur = cur + top * rows[0]
            assert np.abs(cur).max() < (1 << 40), \
                "reduction rows grew beyond the int64 safety margin"
            rows[r] = cur
        colsum = np.zeros(phim, dtype=np.int64)
        for k in range(phim, 2 * phim - 1):
            kk = k % m
            if kk < phim:
                colsum[kk] += 1
            else:
                colsum += np.abs(rows[kk - phim])
        G = 1 + int(colsum.max())
        H = max(1, int(np.abs(rows).max()))
        RM = max(1, int(np.abs(rows).sum(axis=1).max()))
        return dict(G=G, H=H, RM=RM)

    @cached_property
    def exact_bounds(self) -> dict:
        """Derived worst-case |coefficient| bounds for every exact-integer
        reconstruction site (full derivation: docs/ARCHITECTURE.md).
        All bounds assume the library-wide invariant that persistent
        n_limbs_ct-width ciphertext parts hold reduce_signed
        representatives in [-q/2, q/2) — every internal producer emits
        exactly that, and decrypt re-reduces wider inputs first.

          ksw:  V = sum_{k<K} M_k(X) * D_k(X) mod Phi_m with K <=
                MAX_KSW_PARTS * ndigits rows, |M| <= q/2 (reduce_signed
                matrix rows), D in [0, 2^digit_bits)  (FHE-SI.cpp:241-260)
          enc:  pk_i*r + p*e_i: r binary (mass <= phim), |pk| <= q/2,
                |e| <= B_e, the error poly has degree < phim (no
                reduction)  (FHE-SI.cpp:10-36)
          dec:  ct_0 + ct_1*s: s ternary with HWt 64 (mass 64)
                (FHE-SI.cpp:93-119)
          auto: x(X^k) mod Phi_m of an n_ct-width part  (DoubleCRT.cpp:439-465)
          mulc: x * const mod Phi_m, const coeffs < p  (Ciphertext.cpp:233-262)
          tens: one tensor product sum_{i+j=c} (p*a_i)*b_j, 2x2 parts
                (<= 2 pairs per output part)  (Ciphertext.cpp:167-192)
          auto_wide / mulc_wide: the same ops applied to an UNREDUCED
                automorph output (value bound 2x the auto bound, covering
                interleaved constant adds) — these route to the full
                chain, asserted in _check_chain_budget.
        """
        g = self.reduction_growth
        G, H = g['G'], g['H']
        q_half = self.q // 2
        B_e = GAUSS_BOUND_FACTOR * self.stdev + 1
        B_e = int(B_e) + 1
        ksw = (MAX_KSW_PARTS * self.ndigits * self.phim * q_half
               * ((1 << self.digit_bits) - 1) * G)
        enc = self.phim * q_half * G + self.p * B_e
        dec = q_half * (1 + 64 * G)
        auto = self.phim * q_half * H
        mulc = self.phim * q_half * (self.p - 1) * G
        tens = 2 * self.phim * self.p * q_half * q_half * G
        wide = 2 * auto                      # unreduced automorph output
        return dict(ksw=ksw, enc=enc, dec=dec, auto=auto, mulc=mulc,
                    tens=tens,
                    auto_wide=self.phim * wide * H,
                    mulc_wide=self.phim * wide * (self.p - 1) * G,
                    B_e=B_e,
                    # decrypt-tail quotient bound: |round(d*p/q)| <=
                    # p*(1+64G)/2 + 2 with |d| <= dec (limbs.mod_p_bounded)
                    K_dec=(1 + 64 * G) // 2 + 3)

    def _subset_size_for(self, bound: int) -> int:
        """Leading value primes whose product exceeds 2*bound (centered
        CRT representatives need P > 2*|V|max)."""
        need = 2 * bound
        prod, k = 1, 0
        for q in self.primes[:self.num_primes - 1]:
            if prod > need:
                break
            prod *= int(q)
            k += 1
        if prod <= need:
            raise ValueError(
                f"prime chain too short for derived bound {bound:.3g} "
                "(chain provisioning bug)")
        return k

    def _check_chain_budget(self):
        """Assert the full chain covers every derived full-chain bound
        (the reference's SetUpSIContext provisioning, FHEContext.cpp:83-85,
        always does at realistic parameters — but now it is CHECKED, not
        assumed).  xi is the reference's additive-workload headroom
        (max(nBlocks, dim), Test_Regression.cpp:105): up to xi tensored
        ciphertexts may be accumulated before a ScaleDown."""
        b = self.exact_bounds
        need = 2 * max(b['tens'] * max(self.xi, 1),
                       b['auto_wide'], b['mulc_wide'])
        if self.crt_product <= need:
            raise ValueError(
                "prime chain product does not cover the derived "
                f"worst-case bound ({need:.3g}); increase xi/logQ headroom")

    # ------------------------------------------------- keyswitch prime subset
    @cached_property
    def ksw_value_primes(self) -> int:
        """Number of leading chain primes needed for the keyswitch digit
        dot product to reconstruct exactly (derived bound exact_bounds
        ['ksw']; the part cap MAX_KSW_PARTS is enforced at KeySwitch
        build/apply) — usually far fewer than the tensor-product chain."""
        return self._subset_size_for(self.exact_bounds['ksw'])

    @cached_property
    def ksw_rows(self) -> np.ndarray:
        """Chain-row indices of the keyswitch subset basis: the leading
        value primes plus the shared redundant modulus (last row)."""
        return np.concatenate([np.arange(self.ksw_value_primes),
                               [self.num_primes - 1]]).astype(np.int64)

    @cached_property
    def ksw_fast_crt_tables(self) -> dict:
        """Subset-basis CRT tables for the keyswitch dot reconstruction."""
        return self._fast_crt_for(self.ksw_value_primes)

    # ---------------------------------------------------- linear prime subset
    @cached_property
    def lin_value_primes(self) -> int:
        """Leading chain primes needed by the 'linear' scheme ops — the
        ones that lift n_ct-width (reduce_signed) parts, take ONE product
        against a small-mass operand, and immediately reconstruct:
        encrypt, decrypt, automorph, multiply-by-constant.  The bound is
        the max of the derived per-op bounds (exact_bounds; derivation in
        docs/ARCHITECTURE.md).  WIDE inputs (unreduced automorph outputs)
        do not ride this basis: decrypt re-reduces them (provably
        output-invariant) and automorph/mul_const route them to the full
        chain (budget asserted at build)."""
        b = self.exact_bounds
        return self._subset_size_for(max(b['enc'], b['dec'], b['auto'],
                                         b['mulc']))

    @cached_property
    def lin_rows(self) -> np.ndarray:
        return np.concatenate([np.arange(self.lin_value_primes),
                               [self.num_primes - 1]]).astype(np.int64)

    @cached_property
    def lin_fast_crt_tables(self) -> dict:
        return self._fast_crt_for(self.lin_value_primes)

    @cached_property
    def residue_tables(self) -> dict:
        """Tables for limbs -> per-prime residues (from_poly) and limbs -> mod p.

        4-bit chunk dot products keep every int32 partial sum exact:
        chunk < 16, table entry < 2^20, #chunks = 4*n_limbs.
        """
        n = self.n_limbs
        nchunks = 4 * n
        L = self.num_primes
        tbl = np.zeros((nchunks, L), dtype=np.int64)
        wrap = np.zeros(L, dtype=np.int64)  # 2^(16n) mod q_l, for sign correction
        for l in range(L):
            q = int(self.primes[l])
            for c in range(nchunks):
                tbl[c, l] = pow(2, 4 * c, q)
            wrap[l] = pow(2, LIMB_BITS * n, q)
        ptbl = np.array([pow(2, 4 * c, self.p) for c in range(nchunks)], dtype=np.int64)
        pwrap = np.int64(pow(2, LIMB_BITS * n, self.p))
        return dict(chunk_tbl=tbl, wrap=wrap, p_chunk_tbl=ptbl, p_wrap=pwrap)

    # ------------------------------------------------------------- misc limbs
    @cached_property
    def q_over_p_limbs(self) -> np.ndarray:
        """floor(q/p) as limbs (message scaling, FHE-SI.cpp:31)."""
        return int_to_limbs(self.q // self.p, self.n_limbs)

    def __repr__(self):
        return (f"FheContext(m={self.m}, logQ={self.log_q}, p={self.p}, "
                f"g={self.generator}, phim={self.phim}, L={self.num_primes}, "
                f"n_limbs={self.n_limbs}, lane={self.prime_bits}b"
                f"{', ct' if self.use_ct else ''})")
