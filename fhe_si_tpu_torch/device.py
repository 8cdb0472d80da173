"""DeviceContext: the scheme's device pipelines for one FheContext on one
torch.device.

Counterpart of fhe_si_tpu/device.py on both transform families and both
residue lanes (narrow: primes < 2^20; wide: primes < 2^23, wherever the
narrow chain runs out), for any p below 2^30 and any decompSize:
  - power-of-two m, and m = 2^a * q^b past the dense threshold
    (context.CT_PHIM_THRESHOLD, e.g. m = 20480), ride the Cooley-Tukey
    family: the three transforms go through ops/ntt_ct_cuda.py, the
    Hopper kernel for CUDA tensors and the plain versions for CPU
    tensors, phim wide in and out (the pad, drop and fold of a mixed
    radix ring happen inside them);
  - every other ring with phim <= 4096 (m = p - 1 of the reference,
    m = 22, 46, 31, ...) rides the dense family: one phim x phim table
    per prime and direction (FheContext.ntt_tables), run as exact
    float64 matmuls by ops/ntt.modmatmul on either device.
The tables of the JAX DeviceContext live here as torch tensors on
`device`; every function is a plain eager function of tensors (no jit,
no vmap), rank-generic with a native batch axis in front (the JAX
package vmaps its dense batched ops; the tensors are the same).

Pipeline map to the reference (file:line into the dwu4/fhe-si sources):
  from_poly   = Cmodulus::FFT per prime        CModulus.cpp:89-107
  to_poly     = iFFT + CRT                     CModulus.cpp:109-132,
                                               DoubleCRT.cpp:349-398
  encrypt     = FHESIPubKey::Encrypt           FHE-SI.cpp:10-36
  decrypt     = FHESISecKey::Decrypt           FHE-SI.cpp:93-119
  tensor_mul  = Ciphertext::operator*=         Ciphertext.cpp:167-192
  scale_down  = Ciphertext::ScaleDown          Ciphertext.cpp:194-218
  keyswitch   = KeySwitchSI::ApplyKeySwitch    FHE-SI.cpp:241-260
  automorph   = DoubleCRT::automorph           DoubleCRT.cpp:439-465
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .context import MAX_KSW_PARTS, FheContext, int_to_limbs
from .ops import crt, limbs as lb, modular, ntt, ntt_ct, ntt_ct_cuda


class DeviceContext:
    def __init__(self, ctx: FheContext, device):
        self.ctx = ctx
        self.device = torch.device(device)
        self.phim = ctx.phim
        self.L = ctx.num_primes
        self.n = ctx.n_limbs
        self.n_ct = ctx.n_limbs_ct      # persistent ciphertext-part width
        self.log_q = ctx.log_q
        self.digit_bits = ctx.digit_bits
        self.ndigits = ctx.ndigits
        self.p = ctx.p
        self.wide = ctx.wide            # residue lane of every mod_mul/dot
        self.use_ct = ctx.use_ct        # transform family

        rt = ctx.residue_tables
        if self.use_ct:
            self.ct_meta, ct_full = ntt_ct.ct_tables(ctx.m, ctx.primes,
                                                     ctx.roots)
        else:
            self.ct_meta = None
            dense_fwd, dense_inv = ctx.ntt_tables

        def subset_tables(rows, fast_crt_np):
            """Row gather of the full-chain tables onto a basis, with that
            basis' CRT premultiplier folded into its inverse transform
            (t2i_crt, or the dense 'inv_crt').  rows None = the full
            chain."""
            q_np = ctx.primes if rows is None else ctx.primes[rows]
            T = dict(
                rows=None if rows is None else torch.as_tensor(
                    rows, dtype=torch.long, device=self.device),
                q=self._i32(q_np[:, None]),
                qinv_f=self._f32(q_np[:, None]),
                chunk_tbl=self._i32(rt['chunk_tbl'] if rows is None
                                    else rt['chunk_tbl'][:, rows]),
                fast_crt=self._fast_crt(fast_crt_np),
                primes_np=q_np)
            if self.use_ct:
                ct = ct_full if rows is None else {
                    k: v[rows] for k, v in ct_full.items()}
                T['ct'] = self._ct(ntt_ct.with_crt_premultiplier(
                    ct, fast_crt_np['binv']))
            else:
                rows = np.arange(self.L) if rows is None else rows
                T['fwd'] = self._dense(dense_fwd, rows)
                T['inv_crt'] = self._dense(dense_inv, rows,
                                           fast_crt_np['binv'])
            return T

        # Subset bases (context.ksw_value_primes / lin_value_primes): the
        # pipelines whose exact-integer bound is smaller than the tensor
        # product's run over only the rows whose product covers it.
        self.full = subset_tables(None, ctx.fast_crt_tables)
        self.ksw = (subset_tables(ctx.ksw_rows, ctx.ksw_fast_crt_tables)
                    if len(ctx.ksw_rows) < self.L else self.full)
        if np.array_equal(ctx.lin_rows, ctx.ksw_rows):
            self.lin = self.ksw
        elif len(ctx.lin_rows) < self.L:
            self.lin = subset_tables(ctx.lin_rows, ctx.lin_fast_crt_tables)
        else:
            self.lin = self.full
        if not self.use_ct:
            # the raw inverse, for ntt_inv (the CT tables keep raw t2i)
            self.full['inv'] = self._dense(dense_inv, np.arange(self.L))
        self.q = self.full['q']
        self.qinv_f = self.full['qinv_f']
        self.p_mod_q = self._i32((ctx.p % ctx.primes)[:, None])
        self.q_limbs = self._i32(int_to_limbs(ctx.q, ctx.n_limbs))
        self.q_over_p = self._i32(ctx.q_over_p_limbs)
        self.q_over_p_sh10 = self._i32(
            int_to_limbs((ctx.q // ctx.p) << 10, ctx.n_limbs))
        self.q_over_p_sh20 = self._i32(
            int_to_limbs((ctx.q // ctx.p) << 20, ctx.n_limbs))
        self.p_chunk_tbl = self._i32(rt['p_chunk_tbl'])
        self.pinv_f = torch.tensor(np.float32(1.0 / ctx.p), device=self.device)
        self._wraps: dict = {}
        self._perms: dict = {}

    # ------------------------------------------------------------- tables
    def _i32(self, a):
        return torch.as_tensor(np.asarray(a, dtype=np.int32),
                               device=self.device)

    def _ct(self, ct_np: dict) -> dict:
        """Transform tables plus the byte planes and reciprocals that the
        tensor-core kernels read (ntt_ct_cuda.kernel_tables)."""
        ct_np = dict(ct_np, **ntt_ct_cuda.kernel_tables(ct_np))
        return {k: torch.as_tensor(np.ascontiguousarray(v), device=self.device)
                for k, v in ct_np.items()}

    def _dense(self, tab_np, rows, binv=None) -> tuple:
        """The modmatmul operands (ops/ntt.operands) on the device of the
        rows `rows` of a dense table [L, phim, phim], with the basis CRT
        premultiplier binv folded in when given.  Built one prime at a
        time, so the host holds one slab and the device one float64 copy
        of each operand."""
        q_np = self.ctx.primes[rows]
        q_max = int(q_np.max())
        out = None
        for i, r in enumerate(rows):
            slab = tab_np[r:r + 1]
            if binv is not None:
                slab = ntt.with_crt_premultiplier(slab, binv[i:i + 1],
                                                  q_np[i:i + 1])
            ops = ntt.operands(slab, q_max)
            if out is None:
                out = tuple(torch.empty((len(rows),) + op.shape[1:],
                                        dtype=op.dtype, device=self.device)
                            for op in ops)
            for o, op in zip(out, ops):
                o[i] = op[0]
        return out

    def _f32(self, q_np):
        """1/q rounded to float32 by the same numpy expression as the JAX
        package (device.py:202), so the Barrett quotients agree."""
        return torch.as_tensor((1.0 / q_np).astype(np.float32),
                               device=self.device)

    def _fast_crt(self, t):
        return dict(
            binv=self._i32(t['binv']), Bmodr=self._i32(t['Bmodr']),
            B=self._i32(t['B']), Bh=self._i32(t['Bh']),
            er_mask=self._i32(t['er_mask']),
            P_limbs=self._i32(t['P_limbs']),
            P_limbs_sh10=self._i32(t['P_limbs_sh10']),
            mr=self._i32(t['mr']),
            mrinv_f=torch.as_tensor(np.float32(1.0 / t['mr']),
                                    device=self.device),
            Pinv_r=self._i32(t['Pinv_r']))

    def _wrap_const(self, primes_np, n: int):
        """2^(16n) mod q_l for the input limb width n, [rows, 1] int32."""
        key = (primes_np.tobytes(), n)
        if key not in self._wraps:
            self._wraps[key] = self._i32(
                [[pow(2, 16 * n, int(q))] for q in primes_np])
        return self._wraps[key]

    # --------------------------------------------------------- primitives
    def _fwd_t(self, T, x):
        """Forward transform over the rows of basis T, on the context's
        transform family."""
        if self.use_ct:
            return ntt_ct_cuda.ct_fwd(T['ct'], x, self.ct_meta)
        return ntt.modmatmul(T['fwd'], x, T['q'])

    def _inv_crt_t(self, T, x):
        """Inverse transform with the basis binv folded in (feeds the
        single-pass CRT reconstruction with prescaled=True)."""
        if self.use_ct:
            return ntt_ct_cuda.ct_inv(T['ct'], x, self.ct_meta,
                                      t2i_key='t2i_crt')
        return ntt.modmatmul(T['inv_crt'], x, T['q'])

    def ntt_fwd(self, x):
        """Full-chain forward transform of residues [..., L, phim]
        (Cmodulus::FFT)."""
        return self._fwd_t(self.full, x)

    def ntt_inv(self, x):
        """Raw full-chain inverse, no CRT premultiplier (Cmodulus::iFFT)."""
        if self.use_ct:
            return ntt_ct_cuda.ct_inv(self.full['ct'], x, self.ct_meta)
        return ntt.modmatmul(self.full['inv'], x, self.q)

    def _from_poly_sub(self, T, poly_limbs):
        wrap = self._wrap_const(T['primes_np'], poly_limbs.shape[-1])
        res = crt.limbs_to_residues(poly_limbs, T['chunk_tbl'], wrap, T['q'],
                                    T['qinv_f'], self.wide)
        return self._fwd_t(T, res)

    def _to_poly_sub(self, T, evals):
        res = self._inv_crt_t(T, evals)
        return crt.residues_to_limbs_fast(res, T['fast_crt'], T['q'],
                                          T['qinv_f'], prescaled=True,
                                          wide=self.wide)

    @staticmethod
    def _gather_rows(T, evals_full, dim=-2):
        """Full-chain eval tensors (keys, constants) restricted to the
        basis rows."""
        if T['rows'] is None:
            return evals_full
        return torch.index_select(evals_full, dim % evals_full.dim(),
                                  T['rows'])

    def _lin_tables_for_width(self, width: int):
        """Basis of a linear op (automorph, const multiply) on parts of
        the given limb width: n_ct-width parts are reduce_signed
        representatives and ride the lin basis (exact_bounds 'auto' /
        'mulc'); wider parts are unreduced automorph outputs and ride the
        full chain, whose coverage of 'auto_wide' / 'mulc_wide' the
        context checks at build."""
        return self.lin if width <= self.n_ct else self.full

    def from_poly(self, poly_limbs):
        """Limb coefficients [..., phim, n] -> full-chain evaluations
        [..., L, phim] (Cmodulus::FFT after the per-prime reduction)."""
        return self._from_poly_sub(self.full, poly_limbs)

    def to_poly(self, evals):
        """Full-chain evaluations [..., L, phim] -> the centered value as
        limbs [..., phim, n] (DoubleCRT::toPoly)."""
        return self._to_poly_sub(self.full, evals)

    @functools.cached_property
    def garner(self) -> dict:
        """FheContext.garner_tables on the device as int32, the operand of
        ops/crt.residues_to_limbs (the JAX DeviceContext's C['garner'])."""
        return {k: self._i32(v) for k, v in self.ctx.garner_tables.items()}

    def _mul(self, a, b, T=None):
        """mod_mul over the residue rows of basis T (the full chain by
        default) on this context's lane."""
        T = self.full if T is None else T
        return modular.mod_mul(a, b, T['q'], T['qinv_f'], self.wide)

    def small_to_evals(self, coeffs):
        """Small nonnegative coefficients [..., phim] -> evaluations
        [..., L, phim] on the full chain."""
        return self._fwd_t(self.full, coeffs[..., None, :] % self.q)

    def reduce_signed(self, limbs_arr):
        """Signed Reduce mod 2^logQ at the ciphertext width n_ct."""
        return lb.reduce_mod_q(limbs_arr, self.log_q, False, self.q_limbs,
                               out_width=self.n_ct)

    def automorph_perm(self, k: int):
        """ctx.automorph_perm(k) as a long tensor on the device."""
        perm = self._perms.get(k)
        if perm is None:
            perm = self._perms[k] = torch.as_tensor(
                self.ctx.automorph_perm(k), dtype=torch.long,
                device=self.device)
        return perm

    # --------------------------------------------------------- key setup
    def _keygen(self, s, c0, c1_limbs):
        """FHESISecKey/FHESIPubKey::Init (FHE-SI.cpp:42-91): returns
        (sk_evals [2, L, phim], pk_evals [2, L, phim], pk_limbs
        [2, phim, n_ct])."""
        s_evals = self.small_to_evals(s)
        ones = torch.ones((self.L, self.phim), dtype=torch.int32,
                          device=self.device)
        c1_evals = self.from_poly(c1_limbs)
        pk0_pre = modular.mod_add(self._mul(s_evals, c1_evals),
                                  self.small_to_evals(c0), self.q)
        pk0_limbs = self.reduce_signed(self.to_poly(pk0_pre))
        pk1_limbs = self.reduce_signed(lb.neg(c1_limbs))
        pk_limbs = torch.stack([pk0_limbs, pk1_limbs])
        return (torch.stack([ones, s_evals]), self.from_poly(pk_limbs),
                pk_limbs)

    def square_evals(self, evals):
        return self._mul(evals, evals)

    def _keyswitch_init(self, src_sk_evals, dst_t_evals, A_limbs, e):
        """KeySwitchSI::Init (FHE-SI.cpp:153-209): the matrix as
        evaluations [2, k*ndigits, L, phim]."""
        s_limbs = self.to_poly(src_sk_evals)
        s_shift = torch.stack([
            lb.shift_left(s_limbs[i], self.digit_bits * j)
            for i in range(src_sk_evals.shape[0])
            for j in range(self.ndigits)])
        b_ev = self._mul(self.from_poly(A_limbs), dst_t_evals[None])
        b_limbs = self.to_poly(b_ev)
        b_limbs = lb.add(lb.add(b_limbs, lb.from_small_signed(e, self.n)),
                         s_shift)
        row_b = self.reduce_signed(b_limbs)
        row_a = self.reduce_signed(lb.neg(A_limbs))
        return self.from_poly(torch.stack([row_b, row_a]))

    # --------------------------------------------------------- scheme ops
    def _encrypt(self, pk_evals, msg, r, errors):
        """FHESIPubKey::Encrypt over the linear subset basis.
        msg/r [..., phim], errors [..., 2, phim] -> parts [..., 2, phim,
        n_ct]."""
        T = self.lin
        q = T['q']
        pk_sub = self._gather_rows(T, pk_evals)
        r_evals = self._fwd_t(T, r[..., None, :] % q)
        e_evals = self._mul(self._fwd_t(T, errors[..., None, :] % q),
                            self._gather_rows(T, self.p_mod_q), T)
        ct_evals = modular.mod_add(
            self._mul(pk_sub, r_evals[..., None, :, :], T), e_evals, q)
        parts = self._to_poly_sub(T, ct_evals)
        nw = parts.shape[-1]     # lin-basis recon width; q/p << 2^(16*nw)
        scaled = lb.scale_coeffs_by_bigint(msg, self.q_over_p[..., :nw],
                                           self.q_over_p_sh10[..., :nw],
                                           self.q_over_p_sh20[..., :nw])
        p0 = lb.add(parts[..., 0, :, :], scaled)
        parts = torch.cat([p0[..., None, :, :], parts[..., 1:, :, :]], dim=-3)
        return self.reduce_signed(parts)

    def _decrypt(self, parts_limbs, sk_evals):
        """FHESISecKey::Decrypt over the linear subset basis.  parts
        [..., k, phim, n] -> messages [..., phim] mod p.  Parts wider
        than n_ct (unreduced automorph outputs) are reduced first: the
        rounding quotient shifts by exactly t*p under d -> d + t*q."""
        if parts_limbs.shape[-1] > self.n_ct:
            parts_limbs = self.reduce_signed(parts_limbs)
        T = self.lin
        part_evals = self._from_poly_sub(T, parts_limbs)
        prod = self._mul(part_evals, self._gather_rows(T, sk_evals), T)
        acc = prod[..., 0, :, :]
        for i in range(1, prod.shape[-3]):
            acc = modular.mod_add(acc, prod[..., i, :, :], T['q'])
        d = self._to_poly_sub(T, acc)
        nw = d.shape[-1]          # lin recon width; *2p headroom budgeted
        y = lb.mul_small(d, 2 * self.p)
        y = lb.add(y, self.q_limbs[..., :nw].expand(y.shape))
        y = lb.arith_shift_right(y, self.log_q + 1)
        if self.p >= 1 << 20:
            # the chunk-dot sum below would leave int32: reduce the
            # bounded quotient (|y| <= K_dec * p) directly
            return lb.mod_p_bounded(y, self.p, self.ctx.exact_bounds['K_dec'])
        return crt.limbs_to_mod_small(y, self.p_chunk_tbl,
                                      pow(2, 16 * nw, self.p), self.p,
                                      self.pinv_f)

    def _tensor_mul(self, a_parts, b_parts):
        """Ciphertext::operator*= : parts [..., k, phim, n] -> tensored
        evaluations [..., ka+kb-1, L, phim]."""
        na, nb = a_parts.shape[-3], b_parts.shape[-3]
        if a_parts.shape[-1] == b_parts.shape[-1]:
            # one lift for both operands, then scale the a-side by p
            ev = self.from_poly(torch.cat([a_parts, b_parts], dim=-3))
            a_ev = self._mul(ev[..., :na, :, :], self.p_mod_q)
            b_ev = ev[..., na:, :, :]
        else:
            a_ev = self._mul(self.from_poly(a_parts), self.p_mod_q)
            b_ev = self.from_poly(b_parts)
        out = [None] * (na + nb - 1)
        for i in range(na):
            for j in range(nb):
                pr = self._mul(a_ev[..., i, :, :], b_ev[..., j, :, :])
                k = i + j
                out[k] = pr if out[k] is None else modular.mod_add(
                    out[k], pr, self.q)
        return torch.stack(out, dim=-3)

    def _scale_down(self, tprod_evals):
        """Ciphertext::ScaleDown: floor((2x + q) / 2q), reduced signed."""
        x = self.to_poly(tprod_evals)
        y = lb.shift_left(x, 1)
        y = lb.add(y, self.q_limbs.expand(y.shape))
        y = lb.arith_shift_right(y, self.log_q + 1)
        return self.reduce_signed(y)

    def _digit_evals(self, parts_limbs):
        """ByteDecomp digits and their forward transform over the
        keyswitch basis: parts [..., k, phim, n] -> [..., k*nd, Lk, phim].

        Digits of at most 24 bits (decompSize <= 3) are prime-independent:
        on a Cooley-Tukey ring they go into ct_fwd_digits unreduced; on a
        dense ring they are reduced per prime first (a 24-bit digit times
        a table entry would leave float64's exact range).  Wider digits
        (decompSize >= 4) ride 16-bit planes (limbs.byte_decomp_planes)
        and become residues by a Horner over the planes, which then take
        the family's forward transform of residues.  The JAX package
        splits each x2^16 step into int32 shift hops (10 + 6 narrow,
        6 + 6 + 4 wide); here a step is one int64 product below 2^39 and
        a `%`, the same canonical residue."""
        k = parts_limbs.shape[-3]
        if k > MAX_KSW_PARTS:
            raise ValueError(
                f"keyswitching {k} parts exceeds MAX_KSW_PARTS="
                f"{MAX_KSW_PARTS} (context.exact_bounds['ksw'])")
        K = self.ksw
        lead = parts_limbs.shape[:-3]
        rows = k * self.ndigits
        if self.digit_bits <= ntt_ct.MAX_DIGIT_BITS:
            digs = lb.byte_decomp(parts_limbs, self.log_q, self.digit_bits,
                                  self.ndigits, self.q_limbs)
            digs = digs.movedim(-1, -2)               # [..., k, nd, phim]
            digs = digs.reshape(lead + (rows, self.phim))
            if self.use_ct:
                return ntt_ct_cuda.ct_fwd_digits(K['ct'], digs, self.ct_meta,
                                                 self.digit_bits)
            res = digs[..., None, :] % K['q']         # [..., rows, Lk, phim]
        else:
            planes = lb.byte_decomp_planes(parts_limbs, self.log_q,
                                           self.digit_bits, self.ndigits,
                                           self.q_limbs)
            planes = planes.movedim(-2, -3)           # [..., k, nd, phim, pl]
            planes = planes.reshape(lead + (rows, self.phim, planes.shape[-1]))
            q = K['q'].to(torch.int64)
            res = planes[..., None, :, -1] % q        # [..., rows, Lk, phim]
            for t in range(planes.shape[-1] - 2, -1, -1):
                res = ((res << lb.LIMB_BITS) + planes[..., None, :, t]) % q
            res = res.to(torch.int32)
        return self._fwd_t(K, res)

    def _keyswitch_digits(self, matrix_evals, digit_evals):
        """Keyswitch dot + reconstruction over the keyswitch basis.
        matrix_evals [2, K, L, phim] (full chain), digit_evals
        [..., K, Lk, phim] -> parts [..., 2, phim, n_ct]."""
        K = self.ksw
        mat = self._gather_rows(K, matrix_evals)
        acc = modular.mod_dot(mat, digit_evals[..., None, :, :, :],
                              K['q'], K['qinv_f'], axis=-3, wide=self.wide)
        return self.reduce_signed(self._to_poly_sub(K, acc))

    def keyswitch_parts(self, parts, matrix_evals):
        """ApplyKeySwitch of non-tensored parts [..., k, phim, n]."""
        return self._keyswitch_digits(matrix_evals, self._digit_evals(parts))

    def keyswitch_tensored(self, tprod, matrix_evals):
        """ScaleDown + ApplyKeySwitch of tensored evaluations
        [..., k, L, phim]."""
        return self.keyswitch_parts(self._scale_down(tprod), matrix_evals)

    # --------------------------------------------------------- linear ops
    def add(self, a, b):
        """Ciphertext + ciphertext on parts, reduced (Ciphertext.cpp:123-145)."""
        return self.reduce_signed(lb.add(a, b))

    def add_tensored(self, a, b):
        return modular.mod_add(a, b, self.q)

    # part 0 plus the scaled constant floor(c * q / p) as limbs
    # (Ciphertext.cpp:147-161): the same reduced limb add
    add_const = add

    def add_const_tensored(self, tprod0, scaled):
        return modular.mod_add(tprod0, self.from_poly(scaled), self.q)

    def mul_scalar(self, parts, scalar_abs, negate):
        """Multiply by a long (Ciphertext.cpp:220-231), reduced signed.
        parts [..., k, phim, n]; scalar_abs (int32, < 2^30) and negate
        (bool) have the lead shape [...]: one scalar per ciphertext."""
        scalar_abs = torch.as_tensor(scalar_abs, dtype=torch.int32,
                                     device=parts.device)
        negate = torch.as_tensor(negate, device=parts.device)
        # [...] -> [..., 1, 1] so each scalar meets its own ciphertext
        prod = lb.mul_small(parts, scalar_abs[..., None, None])
        prod = torch.where(negate[..., None, None, None], lb.neg(prod), prod)
        return self.reduce_signed(prod)

    def mul_scalar_tensored(self, evals, s_mod):
        """Tensored evaluations times a scalar given mod each prime
        (s_mod [L, 1])."""
        return self._mul(evals, s_mod)

    def mul_const(self, parts, const_evals):
        """Multiply by a plaintext constant (coefficients < p) given as
        full-chain evaluations; exact_bounds 'mulc' / 'mulc_wide'."""
        T = self._lin_tables_for_width(parts.shape[-1])
        ev = self._from_poly_sub(T, parts)
        ev = self._mul(ev, self._gather_rows(T, const_evals)[None], T)
        return self.reduce_signed(self._to_poly_sub(T, ev))

    def mul_const_tensored(self, evals, const_evals):
        return self._mul(evals, const_evals[None])

    def signed_group_sum_tensored(self, tens, s_mod):
        """sum_t s_t * tens_t within uniform groups of tensored
        evaluations: tens [G, k, parts, L, phim], s_mod [G, k, 1, L, 1]
        with s in {1, q-1} encoding +-1 (Matrix.cpp:224-263, batched)."""
        prod = self._mul(tens, s_mod)
        acc = prod[:, 0]
        for t in range(1, prod.shape[1]):
            acc = modular.mod_add(acc, prod[:, t], self.q)
        return acc

    # ------------------------------------------------ automorph, rotation
    def automorph(self, parts, perm):
        """X -> X^k on parts [..., k, phim, n] (DoubleCRT.cpp:439-465):
        lift, gather the evaluations by ctx.automorph_perm(k), back.  The
        result is exact and not reduced (Ciphertext.cpp:54-59): it comes
        back at the basis' reconstruction width."""
        T = self._lin_tables_for_width(parts.shape[-1])
        ev = torch.index_select(self._from_poly_sub(T, parts), -1, perm)
        return self._to_poly_sub(T, ev)

    @staticmethod
    def automorph_tensored(evals, perm):
        """X -> X^k on evaluations [..., L, phim]: a gather in zms order."""
        return torch.index_select(evals, -1, perm)

    def rotate_reduce_stage(self, parts, perm, matrix_evals):
        """One rotate-and-reduce step of SumBatchedData over a batch:
        parts + keyswitch(automorph(parts)), reduced signed."""
        switched = self.keyswitch_parts(self.automorph(parts, perm),
                                        matrix_evals)
        return self.reduce_signed(lb.add(parts, switched))

    # ------------------------------------------------------ batched path
    def mul_relin(self, a_parts, b_parts, matrix_evals):
        """Homomorphic multiply + relinearize (Ciphertext.cpp:167-218,
        FHE-SI.cpp:241-260), rank-generic: a/b [..., 2, phim, n_ct] ->
        [..., 2, phim, n_ct]."""
        return self.keyswitch_tensored(self._tensor_mul(a_parts, b_parts),
                                       matrix_evals)
