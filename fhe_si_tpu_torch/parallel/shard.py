"""Explicit SPMD pipelines over a ('dp', 'limb') or ('dp', 'coeff') mesh
of torch.distributed ranks (parallel/mesh.py).

Counterpart of fhe_si_tpu/parallel/shard.py, which runs the same
pipelines inside jax.shard_map.  One instance per rank: each rank holds
its block of the tables and of the data, and the collectives are written
out as Mesh.psum (dist.all_reduce of int32).  Every output equals the
unsharded DeviceContext's, bit for bit (tests/test_torch_parallel.py).

ShardedPipelines: the CRT prime axis over 'limb', the batch over 'dp'.
  - A rank builds the tables of its own block of chain rows only
    (DeviceContext(ctx, device, rows)): the transforms, the tensor
    product, the digit transform and the keyswitch dot are per prime, so
    on a Cooley-Tukey ring on CUDA the three transform kernels run on the
    rank's rows (ops/ntt_ct_cuda.py; the matmul route,
    ops/ntt_ct_matmul.py, on a split the kernel cannot take), on a dense
    ring ops/ntt.modmatmul; the tensor product and the keyswitch dot run
    the kernels of ops/modular_cuda.py on the rank's rows on every ring.
  - The only collectives: one all-reduce over 'limb' of the three CRT
    partials (ops/crt_cuda.crt_partials) at each reconstruction, the
    ScaleDown and the keyswitch output, then crt_finish with the limb
    tail fused in, replicated (on CUDA both are modes of the
    crt_to_limbs kernel).  The keyswitch runs on the full chain, not the
    subset basis of DeviceContext, as the JAX package's sharded keyswitch
    does: the same exact integers.
  - Nothing crosses 'dp' until the block reduce: one all-reduce of raw
    limb sums.

Coefficient sharding: the phi(m) axis over 'coeff'.  Everything between
the transforms is per coefficient (limbs_to_residues, the tensor
product, the CRT reconstruction with the ScaleDown tail, byte_decomp,
the keyswitch dot), so the lift and the reconstruction run the kernels
of ops/crt_cuda.py, the tensor product and the dot those of
ops/modular_cuda.py, on the rank's block.  Each transform contracts the sharded axis: a rank forms
the plain stage product over its slice of the contraction (ops/ntt_ct.py
_stage, or ops/ntt.modmatmul on the dense family), reduced mod q; one
all-reduce per stage sums the S partials, `% q` makes the canonical
residue, and each rank keeps its output block (all-reduce + slice: gloo
has no reduce-scatter for this).  The JAX package computes these with
XLA einsums, not Pallas, so here they stay plain PyTorch and launch no
kernel.  The partial sums are exact: S residues below q < 2^23 sum below
2^31 for S <= 2^8 (the constructors check S * q_max < 2^31), and a shard
keeps the whole contraction's split of its operands (ntt.needs_split on
the full table; _stage's n_terms).  2 all-reduces per Cooley-Tukey
transform, 1 per dense one; 4 transform sites per mul+relin.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import DeviceContext
from ..ops import crt_cuda, limbs as lb, modular_cuda, ntt, ntt_ct

I32_MAX = (1 << 31) - 1
MAX_BLOCK_REDUCE = 1 << 15   # ciphertexts summed by mul_relin_block_reduce


class ShardedPipelines:
    """mul+relin with the CRT prime axis over mesh axis `limb` and the
    batch over `dp`, for this rank.  ctx.num_primes must divide evenly by
    the 'limb' size (FheContext(num_primes_multiple=...) pads the
    chain).  The tables go to mesh.device."""

    def __init__(self, ctx, mesh, dp: str = "dp", limb: str = "limb"):
        n_limb = mesh.shape[limb]
        if ctx.num_primes % n_limb:
            raise ValueError(
                f"num_primes={ctx.num_primes} does not shard over {limb}="
                f"{n_limb}; build the context with "
                f"num_primes_multiple={n_limb}")
        self.ctx = ctx
        self.mesh = mesh
        self.dp = dp
        self.limb = limb
        rows = ctx.num_primes // n_limb
        i = mesh.index(limb)
        self.local = DeviceContext(ctx, mesh.device,
                                   rows=np.arange(i * rows, (i + 1) * rows))
        self.T = self.local.full

    # ---------------------------------------------------- shard-local pieces
    # The lifts (self.local.from_poly: the wrap constant of the input's
    # width on the rank's primes), the tensor product and the digit
    # transform are the shard context's own.
    def _to_poly_psum(self, evals, kind: str):
        """The inverse transform of this rank's rows (the full chain's CRT
        premultiplier folded in: the rows of its t2i_crt / inv_crt) and
        their CRT partials, one all-reduce over 'limb', the replicated
        crt_finish with the limb tail `kind` (DeviceContext.tail).  acc,
        sig_raw and er are sums of nonnegative terms (masked 16-bit
        products, residues mod m_r, the redundant row), so the
        all-reduced sums are the full chain's, which the unsharded
        reconstruction forms in int32 alike (ops/crt.py bounds)."""
        T, wide = self.T, self.ctx.wide
        acc, sig, er = crt_cuda.crt_partials(self.local._inv_crt_t(T, evals),
                                             T['fast_crt'], wide)
        total = self.mesh.psum(torch.cat([acc, sig[..., None], er[..., None]],
                                         dim=-1), self.limb)
        n = acc.shape[-1]
        return crt_cuda.crt_finish(total[..., :n], total[..., n],
                                   total[..., n + 1], T['fast_crt'], wide,
                                   self.local.tail(kind))

    # ------------------------------------------------------------ public ops
    def batched_mul_relin(self, a, b, matrix_local):
        """a [B, ka, phim, n], b [B, kb, phim, n]: this rank's 'dp' block of
        the batch; matrix_local [2, K, L/n_limb, phim]: its 'limb' block of
        the key-switch matrix (mesh.shard_matrix).  -> [B, 2, phim, n_ct],
        the same on every rank of a 'limb' group.  Wider inputs are lifted
        exactly; outputs are at n_ct."""
        loc = self.local
        parts = self._to_poly_psum(loc._tensor_mul(a, b), "round_down")
        # ByteDecomp digits replicated, their transform on the rank's rows
        acc = modular_cuda.keyswitch_dot(matrix_local, loc._digit_evals(parts),
                                         self.T, self.ctx.wide)
        return self._to_poly_psum(acc, "reduce_signed")

    def mul_relin_block_reduce(self, a, b, matrix_local):
        """The same, summed over the whole batch (the additive block merge
        of Regression.h:102-149): one all-reduce over 'dp' of raw limb
        sums.  -> [2, phim, n_ct] on every rank."""
        out = self.batched_mul_relin(a, b, matrix_local)
        if out.shape[0] * self.mesh.shape[self.dp] >= MAX_BLOCK_REDUCE:
            raise ValueError(f"the block reduce sums fewer than "
                             f"{MAX_BLOCK_REDUCE} ciphertexts")
        # int32-exact: |limb| < 2^16 over fewer than 2^15 ciphertexts
        total = self.mesh.psum(torch.sum(out, dim=0, dtype=torch.int32),
                               self.dp)
        return lb.reduce_mod_q(lb.normalize(total), self.ctx.log_q, False,
                               self.local.q_limbs, out_width=self.ctx.n_limbs_ct)


# -------------------------------------------- coefficient-sharded transforms
def _check_coeff(dev, S: int):
    """The refusals of a coefficient-sharded transform or pipeline with S
    shards (shard.py:373-385 of the JAX package, and the partial-sum
    bound of the module header)."""
    if S * int(dev.ctx.primes.max()) > I32_MAX:
        raise ValueError(f"{S} coeff shards: the sum of their partials mod "
                         "q leaves int32")
    if dev.phim % S:
        raise ValueError(f"phim={dev.phim} does not shard over coeff={S}")
    if dev.use_ct:
        if dev.ct_meta.q_odd != 1:
            raise NotImplementedError(
                "coeff-sharded CT pipeline covers m = 2^k (the "
                "excluded-row drop of mixed-radix m is not block-local); "
                "mixed-radix contexts shard over 'limb' (ShardedPipelines)")
        N1, N2 = dev.ct_meta.N1, dev.ct_meta.N2
        if N1 % S or N2 % S:
            raise ValueError(f"coeff shards {S} must divide both CT factors "
                             f"{N1}x{N2}")


def _stage_psum(tab_loc, y, q, y_max: int, n_terms: int, mesh, axis: str):
    """One Cooley-Tukey stage contracted over this rank's slice: the
    partial product mod q, summed over `axis`, mod q (int64)."""
    part = ntt_ct._stage(tab_loc, y, q, y_max, n_terms).to(torch.int32)
    return mesh.psum(part, axis) % q


def _cols(tab, i: int, n: int):
    """Columns [i*n, (i+1)*n) of the last axis."""
    return tab[..., i * n:(i + 1) * n]


def ct_sharded_fwd_local(T, x_loc, meta, mesh, axis: str = "coeff"):
    """Forward transform of residues [..., L, N/S], this rank's block of
    coefficients c = c1 + N1*c2 (a c2 slice) -> its block of evaluations
    u = j2 + N2*j1 (a j1 slice).  T: the whole chain's tables."""
    S, i = mesh.shape[axis], mesh.index(axis)
    *lead, L, _ = x_loc.shape
    n2 = meta.N2 // S
    q = T['q'].to(torch.int64)[:, None, None]
    y = _stage_psum(_cols(T['t2'], i, n2), x_loc.reshape(*lead, L, n2, meta.N1),
                    q, ntt_ct.Q_MAX, meta.N2, mesh, axis)     # [.., L, j2, c1]
    return _ct_sharded_fwd_tail(T, y, meta, mesh, axis)


def ct_sharded_fwd_digits_local(T, d_loc, meta, digit_bits: int, mesh,
                                axis: str = "coeff"):
    """ct_sharded_fwd_local of prime-independent digits [..., N/S] in
    [0, 2^digit_bits), digit_bits <= 24 -> [..., L, N/S]."""
    S, i = mesh.shape[axis], mesh.index(axis)
    *lead, _ = d_loc.shape
    n2 = meta.N2 // S
    q = T['q'].to(torch.int64)[:, None, None]
    y = _stage_psum(_cols(T['t2'], i, n2), d_loc.reshape(*lead, 1, n2, meta.N1),
                    q, (1 << digit_bits) - 1, meta.N2, mesh, axis)
    return _ct_sharded_fwd_tail(T, y, meta, mesh, axis)


def _ct_sharded_fwd_tail(T, y, meta, mesh, axis):
    """Twiddle (replicated) and stage 2 over this rank's c1 slice."""
    S, i = mesh.shape[axis], mesh.index(axis)
    n1 = meta.N1 // S
    q = T['q'].to(torch.int64)[:, None, None]
    y = _cols(y * T['tw'].transpose(-1, -2) % q, i, n1)     # [.., L, j2, c1_loc]
    X = _stage_psum(_cols(T['t1'], i, n1), y.transpose(-1, -2), q,
                    ntt_ct.Q_MAX, meta.N1, mesh, axis)       # [.., L, j1, j2]
    X = X[..., i * n1:(i + 1) * n1, :]                     # this rank's j1 block
    return X.to(torch.int32).reshape(*X.shape[:-2], n1 * meta.N2)


def ct_sharded_inv_local(T, e_loc, meta, mesh, axis: str = "coeff",
                         t2i_key: str = "t2i"):
    """Inverse of ct_sharded_fwd_local: evaluations [..., L, N/S] (a j1
    slice) -> coefficients [..., L, N/S] (a c2 slice).  t2i_key='t2i_crt'
    folds in the CRT premultiplier."""
    S, i = mesh.shape[axis], mesh.index(axis)
    *lead, L, _ = e_loc.shape
    n1, n2 = meta.N1 // S, meta.N2 // S
    q = T['q'].to(torch.int64)[:, None, None]
    z = _stage_psum(_cols(T['t1i'], i, n1), e_loc.reshape(*lead, L, n1, meta.N2),
                    q, ntt_ct.Q_MAX, meta.N1, mesh, axis)    # [.., L, c1, j2]
    z = _cols(z * T['twi'] % q, i, n2)                      # [.., L, c1, j2_loc]
    x = _stage_psum(_cols(T[t2i_key], i, n2), z.transpose(-1, -2), q,
                    ntt_ct.Q_MAX, meta.N2, mesh, axis)       # [.., L, c2, c1]
    x = x[..., i * n2:(i + 1) * n2, :]                     # this rank's c2 block
    return x.to(torch.int32).reshape(*lead, L, n2 * meta.N1)


def _dense_sharded(tab_loc, x_loc, q, mesh, axis: str):
    """One dense transform contracted over `axis`: tab_loc the columns of
    the operands (ops/ntt.operands of the whole table) that meet this
    rank's block of x."""
    full = mesh.psum(ntt.modmatmul(tab_loc, x_loc, q), axis) % q
    n = full.shape[-1] // mesh.shape[axis]
    return _cols(full, mesh.index(axis), n)


def _dense_cols(dev, key: str, mesh, axis: str) -> tuple:
    n = dev.phim // mesh.shape[axis]
    return tuple(_cols(t, mesh.index(axis), n).contiguous()
                 for t in dev.full[key])


def coeff_sharded_ntt(dev, mesh, forward: bool = True):
    """Dense modular DFT with phi(m) sharded over 'coeff': returns
    fn(x [..., L, phim/S], this rank's block of residues) -> its block of
    the transform (raw inverse when not forward).  dev: the unsharded
    DeviceContext of a dense ring."""
    if dev.use_ct:
        raise ValueError("coeff_sharded_ntt takes a dense ring; a "
                         "Cooley-Tukey ring has ct_coeff_sharded_ntt")
    _check_coeff(dev, mesh.shape["coeff"])
    tab = _dense_cols(dev, "fwd" if forward else "inv", mesh, "coeff")
    return lambda x: _dense_sharded(tab, x, dev.q, mesh, "coeff")


def _ct_int_tables(dev) -> dict:
    """The full chain's integer Cooley-Tukey tables, which the plain
    stage products read: dev.full['ct'] on the kernel route; on the
    matmul route (m = 2^16 among the rings a coefficient mesh takes),
    whose tables are float64 stage operands, rebuilt on the host and put
    on dev's device."""
    if dev.ct_route == "kernel":
        return dev.full['ct']
    ctx = dev.ctx
    _, ct = ntt_ct.ct_tables(ctx.m, ctx.primes, ctx.roots)
    ct = ntt_ct.with_crt_premultiplier(ct, ctx.fast_crt_tables['binv'])
    return {k: torch.as_tensor(v, device=dev.device) for k, v in ct.items()}


def ct_coeff_sharded_ntt(dev, mesh, forward: bool = True):
    """Two-level Cooley-Tukey transform with phi(m) sharded over 'coeff'
    (m = 2^k): returns fn(x [..., L, N/S], this rank's block) -> its
    block of dev.ntt_fwd(x) (or of dev.ntt_inv).  Forward input blocks
    are c2 slices and outputs j1 slices, so S must divide N1 and N2."""
    if not dev.use_ct:
        raise ValueError("ct_coeff_sharded_ntt takes a Cooley-Tukey ring")
    _check_coeff(dev, mesh.shape["coeff"])
    T, meta = _ct_int_tables(dev), dev.ct_meta
    if forward:
        return lambda x: ct_sharded_fwd_local(T, x, meta, mesh)
    return lambda e: ct_sharded_inv_local(T, e, meta, mesh)


class CoeffShardedPipelines:
    """The whole mul+relin pipeline with phi(m) sharded over mesh axis
    `coeff` (SURVEY §2 axis 2, the sequence-parallel analog), for this
    rank; nothing crosses the mesh's 'dp' axis, which splits the batch.  dev: the unsharded DeviceContext on
    this rank's device (every prime's tables; the transforms read the
    columns of the rank's block).  Digits of at most 24 bits, as the JAX
    package's (limbs.byte_decomp)."""

    def __init__(self, dev, mesh, coeff: str = "coeff"):
        _check_coeff(dev, mesh.shape[coeff])
        if dev.digit_bits > ntt_ct.MAX_DIGIT_BITS:
            raise NotImplementedError(
                f"coeff-sharded keyswitch digits above "
                f"2^{ntt_ct.MAX_DIGIT_BITS} (decompSize >= 4)")
        self.dev = dev
        T = dev.full
        if dev.use_ct:
            ct, meta = _ct_int_tables(dev), dev.ct_meta
            self._fwd = lambda x: ct_sharded_fwd_local(ct, x, meta, mesh,
                                                       coeff)
            self._inv_crt = lambda e: ct_sharded_inv_local(
                ct, e, meta, mesh, coeff, t2i_key="t2i_crt")
            self._fwd_digits = lambda d: ct_sharded_fwd_digits_local(
                ct, d, meta, dev.digit_bits, mesh, coeff)
        else:
            fwd = _dense_cols(dev, "fwd", mesh, coeff)
            inv_crt = _dense_cols(dev, "inv_crt", mesh, coeff)
            self._fwd = lambda x: _dense_sharded(fwd, x, T['q'], mesh, coeff)
            self._inv_crt = lambda e: _dense_sharded(inv_crt, e, T['q'],
                                                     mesh, coeff)
            self._fwd_digits = lambda d: self._fwd(d[..., None, :] % T['q'])

    def _from_poly(self, parts, second):
        """[..., ka, phim/S, n] and [..., kb, phim/S, n] limbs -> [...,
        ka + kb, L, phim/S] evaluations, one lift of both."""
        dev, T = self.dev, self.dev.full
        res = crt_cuda.limbs_to_residues(
            parts, T['chunk_tbl'], dev._wrap_const(T['primes_np'],
                                                   parts.shape[-1]),
            T['q'], T['qinv_f'], dev.wide, second)
        return self._fwd(res)

    def _to_poly(self, evals, kind: str):
        """[..., k, L, phim/S] -> [..., k, phim/S, n_ct] limbs with the limb
        tail `kind` (the CRT is per coefficient)."""
        dev = self.dev
        return crt_cuda.crt_to_limbs(self._inv_crt(evals), dev.full['fast_crt'],
                                     dev.wide, dev.tail(kind))

    def batched_mul_relin(self, a, b, matrix_local):
        """a, b [B, k, phim/S, n_ct]: this rank's block (batch over 'dp',
        phim over 'coeff', mesh.shard_batched_parts); matrix_local
        [2, K, L, phim/S] (mesh.shard_matrix).  -> this rank's block of
        the products [B, 2, phim/S, n_ct]."""
        dev, T = self.dev, self.dev.full
        na = a.shape[-3]
        ev = self._from_poly(a, b)
        parts = self._to_poly(dev._tensor_product(
            ev[..., :na, :, :], ev[..., na:, :, :]), "round_down")
        *lead, k, phim_loc, _ = parts.shape
        digs = lb.byte_decomp(parts, dev.log_q, dev.digit_bits, dev.ndigits,
                              dev.q_limbs)                # [..., k, phim/S, nd]
        digs = digs.movedim(-1, -2).reshape(*lead, k * dev.ndigits, phim_loc)
        acc = modular_cuda.keyswitch_dot(matrix_local, self._fwd_digits(digs),
                                         T, dev.wide)
        return self._to_poly(acc, "reduce_signed")
