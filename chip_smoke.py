#!/usr/bin/env python3
"""Smoke run of the PyTorch port (fhe_si_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (any failure exits nonzero and
prints no result line):
  1. device check: refuses to run without CUDA; prints the card's name
     and power limit as nvidia-smi reports them;
  2. build: compiles the CUDA kernels from fhe_si_tpu_torch/csrc and
     prints ptxas's report for each kernel (registers, shared memory,
     spills);
  3. each kernel against its plain PyTorch version on the card, at the
     narrow tables of m = 8192, 256 and 32 and the wide (23-bit prime)
     tables of the regression context (m = 8192, logQ 213) and of
     m = 256 and 32, on the full chain and both subset bases, and on
     tables of a narrow and a wide prime at m = 2^14 and 2^15, with a
     ragged row count, a [2, 3] lead shape, the forward/inverse round
     trip and both inverse tables, bit for bit; the same on mixed-radix
     tables (m = 2^a * q^b: the kernel on the N-point transform, the
     wrappers' pad, drop, insert and fold around it) at m = 40, 96, 160,
     18 and 54 on narrow primes (odd N1 among them), m = 13122 (81 x 81)
     on one narrow prime and m = 20480 (128 x 80) on a narrow and a
     23-bit prime; plus the int32 semantics the port relies on
     (wraparound, round half to even, arithmetic >>);
  4. the main path at FheContext(m=8192, log_q=80, p=40961, g=3):
     keygen, relinearization key, batched encrypt of 64 pairs, batched
     multiply + relinearize, batched decrypt; every decrypt must equal
     the plaintext product, and every kernel must have launched.  At
     m = 256 the ciphertext parts must also equal hostmath/oracle.py;
  4b. the same path at the JAX package's m = 2^15 config,
     FheContext(m=32768, log_q=170, p=65537, g=3) (wide lane), on 4
     pairs; prints its wall time;
  5. timing with CUDA events: mul+relin at batch 64 and each kernel
     against its plain version and its bound (the larger of its int32
     bytes over the HBM rate and its int8 byte products over the int8
     tensor-core rate) at the main path's shapes, at the regression
     app's wide shapes and at the m = 2^15 path's shapes (with 4 pairs:
     its mul+relin step too); at the main path's and the m = 2^15 path's
     shapes also with its launches per mul+relin step;
  6. the applications: the port's Test_Regression and Test_Statistics
     CLIs at m = 8192, p = 40961, g = 3 on a d = 4, n = 256 dataset made
     from the seed (both on the wide lane); each must print MATCH and
     launch every kernel.  Prints each app's phase times, L, lane and
     peak device memory;
  7. the reference's own rings (m = p - 1), which ride the dense
     transform family (float64 matmuls, no Cooley-Tukey kernel), each
     part with its wall time:
     a. the dense transforms on the card against the same function on
        the CPU, bit for bit: forward, raw inverse and prescaled inverse
        on the full chain and both subset bases, at p = 4007, logQ 170
        (narrow) and p = 2027, logQ 120 with 23-bit primes (wide: the
        12-bit table split);
     b. mul+relin at the JAX package's bench_big config (p = 4007,
        m = 4006, logQ 170, g = 5), batch 64: every decrypt must equal
        oracle.plaintext_mul; the step and its four stages timed with
        CUDA events, the dense transform at the path's shapes against its
        bound, and its calls per step;
     c. Test_Regression and Test_Statistics at p = 4007, g = 5, m = 4006
        (logQ as derive_log_q gives it) on the d = 4, n = 256 dataset:
        both must print MATCH;
     d. Test_General at its defaults (p = 2027, g = 3, logQ 120) and
        Test_AddMul 170 4007 5 --trials 10: both must exit 0;
     e. decompSize 4 at m = 8192, logQ 80, batch 8: decrypts right, the
        32-bit digits through the ct_fwd kernel;
     f. a 24-bit p with 4006 | p - 1 at m = 4006 (the large-p decrypt
        tail), 4 pairs;
  8. the mixed-radix family at full width: keygen, relinearization key,
     encrypt, mul+relin and decrypt of 16 pairs at the JAX package's
     FheContext(m=20480, log_q=80, p=40961, generator=3) (phim 8192,
     N1 x N2 = 128 x 80, bench.py's ct20k_mixedradix); every decrypt must
     equal oracle.plaintext_mul, all three kernels must launch and no
     plain transform run; the step and its four stages timed with CUDA
     events, each kernel at the path's shapes against its bound and its
     plain version;
  9. the object API and the serializers on the card: DoubleCrt round
     trip, arithmetic, automorph against the oracle and
     scale_down_to_set at p = 4007, m = 4006 (dense, phim 2002); an npz
     export/import of context, keys and ciphertexts from the m = 8192
     DeviceContext, decrypted right after import; the reference byte
     format (refcompat) round trip of keys and ciphertexts at m = 22 on a
     synthetic reference chain.
Every phase prints its wall time.  The line before the last is the card's name and power limit; the last
is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 2024
RAGGED_ROWS = 37           # no block size divides it
BATCH = 64                 # ciphertext pairs per mul+relin step
MAIN = dict(m=8192, log_q=80, p=40961, generator=3)
M15 = dict(m=32768, log_q=170, p=65537, generator=3)   # wide lane, L = 19
BATCH15 = 4
# a narrow and a wide prime, both 1 mod 2^15: 3 * 2^18 + 1, 63 * 2^17 + 1
BIG_PRIMES = [786433, 8257537]
SMALL = [dict(m=256, log_q=80, p=257, generator=3),
         dict(m=32, log_q=80, p=97, generator=3)]
APP = dict(p=40961, generator=3, m=8192, dim=4, n=256)
# the reference's own rings, m = p - 1 (dense transform family)
BIG = dict(m=4006, log_q=170, p=4007, generator=5)     # bench.py bench_big
GENERAL = dict(p=2027, generator=3, log_q=120)         # Test_General defaults
# Test_General's ring on 23-bit primes: the wide lane's 12-bit table split
DENSE_WIDE = dict(GENERAL, m=2026, prime_bits=23)
APP_REF = dict(p=4007, generator=5, m=None, dim=4, n=256)
DECOMP4 = dict(MAIN, decomp_size=4)
BATCH_DECOMP4 = 8
LARGE_P = dict(m=4006, log_q=120, generator=5, bits=24)
BATCH_LARGE_P = 4
# the mixed-radix family: bench.py's ct20k_mixedradix ring, 128 x 80
MIXED = dict(m=20480, log_q=80, p=40961, generator=3)
BATCH_MIXED = 16
# mixed-radix tables of phase 3: (m, narrow primes, 23-bit primes)
MIXED_TABLES = [(40, 2, 0), (96, 2, 0), (160, 2, 0), (18, 2, 0), (54, 2, 0),
                (13122, 1, 0), (20480, 1, 1)]
REF_CANONICAL = dict(m=22, log_q=80, p=23, generator=7)
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 peak bandwidth
INT8_OPS_PER_S = 1979e12        # dense int8 tensor-core rate, H100 SXM
F64_OPS_PER_S = 67e12           # FP64 tensor-core rate, H100 SXM
PALLAS = "fhe_si_tpu/ops/ntt_ct_pallas.py"
KERNELS = {   # wrapper -> Pallas kernel body it replaces
    "ct_fwd": f"{PALLAS}:148",
    "ct_fwd_digits": f"{PALLAS}:137",
    "ct_inv": f"{PALLAS}:158",
}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def cuda_ms(fn, iters: int) -> float:
    import torch
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def kernel_bound(name: str, rows: int, L: int, meta) -> tuple[float, str]:
    """Least time (ms) the card could take for one call and what sets it:
    the int32 input and output (phim wide) moved once each over the HBM
    rate, or the multiply-adds of both stages of the N-point transform
    (N * (N1 + N2) per row and prime) as 9 int8 byte products of 2
    operations each over the int8 rate."""
    n_in = rows * meta.phim if name == "ct_fwd_digits" \
        else rows * L * meta.phim
    t_bytes = 4 * (n_in + rows * L * meta.phim) / HBM_BYTES_PER_S * 1e3
    t_ops = (2 * 9 * rows * L * meta.N * (meta.N1 + meta.N2)
             / INT8_OPS_PER_S * 1e3)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ptxas_report(log: str) -> list[str]:
    """ptxas -v lines per kernel: name, registers, spills, shared memory."""
    out, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and ("registers" in line or "spill" in line):
            out.append(f"{name}: {line.split('info    :')[-1].strip()}")
    return out


def probe_semantics(dev):
    """The int32/float32 behaviour the JAX package relies on, on CUDA."""
    import torch
    from fhe_si_tpu_torch.ops import modular
    i32 = torch.int32
    big = torch.tensor([2 ** 30 + 5, -(2 ** 30) - 7], dtype=i32, device=dev)
    want = (np.array([2 ** 30 + 5, -(2 ** 30) - 7], np.int64) * 4
            + 2 ** 31) % 2 ** 32 - 2 ** 31
    if not np.array_equal((big * 4).cpu().numpy(), want):
        raise AssertionError("int32 multiply does not wrap mod 2^32 on CUDA")
    half = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5], device=dev)
    if torch.round(half).cpu().tolist() != [0.0, 2.0, 2.0, -0.0, -2.0]:
        raise AssertionError("torch.round is not half-to-even on CUDA")
    neg = torch.tensor([-5, -(3 << 16) - 1], dtype=i32, device=dev)
    if (neg >> 16).cpu().tolist() != [-1, -4]:
        raise AssertionError(">> on negative int32 is not arithmetic on CUDA")
    if torch.sum(neg, dtype=i32).dtype != i32:
        raise AssertionError("sum(dtype=int32) did not keep int32")
    rng = np.random.default_rng(SEED)
    q_np = np.array([1032193, 786433, 40961], dtype=np.int64)
    t_np = rng.integers(-2 ** 31, 2 ** 31, size=(3, 4096))
    q = torch.as_tensor(q_np[:, None].astype(np.int32), device=dev)
    qi = torch.as_tensor((1.0 / q_np[:, None]).astype(np.float32), device=dev)
    r = modular.barrett(torch.as_tensor(t_np.astype(np.int32), device=dev),
                        q, qi).cpu().numpy()
    if not np.array_equal(r, t_np % q_np[:, None]):
        raise AssertionError("barrett on CUDA disagrees with exact t mod q")


def app_contexts():
    """FheContext arguments of the two apps at APP, logQ and xi derived as
    the reference's Test_Regression / Test_Statistics derive them."""
    from fhe_si_tpu_torch.apps import regression, statistics
    out = {}
    for name, mod in (("regression", regression), ("statistics", statistics)):
        log_q, xi = mod.derive_log_q(APP["n"], APP["dim"], APP["p"])
        out[name] = dict(m=APP["m"], log_q=log_q, p=APP["p"],
                         generator=APP["generator"], xi=xi)
    return out


def phase_kernels(dev):
    """Each kernel against its plain version on the card, bit for bit, on
    the narrow and the wide tables."""
    import torch
    from fhe_si_tpu_torch import DeviceContext, FheContext
    from fhe_si_tpu_torch.hostmath import numbth
    from fhe_si_tpu_torch.ops import ntt_ct, ntt_ct_cuda
    err = dict.fromkeys(KERNELS, 0)
    rng = np.random.default_rng(SEED)

    def check(name, got, want):
        d = (got.to(torch.int64) - want.to(torch.int64)).abs().max().item()
        err[name] = max(err[name], d)
        if d:
            raise AssertionError(f"{name}: kernel differs from plain by {d}")

    def check_tables(tab, q_np, meta, label, t2i_keys=("t2i", "t2i_crt")):
        L, N = len(q_np), meta.phim
        for lead in ((RAGGED_ROWS,), (2, 3)):
            x = torch.as_tensor(
                rng.integers(0, q_np[:, None], size=lead + (L, N)).astype(
                    np.int32), device=dev)
            ev = ntt_ct_cuda.ct_fwd(tab, x, meta)
            check("ct_fwd", ev, ntt_ct.ct_fwd(tab, x, meta))
            for key in t2i_keys:
                check("ct_inv", ntt_ct_cuda.ct_inv(tab, ev, meta, key),
                      ntt_ct.ct_inv(tab, ev, meta, key))
            back = ntt_ct_cuda.ct_inv(tab, ev, meta)
            if not torch.equal(back, x):
                raise AssertionError(f"ct_inv(ct_fwd(x)) != x at {label}")
            digs = torch.as_tensor(
                rng.integers(0, 1 << 24, size=lead + (N,)).astype(np.int32),
                device=dev)
            check("ct_fwd_digits",
                  ntt_ct_cuda.ct_fwd_digits(tab, digs, meta, 24),
                  ntt_ct.ct_fwd_digits(tab, digs, meta, 24))
        print(f"kernels == plain: {label} N1xN2={meta.N1}x{meta.N2} "
              f"phim={meta.phim} L={L}")

    wide = [app_contexts()["regression"]] + [
        dict(cfg, prime_bits=23) for cfg in SMALL]
    for cfg, want_wide in ([(c, False) for c in [MAIN] + SMALL]
                           + [(c, True) for c in wide]):
        ctx = FheContext(**cfg)
        if ctx.wide != want_wide:
            raise AssertionError(f"{cfg}: wide lane is {ctx.wide}")
        dc = DeviceContext(ctx, dev)
        for basis, T in (("full", dc.full), ("ksw", dc.ksw), ("lin", dc.lin)):
            check_tables(T['ct'], T['primes_np'], dc.ct_meta,
                         f"m={cfg['m']} logQ={cfg['log_q']} "
                         f"{'wide' if ctx.wide else 'narrow'} basis={basis}")
    # the largest rings, on tables of one narrow and one wide prime
    # (m = 2^15: the twiddle read from global memory, 16 tiles per warp)
    for m in (1 << 14, 1 << 15):
        meta, ct = ntt_ct.ct_tables(
            m, BIG_PRIMES, [numbth.find_element_of_order(q, m)
                            for q in BIG_PRIMES])
        tab = {k: torch.as_tensor(v, device=dev) for k, v in
               dict(ct, **ntt_ct_cuda.kernel_tables(ct)).items()}
        check_tables(tab, np.asarray(BIG_PRIMES, np.int64), meta,
                     f"m={m} primes={BIG_PRIMES}", t2i_keys=("t2i",))
    # mixed-radix tables, with a CRT premultiplier folded into t2i_crt
    for m, narrow, wide in MIXED_TABLES:
        qs = primes_below(m, 1 << 20, narrow) + primes_below(m, 1 << 23, wide)
        meta, ct = ntt_ct.ct_tables(
            m, qs, [numbth.find_element_of_order(q, m) for q in qs])
        ct = ntt_ct.with_crt_premultiplier(
            ct, rng.integers(1, min(qs), size=len(qs)))
        tab = {k: torch.as_tensor(v, device=dev) for k, v in
               dict(ct, **ntt_ct_cuda.kernel_tables(ct)).items()}
        check_tables(tab, np.asarray(qs, np.int64), meta,
                     f"m={m} primes={qs}")
    torch.cuda.synchronize()
    return err


def primes_below(m: int, bound: int, count: int) -> list[int]:
    """The largest `count` primes q < bound with m | q - 1 (at least
    2^20 when bound is 2^23: primes of the wide lane)."""
    from fhe_si_tpu_torch.hostmath import numbth
    out, t = [], (bound - 1) // m
    while len(out) < count:
        q = t * m + 1
        if q < bound >> 3 and bound > 1 << 20:
            raise ValueError(f"no 23-bit prime with {m} | q - 1")
        if numbth.is_prime(q):
            out.append(q)
        t -= 1
    return out


def encrypt_pairs(scheme, ctx, pk, src, count):
    msgs = [src.uniform_mod_p(ctx.phim, ctx.p) for _ in range(2 * count)]
    cts = pk.encrypt_batch([scheme.Plaintext(ctx, mm) for mm in msgs], src)
    return msgs, list(zip(cts[0::2], cts[1::2]))


@contextlib.contextmanager
def dense_calls():
    """Records the ops/ntt.modmatmul calls made while the block runs, as
    (operands, input shape, q).  The dense transform is a float64
    torch.matmul, not a kernel of the port, so it has no launch counter of
    its own; DeviceContext reaches it through the module attribute."""
    from fhe_si_tpu_torch.ops import ntt
    calls, plain = [], ntt.modmatmul

    def counted(tab, x, q):
        calls.append((tab, tuple(x.shape), q))
        return plain(tab, x, q)
    ntt.modmatmul = counted
    try:
        yield calls
    finally:
        ntt.modmatmul = plain


@contextlib.contextmanager
def plain_ct_calls():
    """Counts the calls of the plain Cooley-Tukey transforms
    (ops/ntt_ct.py) made while the block runs: the wrappers reach them only
    for CPU tensors, so a path on the card must make none."""
    from fhe_si_tpu_torch.ops import ntt_ct
    names = ("ct_fwd", "ct_fwd_digits", "ct_inv", "ct_fwd_n",
             "ct_fwd_digits_n", "ct_inv_n")
    calls, plain = [], {n: getattr(ntt_ct, n) for n in names}

    def counted(name):
        def call(*args, **kw):
            calls.append(name)
            return plain[name](*args, **kw)
        return call
    for n in names:
        setattr(ntt_ct, n, counted(n))
    try:
        yield calls
    finally:
        for n in names:
            setattr(ntt_ct, n, plain[n])


def check_launches(label, launches, expect, n_dense, n_plain):
    """The kernels in `expect` launched and no other, and no plain
    Cooley-Tukey transform ran; a run that launched no kernel must have
    gone through the dense transform, and one that did, not."""
    print(f"{label} launches: {launches}, dense transforms: {n_dense}, "
          f"plain Cooley-Tukey transforms: {n_plain}")
    for name, n in launches.items():
        if (n > 0) != (name in expect):
            raise AssertionError(f"{label}: {name} launched {n} times")
    if n_plain or (bool(expect) == bool(n_dense)):
        raise AssertionError(f"{label}: {n_dense} dense and {n_plain} plain "
                             "Cooley-Tukey transforms ran")


def lean_path(dev, cfg, batch, label, expect=tuple(KERNELS), dc=None):
    """keygen, relinearization key, batched encrypt of `batch` pairs,
    batched multiply + relinearize and batched decrypt at FheContext(cfg)
    (or on the DeviceContext dc), with the kernel counts set to 0 just
    before and read just after.  Every decrypt must equal
    oracle.plaintext_mul, and the kernels in `expect` must have launched
    and no other.  Returns (dc, ksw, pairs, out, launches)."""
    import torch
    from fhe_si_tpu_torch import DeviceContext, FheContext, sampling, scheme
    from fhe_si_tpu_torch.hostmath import oracle
    from fhe_si_tpu_torch.ops import ntt_ct_cuda
    t0 = time.perf_counter()
    if dc is None:
        dc = DeviceContext(FheContext(**cfg), dev)
    ctx = dc.ctx
    src = sampling.RandomSource(SEED)
    kg = sampling.sample_keygen(src, ctx.phim, ctx.stdev, ctx.log_q)
    kr = sampling.sample_keyswitch(src, ctx.phim, ctx.stdev, ctx.log_q, 3,
                                   ctx.ndigits)
    print(f"setup {ctx} on {dev}: {time.perf_counter() - t0:.2f} s")
    ntt_ct_cuda.reset_launches()
    with dense_calls() as dense, plain_ct_calls() as plain:
        sk, pk = scheme.keygen(dc, kg)
        ksw = scheme.KeySwitch.for_relinearization(sk, kr)
        msgs, pairs = encrypt_pairs(scheme, ctx, pk, src, batch)
        out = scheme.relin_batch(scheme.mul_batch(pairs), ksw)
        dec = sk.decrypt_batch(out)
        torch.cuda.synchronize()
    launches = dict(ntt_ct_cuda.LAUNCHES)
    check_launches(label, launches, expect, len(dense), len(plain))
    for c in out:
        if c.parts.shape != (2, ctx.phim, ctx.n_limbs_ct) \
                or c.parts.dtype != torch.int32:
            raise AssertionError(f"bad output part {tuple(c.parts.shape)}")
    for i in range(batch):
        want = oracle.plaintext_mul(ctx, msgs[2 * i], msgs[2 * i + 1])
        if not np.array_equal(dec[i].message, want):
            raise AssertionError(f"{label} pair {i}: decrypt != plaintext "
                                 "product")
    print(f"{label}: {batch}/{batch} decrypted products == plaintext "
          f"products at m={ctx.m} (phim {ctx.phim}, L={ctx.num_primes}, "
          f"Lk={len(ctx.ksw_rows)}, {ctx.ndigits} digits of "
          f"{ctx.digit_bits} bits, {'wide' if ctx.wide else 'narrow'} lane, "
          f"{'Cooley-Tukey' if ctx.use_ct else 'dense'} family)")
    return dc, ksw, pairs, out, launches


def step_cases(dc, batch):
    """The kernel calls of one mul+relin step on `batch` pairs: 4 parts
    lifted, 3 tensored parts back, 3 x ndigits digit rows transformed
    and 2 keyswitched parts back on the ksw basis."""
    return [("ct_fwd", "full", batch * 4), ("ct_inv", "full", batch * 3),
            ("ct_inv", "ksw", batch * 2),
            ("ct_fwd_digits", "ksw", batch * 3 * dc.ndigits)]


def time_step(card, dc, pairs, ksw, out, label):
    """mul+relin over the stacked pairs, held equal to `out` and timed;
    returns (a, b, ms per step, launches of one step)."""
    import torch
    from fhe_si_tpu_torch.ops import ntt_ct_cuda
    a = torch.stack([x.parts for x, _ in pairs])
    b = torch.stack([y.parts for _, y in pairs])
    ref = torch.stack([c.parts for c in out])
    step = lambda: dc.mul_relin(a, b, ksw.matrix_evals)  # noqa: E731
    for _ in range(2):
        step()
    ms = cuda_ms(step, 10)
    if not torch.equal(step(), ref):
        raise AssertionError(f"{label}: timed mul+relin output changed")
    print(f"[{card}] {label} mul+relin B={len(pairs)} m={dc.ctx.m}: "
          f"{ms:.3f} ms/step, {len(pairs) * 1000.0 / ms:.1f} mults/s")
    ntt_ct_cuda.reset_launches()
    step()
    return a, b, ms, dict(ntt_ct_cuda.LAUNCHES)


def time_stages(card, dc, a, b, ksw, label):
    """The four stages of one mul+relin step on the stacked pairs a, b,
    each timed with CUDA events."""
    tprod = dc._tensor_mul(a, b)
    parts = dc._scale_down(tprod)
    digs = dc._digit_evals(parts)
    stages = {
        "tensor_mul": lambda: dc._tensor_mul(a, b),
        "scale_down": lambda: dc._scale_down(tprod),
        "digit_evals": lambda: dc._digit_evals(parts),
        "keyswitch_digits": lambda: dc._keyswitch_digits(ksw.matrix_evals,
                                                         digs),
    }
    for name, fn in stages.items():
        print(f"[{card}] {label} stage {name}: {cuda_ms(fn, 5):.3f} ms")


def oracle_check_small(dev):
    """Ciphertext parts at m = 256 equal the pure-Python reference."""
    from fhe_si_tpu_torch import DeviceContext, FheContext, sampling, scheme
    from fhe_si_tpu_torch.hostmath import oracle
    ctx = FheContext(**SMALL[0])
    dc = DeviceContext(ctx, dev)
    src_d, src_o = sampling.RandomSource(SEED), sampling.RandomSource(SEED)
    sk, pk = scheme.keygen(dc, sampling.sample_keygen(
        src_d, ctx.phim, ctx.stdev, ctx.log_q))
    sko, pko = oracle.keygen(ctx, sampling.sample_keygen(
        src_o, ctx.phim, ctx.stdev, ctx.log_q))
    cts, octs, msgs = [], [], []
    for _ in range(2):
        mm = src_d.uniform_mod_p(ctx.phim, ctx.p)
        src_o.uniform_mod_p(ctx.phim, ctx.p)
        msgs.append(mm)
        cts.append(pk.encrypt(scheme.Plaintext(ctx, mm), src_d))
        octs.append(oracle.encrypt(pko, mm, sampling.sample_encrypt(
            src_o, ctx.phim, ctx.stdev)))
        if cts[-1].to_python_parts() != octs[-1].parts:
            raise AssertionError("m=256 encrypt differs from the oracle")
    ksw = scheme.KeySwitch.for_relinearization(sk, src_d)
    kswo = oracle.keyswitch_init_s2(sko, sampling.sample_keyswitch(
        src_o, ctx.phim, ctx.stdev, ctx.log_q, 3, ctx.ndigits))
    got = ksw.apply(cts[0] * cts[1])
    want = oracle.apply_keyswitch(kswo, oracle.mul(octs[0], octs[1]))
    if got.to_python_parts() != want.parts:
        raise AssertionError("m=256 mul+relin differs from the oracle")
    if list(sk.decrypt(got).message) != list(
            oracle.plaintext_mul(ctx, msgs[0], msgs[1])):
        raise AssertionError("m=256 decrypt differs from the plaintext product")
    print("m=256 ciphertext parts == hostmath/oracle.py (encrypt, mul+relin, "
          "decrypt)")


def time_kernels(card, dev, dc, cases, per_step=None):
    """Each (kernel, basis, rows) case against its plain version on random
    operands: held equal, then timed plain, kernel, kernel, plain, and
    set against its bound.  With per_step, also the kernel's launches per
    mul+relin step.  Returns {kernel: [(shape, kernel ms, plain ms, bound
    ms, bound_by), ...]} in case order."""
    import torch
    from fhe_si_tpu_torch.ops import ntt_ct, ntt_ct_cuda
    rng = np.random.default_rng(SEED)
    meta = dc.ct_meta
    lane = "wide" if dc.wide else "narrow"
    out = {}
    for name, basis, rows in cases:
        T = getattr(dc, basis)
        tab, q_np = T['ct'], T['primes_np']
        if name == "ct_fwd_digits":
            x = rng.integers(0, 1 << dc.digit_bits, size=(rows, meta.phim))
            run = lambda m, x: m.ct_fwd_digits(  # noqa: E731
                tab, x, meta, dc.digit_bits)
        else:
            x = rng.integers(0, q_np[:, None],
                             size=(rows, len(q_np), meta.phim))
            run = (lambda m, x: m.ct_fwd(tab, x, meta)) if name == "ct_fwd" \
                else (lambda m, x: m.ct_inv(tab, x, meta, 't2i_crt'))
        x = torch.as_tensor(x.astype(np.int32), device=dev)
        if not torch.equal(run(ntt_ct_cuda, x), run(ntt_ct, x)):
            raise AssertionError(f"{name}: kernel != plain at {tuple(x.shape)}")
        for _ in range(2):
            run(ntt_ct_cuda, x)
            run(ntt_ct, x)
        p1 = cuda_ms(lambda: run(ntt_ct, x), 5)
        k1 = cuda_ms(lambda: run(ntt_ct_cuda, x), 5)
        k2 = cuda_ms(lambda: run(ntt_ct_cuda, x), 5)
        p2 = cuda_ms(lambda: run(ntt_ct, x), 5)
        k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
        b_ms, b_by = kernel_bound(name, rows, len(q_np), meta)
        line = (f"[{card}] {name} {lane} m={dc.ctx.m} {basis} "
                f"{tuple(x.shape)}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms"
                f", bound {b_ms * 1e3:.1f} us ({b_by}), share of bound "
                f"{100 * b_ms / k_ms:.1f}%")
        if per_step is not None:
            line += f", launches per mul+relin step {per_step[name]}"
        print(line)
        out.setdefault(name, []).append((tuple(x.shape), k_ms, p_ms, b_ms, b_by))
    return out


def check_dense(dc):
    """The dense transforms of every basis on the card against the same
    function (ops/ntt.modmatmul on the same operands) on the CPU, bit for
    bit: forward, prescaled inverse and, on the full chain, the raw
    inverse, at a ragged row count and a [2, 3] lead shape; then the raw
    inverse undoes the forward transform on the card."""
    import torch
    from fhe_si_tpu_torch.ops import ntt
    ctx = dc.ctx
    label = (f"p={ctx.p} m={ctx.m} logQ {ctx.log_q} "
             f"{'wide' if ctx.wide else 'narrow'}")
    rng = np.random.default_rng(SEED)
    seen = set()
    for basis in ("full", "ksw", "lin"):
        T = getattr(dc, basis)
        if id(T) in seen:
            continue
        seen.add(id(T))
        q_np, q_cpu = T['primes_np'], T['q'].cpu()
        keys = [k for k in ("fwd", "inv_crt", "inv") if k in T]
        for key in keys:
            tab_cpu = tuple(t.cpu() for t in T[key])
            for lead in ((RAGGED_ROWS,), (2, 3)):
                x = rng.integers(0, q_np[:, None], size=lead + (
                    len(q_np), dc.phim)).astype(np.int32)
                got = ntt.modmatmul(T[key], torch.as_tensor(x, device=dc.device),
                                    T['q']).cpu()
                if not torch.equal(got, ntt.modmatmul(
                        tab_cpu, torch.as_tensor(x), q_cpu)):
                    raise AssertionError(f"dense {key} {label} basis={basis}: "
                                         "card != CPU")
            del tab_cpu
        print(f"dense transforms on the card == CPU: {label} basis={basis} "
              f"L={len(q_np)} {'+'.join(keys)}, {len(T['fwd'])} matmul(s) "
              "per transform")
    x = torch.as_tensor(rng.integers(0, ctx.primes[:, None], size=(
        RAGGED_ROWS, dc.L, dc.phim)).astype(np.int32), device=dc.device)
    if not torch.equal(dc.ntt_inv(dc.ntt_fwd(x)), x):
        raise AssertionError(f"dense ntt_inv(ntt_fwd(x)) != x at {label}")
    torch.cuda.synchronize()


def time_dense(card, calls, label):
    """The dense transform (ops/ntt.modmatmul: float64 torch.matmul, then
    mod q) at the shapes of `calls`, the modmatmul calls of one step: each
    distinct (table, input shape) timed on random residues with CUDA
    events, beside its bound, the larger of 2 * rows * L * n_out * n_in
    operations per matmul over the FP64 tensor-core rate and its bytes
    (the float64 table, the int32 input and output, each once) over the
    HBM rate.  Returns (calls, ms, bound ms) per step."""
    import torch
    from fhe_si_tpu_torch.ops import ntt
    rng = np.random.default_rng(SEED)
    groups: dict = {}
    for tab, shape, q in calls:
        groups.setdefault((id(tab[0]), shape), [tab, shape, q, 0])[3] += 1
    tot_ms = tot_bound = 0.0
    for tab, shape, q, n in groups.values():
        q_np = q.cpu().numpy().astype(np.int64)
        x = torch.as_tensor(rng.integers(0, q_np, size=shape).astype(np.int32),
                            device=q.device)
        run = lambda: ntt.modmatmul(tab, x, q)  # noqa: E731
        for _ in range(2):
            run()
        ms = (cuda_ms(run, 5) + cuda_ms(run, 5)) / 2
        *lead, L, n_in = shape
        rows, n_out = int(np.prod(lead)), tab[0].shape[-2]
        t_ops = (2 * rows * L * n_out * n_in * len(tab) / F64_OPS_PER_S
                 * 1e3)
        t_bytes = ((8 * L * n_out * n_in * len(tab) + 4 * rows * L
                    * (n_in + n_out)) / HBM_BYTES_PER_S * 1e3)
        bound, by = max((t_ops, "operations"), (t_bytes, "bytes"))
        print(f"[{card}] dense transform {label} {tuple(shape)} -> "
              f"L={L} n_out={n_out}, {len(tab)} matmul(s): {ms:.4f} ms, "
              f"bound {bound:.4f} ms ({by}), share of bound "
              f"{100 * bound / ms:.1f}%, calls per step {n}")
        tot_ms += n * ms
        tot_bound += n * bound
    print(f"[{card}] dense transform {label}: {len(calls)} calls per step, "
          f"{tot_ms:.3f} ms per step against a bound of {tot_bound:.3f} ms")
    return len(calls), tot_ms, tot_bound


def find_large_p(m: int, bits: int) -> int:
    """The largest prime p < 2^bits with m | p - 1 (slots of degree 1)."""
    from fhe_si_tpu_torch.hostmath import numbth
    p = (1 << bits) - 1
    p -= (p - 1) % m
    while not numbth.is_prime(p):
        p -= m
    return p


def phase_dense(dev, card):
    """Phase 7: the reference's own rings on the dense transform family.
    Returns the launch counts of each path, keyed by path, the dense
    transform's calls and times per step, and the p = 4007 FheContext."""
    import torch
    from fhe_si_tpu_torch import DeviceContext, FheContext
    from fhe_si_tpu_torch.cli import test_addmul, test_general
    launches = {}
    torch.cuda.reset_peak_memory_stats(dev)

    def part(name):
        print(f"phase 7{name} wall time: {time.perf_counter() - t0:.2f} s")
        return time.perf_counter()

    # a. bit for bit against the CPU, narrow (one matmul) and wide (split)
    t0 = time.perf_counter()
    dc = DeviceContext(FheContext(**BIG), dev)
    big_ctx = dc.ctx           # its host tables are reused in phase 9
    print(f"dense context {dc.ctx}: {time.perf_counter() - t0:.2f} s "
          "(host tables included)")
    if dc.use_ct or dc.wide or len(dc.full['fwd']) != 1:
        raise AssertionError("p=4007 logQ 170: expected dense, narrow, "
                             "one matmul per transform")
    check_dense(dc)
    wdc = DeviceContext(FheContext(**DENSE_WIDE), dev)
    if wdc.use_ct or not wdc.wide or len(wdc.full['fwd']) != 2:
        raise AssertionError("p=2027 prime_bits=23: expected dense, wide, "
                             "the 12-bit split")
    check_dense(wdc)
    del wdc
    t0 = part("a")

    # b. mul+relin at bench_big, uncut
    dc, ksw, pairs, out, launches["dense_mul_relin"] = lean_path(
        dev, BIG, BATCH, "dense path", expect=(), dc=dc)
    a, b, *_ = time_step(card, dc, pairs, ksw, out, "dense path")
    time_stages(card, dc, a, b, ksw, "dense path")
    with dense_calls() as calls:
        dc.mul_relin(a, b, ksw.matrix_evals)
        torch.cuda.synchronize()
    dense_step = time_dense(card, calls, f"m={dc.ctx.m} B={BATCH}")
    print(f"peak device memory (phase 7a-b): "
          f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB")
    del dc, ksw, pairs, out, a, b, calls
    torch.cuda.empty_cache()
    t0 = part("b")

    # c. the apps at the reference's regression ring
    launches.update(phase_apps(dev, card, APP_REF, "narrow", "_m4006",
                               expect=()))
    t0 = part("c")

    # d. Test_General at its defaults, Test_AddMul at bench_big's ring
    rc, text, *_, launches["general"] = run_cli(
        dev, test_general, ["test_general", str(GENERAL["p"]),
                            str(GENERAL["generator"]), str(GENERAL["log_q"]),
                            str(SEED), f"--device={dev}"], "general", ())
    if rc != 0 or text.strip() != "All tests finished.":
        raise AssertionError(f"Test_General failed (rc {rc})")
    t0 = part("d (Test_General)")
    rc, text, *_, launches["addmul"] = run_cli(
        dev, test_addmul, ["test_addmul", str(BIG["log_q"]), str(BIG["p"]),
                           str(BIG["generator"]), "--trials", "10",
                           f"--device={dev}"], "addmul", ())
    if rc != 0 or not text.rstrip().endswith("All tests SUCCEEDED!"):
        raise AssertionError(f"Test_AddMul failed (rc {rc})")
    t0 = part("d (Test_AddMul)")

    # e. decompSize 4 on the main Cooley-Tukey ring: 32-bit digits as
    # residues through ct_fwd, no ct_fwd_digits
    dc, *_, launches["decomp4"] = lean_path(
        dev, DECOMP4, BATCH_DECOMP4, "decompSize 4",
        expect=("ct_fwd", "ct_inv"))
    if dc.digit_bits != 32:
        raise AssertionError(f"decompSize 4: {dc.digit_bits}-bit digits")
    del dc
    t0 = part("e")

    # f. the large-p decrypt tail
    p = find_large_p(LARGE_P["m"], LARGE_P["bits"])
    cfg = dict(m=LARGE_P["m"], log_q=LARGE_P["log_q"], p=p,
               generator=LARGE_P["generator"])
    dc, *_, launches["large_p"] = lean_path(dev, cfg, BATCH_LARGE_P,
                                            f"large p={p}", expect=())
    if dc.ctx.slot_degree != 1 or p < 1 << 20:
        raise AssertionError(f"p={p}: not a large p with slots of degree 1")
    del dc
    torch.cuda.empty_cache()
    part("f")
    return launches, dense_step, big_ctx


def run_cli(dev, cli, argv, label, expect):
    """One port CLI's main(argv) on the card, its output captured and
    echoed, with the kernel counts set to 0 just before and read just
    after; the kernels in `expect` must have launched and no other.
    Returns (rc, stdout, stderr, launches)."""
    import torch
    from fhe_si_tpu_torch.ops import ntt_ct_cuda
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    out, err = io.StringIO(), io.StringIO()
    ntt_ct_cuda.reset_launches()
    with dense_calls() as dense, plain_ct_calls() as plain, \
            contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
        torch.cuda.synchronize()
    launches = dict(ntt_ct_cuda.LAUNCHES)
    print(out.getvalue(), end="")
    check_launches(label, launches, expect, len(dense), len(plain))
    return rc, out.getvalue(), err.getvalue(), launches


def phase_apps(dev, card, app, lane, suffix="", expect=tuple(KERNELS)):
    """The port's app CLIs at `app` on the card, each on the `lane`
    residue lane; m None runs the CLIs' default ring m = p - 1.  Returns
    each app's kernel launch counts, keyed by app name + suffix."""
    import torch
    from fhe_si_tpu_torch.cli.gen_data import generate
    from fhe_si_tpu_torch.cli import test_regression, test_statistics
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "data.txt")
        generate(path, app["dim"], app["n"], seed=SEED)
        for name, cli in (("regression", test_regression),
                          ("statistics", test_statistics)):
            argv = ["chip_smoke", path, str(app["p"]), str(app["generator"]),
                    str(SEED), f"--device={dev}"]
            if app["m"] is not None:
                argv.append(f"--m={app['m']}")
            rc, text, err, launches[name + suffix] = run_cli(
                dev, cli, argv, name + suffix, expect)
            if rc != 0 or text.rstrip().splitlines()[-1] != "MATCH":
                raise AssertionError(f"{name}{suffix}: no MATCH (rc {rc})\n"
                                     f"{err}")
            if f"({lane} lane)" not in text:
                raise AssertionError(f"{name}{suffix}: expected the {lane} "
                                     "lane")
            phases = json.loads(err.split("[phases] ", 1)[1].splitlines()[0])
            ring, log_q, primes = (next(ln.strip() for ln in text.splitlines()
                                        if ln.strip().startswith(key))
                                   for key in ("m:", "logQ:", "primes:"))
            print(f"[{card}] app {name} {ring} p={app['p']} {log_q} {primes}: "
                  + ", ".join(f"{k} {v:.3f} s" for k, v in phases.items())
                  + f"; peak device memory "
                  f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.3f} GiB;"
                  f" launches {launches[name + suffix]}")
    return launches


def phase_mixed(dev, card):
    """Phase 8: mul+relin on the mixed-radix family at full width.
    Returns the path's launches and its kernel timings at the path's
    shapes (time_kernels)."""
    import torch
    t0 = time.perf_counter()
    dc, ksw, pairs, out, launches = lean_path(dev, MIXED, BATCH_MIXED,
                                              "m=20480 path")
    if tuple(dc.ct_meta) != (128, 80, 8192, 5) or dc.wide or dc.L != 12:
        raise AssertionError(f"m=20480: {dc.ct_meta}, L={dc.L}, "
                             f"wide={dc.wide}")
    print(f"m=20480 path wall time: {time.perf_counter() - t0:.2f} s "
          "(setup, keys, encrypt, mul+relin, decrypt)")
    a, b, _, per_step = time_step(card, dc, pairs, ksw, out, "m=20480 path")
    time_stages(card, dc, a, b, ksw, "m=20480 path")
    kms = time_kernels(card, dev, dc, step_cases(dc, BATCH_MIXED), per_step)
    time_mixed_helpers(card, dc, BATCH_MIXED)
    print(f"peak device memory (phase 8): "
          f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB")
    print(f"phase 8 wall time: {time.perf_counter() - t0:.2f} s")
    return launches, kms


def time_mixed_helpers(card, dc, batch):
    """The plain phim <-> N steps that the wrappers run around the kernel
    (ops/ntt_ct.py pad_to_N and drop_excluded around the forward
    transforms, insert_excluded and fold_mod_phim around ct_inv), timed
    alone with CUDA events at the shapes of one mul+relin step."""
    import torch
    from fhe_si_tpu_torch.ops import ntt_ct
    meta = dc.ct_meta
    rng = np.random.default_rng(SEED)

    def rand(*shape):
        return torch.as_tensor(rng.integers(0, 40961, size=shape).astype(
            np.int32), device=dc.device)
    for name, basis, rows in step_cases(dc, batch):
        T = getattr(dc, basis)['ct']
        L = T['q'].shape[0]
        full = rand(rows, L, meta.N)
        if name == "ct_inv":
            ev = rand(rows, L, meta.phim)
            steps = (lambda: ntt_ct.insert_excluded(ev, meta),
                     lambda: ntt_ct.fold_mod_phim(full, T['q'], meta))
        else:
            x = rand(rows, meta.phim) if name == "ct_fwd_digits" \
                else rand(rows, L, meta.phim)
            steps = (lambda: ntt_ct.pad_to_N(x, meta),
                     lambda: ntt_ct.drop_excluded(full, meta))
        ms = [cuda_ms(f, 10) for f in steps]
        print(f"[{card}] {name} m={dc.ctx.m} {basis} rows={rows}: the "
              f"wrapper's phim <-> N steps {ms[0]:.4f} + {ms[1]:.4f} ms")


def phase_objects(dev, big_ctx, main_dc):
    """Phase 9: DoubleCrt at p = 4007, m = 4006; an npz round trip from
    the m = 8192 DeviceContext; the reference byte format at m = 22.
    Returns the kernel launches of the npz part."""
    import torch
    from fhe_si_tpu_torch import (DeviceContext, FheContext, refcompat,
                                  refserial, sampling, scheme,
                                  serialization as ser)
    from fhe_si_tpu_torch.doublecrt import DoubleCrt
    from fhe_si_tpu_torch.hostmath import numbth, oracle
    from fhe_si_tpu_torch.indexmap import IndexSet
    from fhe_si_tpu_torch.ops import ntt_ct_cuda
    t0 = time.perf_counter()

    def part(name):
        print(f"phase 9{name} wall time: {time.perf_counter() - t0:.2f} s")
        return time.perf_counter()

    # a. DoubleCrt on the card, dense ring phim 2002
    dc = DeviceContext(big_ctx, dev)
    ctx, L = dc.ctx, dc.L
    P = ctx.prime_product
    rng = np.random.default_rng(SEED)
    a = [int(v) for v in rng.integers(-2 ** 60, 2 ** 60, ctx.phim)]
    b = [int(v) for v in rng.integers(-2 ** 60, 2 ** 60, ctx.phim)]
    da, db = DoubleCrt.from_poly(dc, a), DoubleCrt.from_poly(dc, b)
    if da.evals.device != dev:
        raise AssertionError(f"DoubleCrt evals on {da.evals.device}")
    ca, cb = ([oracle.centered_mod(v, P) for v in x] for x in (a, b))
    if da.to_poly() != ca:
        raise AssertionError("DoubleCrt round trip")
    if (da + db).to_poly() != [oracle.centered_mod(x + y, P)
                               for x, y in zip(a, b)] \
            or (da - db).to_poly() != [oracle.centered_mod(x - y, P)
                                       for x, y in zip(a, b)]:
        raise AssertionError("DoubleCrt add/sub")
    want = oracle.poly_mod_phim(oracle.poly_mul(ca, cb), ctx.phim_x)
    if (da * db).to_poly() != [oracle.centered_mod(v, P)
                               for v in oracle.pad(want, ctx.phim)]:
        raise AssertionError("DoubleCrt product != oracle")
    if (da * 12345).div_by_constant(12345) != da:
        raise AssertionError("DoubleCrt div_by_constant")
    small = [int(v) for v in rng.integers(0, 1000, ctx.phim)]
    got = DoubleCrt.from_poly(dc, small).automorph(ctx.generator).to_poly()
    if got != oracle.automorph(oracle.OracleCiphertext(ctx, parts=[small]),
                               ctx.generator).parts[0]:
        raise AssertionError("DoubleCrt automorph != oracle")
    keep = IndexSet(0, L - 3)
    removed = int(ctx.primes[L - 2]) * int(ctx.primes[L - 1])
    da.scale_down_to_set(keep)
    poly = da.to_poly()
    if da.index_set != keep or da.evals.shape != (L - 2, ctx.phim) or any(
            new % ctx.p != old % ctx.p
            or abs(new) > abs(old) * ctx.p / removed + ctx.p
            for old, new in zip(a, poly)):
        raise AssertionError("DoubleCrt scale_down_to_set")
    print(f"DoubleCrt on the card at p={ctx.p} m={ctx.m} (phim {ctx.phim}, "
          f"L={L}): round trip, +, -, * == oracle, automorph == oracle, "
          f"scale_down_to_set to {L - 2} primes")
    del dc, da, db
    torch.cuda.empty_cache()
    t0 = part("a (DoubleCrt)")

    # b. npz export and import from the m = 8192 DeviceContext
    ctx = main_dc.ctx
    src = sampling.RandomSource(SEED)
    ntt_ct_cuda.reset_launches()
    sk, pk = scheme.keygen(main_dc, src)
    ksw = scheme.KeySwitch.for_relinearization(sk, src)
    msgs = [src.uniform_mod_p(ctx.phim, ctx.p) for _ in range(2)]
    cts = pk.encrypt_batch([scheme.Plaintext(ctx, mm) for mm in msgs], src)
    with tempfile.TemporaryDirectory() as d:
        ser.export_context(ctx, f"{d}/ctx.npz")
        ser.export_secret_key(sk, f"{d}/sk.npz")
        ser.export_public_key(pk, f"{d}/pk.npz")
        ser.export_keyswitch(ksw, f"{d}/ksw.npz")
        ser.export_ciphertext(cts[0], f"{d}/ct.npz")
        ser.export_ciphertext(cts[0] * cts[1], f"{d}/ct2.npz")
        dev2 = DeviceContext(ser.import_context(f"{d}/ctx.npz"), dev)
        sk2 = ser.import_secret_key(dev2, f"{d}/sk.npz")
        pk2 = ser.import_public_key(dev2, f"{d}/pk.npz")
        ksw2 = ser.import_keyswitch(dev2, f"{d}/ksw.npz")
        ct1 = ser.import_ciphertext(dev2, f"{d}/ct.npz")
        ct2 = ser.import_ciphertext(dev2, f"{d}/ct2.npz")
    if not (torch.equal(sk2.sk_evals, sk.sk_evals)
            and torch.equal(pk2.pk_limbs, pk.pk_limbs)
            and torch.equal(ksw2.matrix_evals, ksw.matrix_evals)
            and torch.equal(ct1.parts, cts[0].parts)
            and ct1.parts.device == dev):
        raise AssertionError("npz import differs from the export")
    if list(sk2.decrypt(ct1).message) != list(msgs[0] % ctx.p) or list(
            sk2.decrypt(ksw2.apply(ct2)).message) != list(
            oracle.plaintext_mul(ctx, msgs[0], msgs[1])):
        raise AssertionError("decrypt after npz import")
    ct3 = pk2.encrypt(scheme.Plaintext(dev2.ctx, msgs[1]), src)
    if list(sk2.decrypt(ct3).message) != list(msgs[1] % ctx.p):
        raise AssertionError("encrypt with an imported key")
    torch.cuda.synchronize()
    launches = dict(ntt_ct_cuda.LAUNCHES)
    print(f"npz round trip at m={ctx.m} on {dev}: context, keys and "
          f"ciphertexts equal after import, decrypts right; launches "
          f"{launches}")
    t0 = part("b (npz)")

    # c. the reference byte format at m = 22 on a synthetic reference chain
    ctx = FheContext(**REF_CANONICAL)
    dc = DeviceContext(ctx, dev)
    m2, primes, q = 2 * ctx.m, [], (1 << 30) - 1
    q = q - q % m2 + m2 + 1
    while len(primes) < 8:
        q -= m2
        if numbth.is_prime(q):
            primes.append(q)
    ref = refserial.RefContext(ctx.m, ctx.log_q, ctx.p, ctx.generator,
                               ctx.decomp_size,
                               [(q, numbth.find_element_of_order(q, m2))
                                for q in primes])
    if refserial.read_context(refserial.write_context(ref)) != ref:
        raise AssertionError("reference context stream round trip")
    src = sampling.RandomSource(SEED)
    sk, pk = scheme.keygen(dc, src)
    ksw = scheme.KeySwitch.for_relinearization(sk, src)
    msgs = [src.uniform_mod_p(ctx.phim, ctx.p) for _ in range(2)]
    cts = [pk.encrypt(scheme.Plaintext(ctx, mm), src) for mm in msgs]
    sk2 = refcompat.import_secret_key(refcompat.export_secret_key(sk, ref),
                                      ref, dc)
    pk2 = refcompat.import_public_key(refcompat.export_public_key(pk, ref),
                                      ref, dc)
    ksw2 = refcompat.import_keyswitch(refcompat.export_keyswitch(ksw, ref),
                                      ref, dc)
    ct2 = refcompat.import_ciphertext(refcompat.export_ciphertext(cts[0]), dc)
    if not (torch.equal(sk2.sk_evals, sk.sk_evals)
            and torch.equal(pk2.pk_evals, pk.pk_evals)
            and torch.equal(ksw2.matrix_evals, ksw.matrix_evals)
            and torch.equal(ct2.parts, cts[0].parts)):
        raise AssertionError("reference-format import differs from export")
    if list(sk2.decrypt(ksw2.apply(ct2 * cts[1])).message) != list(
            oracle.plaintext_mul(ctx, msgs[0], msgs[1])):
        raise AssertionError("decrypt after reference-format import")
    print(f"reference format at m={ctx.m} on {dev}: secret, public and "
          "keyswitch keys re-based through an 8-prime reference chain and "
          "back equal, the ciphertext equal, the product decrypts right")
    part("c (refcompat)")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; the port's "
              "kernels run only on a CUDA card", file=sys.stderr)
        return 1
    from fhe_si_tpu_torch import DeviceContext, FheContext
    from fhe_si_tpu_torch.ops import ntt_ct_cuda

    # 1. device
    dev = torch.device("cuda:0")
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    # 2. build
    t0 = time.perf_counter()
    log = ntt_ct_cuda.build()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc, sm_90a)")
    report = ptxas_report(log)
    if not report:
        raise AssertionError(f"no ptxas report in the build log:\n{log}")
    for line in report:
        print(f"ptxas {line}")

    # 3. kernels against their plain versions
    probe_semantics(dev)
    print("int32 wraparound, round-half-even, arithmetic >>, int32 sums, "
          "barrett: as on the CPU")
    max_err = phase_kernels(dev)

    # 4. the main path
    oracle_check_small(dev)
    dc, ksw, pairs, out, launches = lean_path(dev, MAIN, BATCH, "main path")

    # 4b. the same path at m = 2^15
    t0 = time.perf_counter()
    dc15, ksw15, pairs15, out15, launches15 = lean_path(
        dev, M15, BATCH15, "m=32768 path")
    print(f"m=32768 path wall time: {time.perf_counter() - t0:.2f} s "
          f"(setup, keys, encrypt, mul+relin, decrypt)")

    # 5. timing
    a, b, ms, per_step = time_step(card, dc, pairs, ksw, out, "main path")
    time_stages(card, dc, a, b, ksw, "main path")

    narrow_ms = time_kernels(card, dev, dc, step_cases(dc, BATCH), per_step)
    # the regression app's shapes at d = 4, one block: 14 products of
    # 2 x 2 parts lifted, 14 x 3 tensored parts back, 20 entries x 2 parts
    # keyswitched (digits on the ksw basis, the dot's result back on it)
    rdc = DeviceContext(FheContext(**app_contexts()["regression"]), dev)
    wide_ms = time_kernels(card, dev, rdc, [
        ("ct_fwd", "full", 14 * 4), ("ct_inv", "full", 14 * 3),
        ("ct_inv", "ksw", 20 * 2),
        ("ct_fwd_digits", "ksw", 20 * 2 * rdc.ndigits)])
    del rdc
    *_, per_step15 = time_step(card, dc15, pairs15, ksw15, out15,
                               "m=32768 path")
    m15_ms = time_kernels(card, dev, dc15, step_cases(dc15, BATCH15),
                          per_step15)
    del dc15, ksw15, pairs15, out15
    print(f"peak device memory (phases 3-5): "
          f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB")

    # 6. the applications
    app_launches = phase_apps(dev, card, APP, "wide")

    # 7. the reference's own rings on the dense transform family
    t0 = time.perf_counter()
    dense_launches, (n_dense, dense_ms, dense_bound), big_ctx = phase_dense(
        dev, card)
    print(f"phase 7 wall time: {time.perf_counter() - t0:.2f} s")

    # 8. the mixed-radix family at full width
    mixed_launches, mixed_ms = phase_mixed(dev, card)

    # 9. the object API and the serializers
    t0 = time.perf_counter()
    npz_launches = phase_objects(dev, big_ctx, dc)
    print(f"phase 9 wall time: {time.perf_counter() - t0:.2f} s")
    kernels = []
    for name in KERNELS:
        by_path = dict(mul_relin=launches[name],
                       mul_relin_m32768=launches15[name],
                       mul_relin_m20480=mixed_launches[name],
                       npz_m8192=npz_launches[name],
                       **{path: n[name] for path, n in
                          (app_launches | dense_launches).items()})
        _, k_ms, p_ms, b_ms, b_by = narrow_ms[name][0]
        kernels.append(dict(
            name=name, route="cuda", source="fhe_si_tpu_torch/csrc/ct_ntt.cu",
            replaces=KERNELS[name],
            launches=sum(by_path.values()), launches_by_path=by_path,
            max_abs_err=max_err[name], ms=k_ms, plain_ms=p_ms,
            bound_ms=b_ms, bound_by=b_by,
            library_ms=None,     # no PyTorch call computes a transform mod q
            wide_ms=wide_ms[name][0][1], wide_plain_ms=wide_ms[name][0][2],
            m32768_ms=m15_ms[name][0][1], m32768_plain_ms=m15_ms[name][0][2],
            m32768_bound_ms=m15_ms[name][0][3],
            m20480_ms=mixed_ms[name][0][1], m20480_plain_ms=mixed_ms[name][0][2],
            m20480_bound_ms=mixed_ms[name][0][3]))

    # not a kernel of the port: the XLA einsum of the JAX package
    # (fhe_si_tpu/ops/ntt.py modmatmul) is plain float64 torch.matmul here
    print(json.dumps({"dense_transform": dict(
        source="fhe_si_tpu_torch/ops/ntt.py", calls_per_step=n_dense,
        ms_per_step=dense_ms, bound_ms_per_step=dense_bound,
        bound_by_config=f"m={BIG['m']} B={BATCH}")}))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
