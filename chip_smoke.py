#!/usr/bin/env python3
"""Smoke run of the PyTorch port (fhe_si_tpu_torch) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --sass LIBRARY KERNEL...   (SASS counts only)
    python3 chip_smoke.py --steps m20480 REPEATS     (one step's windows only)
    python3 chip_smoke.py --rowsplit                 (m = 2^15 transforms only)

Phases, each of which raises on failure (any failure exits nonzero and
prints no result line):
  1. device check: refuses to run without CUDA; prints the card's name
     and power limit as nvidia-smi reports them;
  2. build: compiles the CUDA kernels from fhe_si_tpu_torch/csrc
     (ct_ntt.cu, crt.cu, modular.cu, digits.cu and route.cu, one nvcc
     each, started together)
     and prints
     ptxas's report for each kernel (registers, shared memory, spills)
     and, where cuobjdump is found, the static SASS instruction counts of
     the main path's limb/CRT kernel instances, whole and per loop
     (sass_report; --sass gives the same for any library and kernels);
     checks that the card allows at least the shared memory per block
     that DeviceContext's choice of transform route assumes
     (ntt_ct_cuda.SMEM_MAX);
  3. each kernel against its plain PyTorch version on the card, at the
     narrow tables of m = 8192, 256 and 32 and the wide (23-bit prime)
     tables of both apps' contexts (m = 8192, logQ 213 and 132) and of
     m = 256 and 32, on the full chain and both subset bases, and on
     tables of a narrow and a wide prime at m = 2^14 and 2^15, with a
     ragged row count, a [2, 3] lead shape, the forward/inverse round
     trip and both inverse tables, bit for bit; the same on mixed-radix
     tables (m = 2^a * q^b: the kernel on the N-point transform, the
     wrappers' pad, drop, insert and fold around it) at m = 40, 96, 160,
     18 and 54 on narrow primes (odd N1 among them), m = 13122 (81 x 81)
     on one narrow prime and m = 20480 (128 x 80) on a narrow and a
     23-bit prime; plus the int32 semantics the port relies on
     (wraparound, round half to even, arithmetic >>).  The two limb/CRT
     kernels (ops/crt_cuda.py: crt_to_limbs as partials, finish and in
     one pass, each without a tail, with ScaleDown's and with the signed
     reduction; limbs_to_residues at the ciphertext and reconstruction
     widths, and from two sources as _tensor_mul lifts) against their
     plain versions on every basis of the same
     contexts, on random inputs with a worst-case row (every residue
     q - 1, every limb 0xFFFF, negative values), bit for bit; later
     phases do the same on every other context they build (m = 2^15,
     the dense rings, m = 20480, the 'limb' shard's tables, p = 8147 and
     m = 2^16 on the route).  The two modular kernels
     (ops/modular_cuda.py: tensor_product on the two halves of one lifted
     tensor, on separate 3- and 2-part tensors and at 4 x 4 parts;
     keyswitch_dot at K = 3 x ndigits) against their plain versions on
     every basis of every one of those contexts, with a worst-case row
     (every residue q - 1), bit for bit; the digit kernel
     (ops/digits_cuda.py byte_decomp, check_digits) on each context's
     logQ and digits, at the ciphertext and reconstruction widths, alone
     and with the keyswitch basis' residues;
  4. the main path at FheContext(m=8192, log_q=80, p=40961, g=3):
     keygen, relinearization key, batched encrypt of 64 pairs, batched
     multiply + relinearize, batched decrypt; every decrypt must equal
     the plaintext product, every kernel must have launched, no
     plain function that the limb/CRT kernels replace may have run on a
     CUDA tensor (on any path below either), and no plain modular
     function (PLAIN_MODULAR: ops/modular.py mod_mul, mod_add, mod_dot,
     the two plain versions of ops/modular_cuda.py) on a CUDA tensor
     inside the mul+relin step (on every step checked below: 4b, 7b, 7e,
     7f, 8, 10a, 11b, 11d; 10b-c through the ranks' launch counts).  At
     m = 256 the ciphertext parts must also equal hostmath/oracle.py;
  4b. the same path at the benchmark cell ct32768_q220w.b64's ring,
     FheContext(m=32768, log_q=220, p=65537, g=3) (wide lane: 23 primes,
     10 digits), on 4 pairs; prints its wall time and
     ntt_ct_cuda.TWIDDLE_GLOBAL of one mul+relin (1, 1 and 2: the
     128 x 128 layout reads its twiddle from global memory; 0 on the
     main path, 1, 1 and 2 again at m = 20480 in phase 8);
  5. timing with CUDA events: mul+relin at batch 64 (the median of three
     windows of 10 steps), its four stages, and each kernel against its
     plain version and its bound (the larger of its int32 bytes over the
     HBM rate and its int8 byte products over the int8 tensor-core rate
     for the transforms, its int32 operations over the INT32 rate for
     the limb/CRT and modular kernels; the benchmark's yardstick,
     bench_port/roofline.py) at the main path's shapes, at the
     regression app's wide shapes and at the m = 2^15 path's shapes (with
     4 pairs: its mul+relin step too); at the main path's and the m = 2^15
     path's shapes also with its launches per mul+relin step; each
     kernel also with its device time alone (device_ms: the host enqueues
     its calls behind a spin kernel, so a short kernel's time is not its
     wrapper's host time); at the cell ct32768_q220w.b64's 64 pairs,
     each transform's grid (tiles a prime, rows a block, waves of the
     card's resident blocks, beside the ceil(slots / L) grid that
     sync_tiles replaced) and its device time, and that time over waves x
     rows a block (time_transform_grids), then each on the rowsplit
     schedule against the sync schedule (fsi_ct_sync) in turns, ns a
     (row, prime) and share of ntt_bound (time_rowsplit);
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
        bound, and its calls per step, the limb/CRT kernels at the step's
        shapes;
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
     plain version; at the cell mixed20480_q80.b64's 64 pairs each
     transform's grid and device time (time_transform_grids, as at
     m = 2^15 in phase 5);
  9. the object API and the serializers on the card: DoubleCrt round
     trip, arithmetic, automorph against the oracle and
     scale_down_to_set at p = 4007, m = 4006 (dense, phim 2002); an npz
     export/import of context, keys and ciphertexts from the m = 8192
     DeviceContext, decrypted right after import; the reference byte
     format (refcompat) round trip of keys and ciphertexts at m = 22 on a
     synthetic reference chain;
 10. the sharded pipelines, the profiler and the native codec core:
     a. an NCCL world of one rank in this process: ShardedPipelines
        (dp = 1, limb = 1) and its block reduce on the main path's 64
        pairs; the batch equal to DeviceContext.mul_relin bit for bit,
        every decrypt to oracle.plaintext_mul and the block reduce to
        their sum; every kernel launched (on the shard's rows) and no
        plain transform; the limb/CRT kernels against their plain versions
        on the shard tables of this world and of both halves of a
        limb = 2 world; the sharded and the unsharded step timed in turns
        with CUDA events, and the unsharded step's kernels by name from a
        torch.profiler trace, with its aten::cat launches per step;
     b. worlds of fhe_si_tpu_torch.parallel.run_distributed at m = 8192,
        batch 64, all started at once on the one card: one rank (NCCL),
        two ranks over gloo as (dp = 1, limb = 2) and as (dp = 2,
        limb = 1); each block reduce and batched output equal to the single
        rank's, each batched output to the unsharded step; per-rank times
        (ranks share the card: not a scaling figure);
     c. a world of two ranks (gloo) as coeff = 2, batch 8, in the same
        start: the output equal to the unsharded step, no transform
        kernel launched (the coefficient-sharded transforms are plain
        PyTorch), both limb/CRT and both modular kernels launched;
     d. Test_Regression --trace at phase 6's config: MATCH, and the trace
        names ct_mma_kernel among its kernels; the regression phase by
        kernel name;
     e. the native codec core (built with g++) against the pure-Python
        codec on phase 9's reference-format keys and ciphertexts and an
        m = 8192 ciphertext: the same bytes, both timed;
 11. the matmul route (ops/ntt_ct_matmul.py: exact float64 stage
     products; on a split N x 1 its folded form, one GEMM a transform
     between the boundary kernels of csrc/route.cu), which DeviceContext
     picks for the Cooley-Tukey splits the kernel cannot take, each part
     with its wall time:
     a. at the reference's ring p = 8147 (m = 8146, logQ 170, g = 3:
        4073 x 1, L = 21 narrow): ct_route printed, no kernel table
        built, the route's transforms on the card against the same
        functions on the CPU, bit for bit (forward, raw and prescaled
        inverse, 24-bit digits) on the full chain and both subsets;
     b. mul+relin there at batch 64: every decrypt equal to
        oracle.plaintext_mul (computed on a pool of processes), no
        transform kernel launched, the route's boundary kernels launched,
        no plain Cooley-Tukey transform, the route's counts moved; then
        the step and its four stages timed with CUDA events, the
        limb/CRT, modular and digit kernels at the step's shapes; peak
        device memory; then, at the route cell's shapes (logQ 188,
        L = 23, 13 on the keyswitch basis), each transform's route_enter
        and route_leave held equal to their plain versions on the CPU,
        then they and its GEMM timed alone (time_route), each against its
        bound, the kernels beside their plain versions timed on the card;
     c. Test_Statistics at p = 8147 (MATCH) and Test_AddMul 170 8147 3
        --trials 10, the latter in a child process
        (chip_smoke.py --route-cli) started when the phase starts, both
        on the route's folded form with no transform kernel launched;
     d. m = 2^16 (logQ 120, 256 x 128, L = 14 wide): the route on the
        card against the CPU on its full chain and both subsets, and
        mul+relin on 4 pairs, every decrypt right.
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
from typing import NamedTuple

import numpy as np

from bench_port import cell as bench_cell
from bench_port.roofline import (F64_OPS_PER_S, HBM_BYTES_PER_S, crt_bound,
                                 modular_bound, ntt_bound)
from bench_port.roofline_route import route_bound

SEED = 2024
RAGGED_ROWS = 37           # no block size divides it
BATCH = 64                 # ciphertext pairs per mul+relin step
MAIN = dict(m=8192, log_q=80, p=40961, generator=3)
# the wide cell's ring: wide lane, L = 23, 10 digits
M15 = bench_cell.load("ct32768_q220w.b64").config["context"]
BATCH15 = 4
BATCH15_CELL = 64          # the benchmark cell ct32768_q220w.b64's batch
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
BATCH_MIXED_CELL = 64       # the benchmark cell mixed20480_q80.b64's batch
# PERF.md section 6, the traced b64 cell run before the kernel did the
# phim <-> N steps: each transform's kernel alone, ms per step, and the
# plain steps around them
UNFUSED_MIXED_MS = {"ct_fwd": 0.4925, "ct_fwd_digits": 1.2664, "ct_inv": 0.5728,
                 "steps": 1.741}
# mixed-radix tables of phase 3: (m, narrow primes, 23-bit primes)
MIXED_TABLES = [(40, 2, 0), (96, 2, 0), (160, 2, 0), (18, 2, 0), (54, 2, 0),
                (13122, 1, 0), (20480, 1, 1)]
REF_CANONICAL = dict(m=22, log_q=80, p=23, generator=7)
# the matmul route (splits the tensor-core kernel cannot take): the
# reference's ring m = p - 1 next in size to p = 4007, N = 4073 prime
# (4073 x 1), and m = 2^16 (256 x 128) at the largest logQ its prime
# window admits
ROUTE = dict(m=8146, log_q=170, p=8147, generator=3)
# the benchmark's route cell's ring (bench_port/configs/route8146_q188.json)
ROUTE_CELL = bench_cell.load("route8146_q188.b64").config["context"]
ROUTE_APP = dict(p=8147, generator=3, m=None, dim=4, n=256)
M16 = dict(m=65536, log_q=120, p=65537, generator=3)
BATCH16 = 4
ORACLE_WORKERS = 5      # processes for oracle.plaintext_mul at phim 4072
SPIN_CYCLES = 100_000_000       # device_ms's spin: about 50 ms at 1.98 GHz
PALLAS = "fhe_si_tpu/ops/ntt_ct_pallas.py"
NTT = ("ct_fwd", "ct_fwd_digits", "ct_inv")
CRT = ("crt_to_limbs", "limbs_to_residues")
MODULAR = ("tensor_product", "keyswitch_dot")
DIGITS = ("byte_decomp",)
# the kernels of a path that launches no transform kernel (the dense
# family, the matmul route): every mul+relin step lifts, multiplies,
# reconstructs and keyswitches, its digits split by byte_decomp
# (decompSize <= 3)
NO_TRANSFORM = CRT + MODULAR + DIGITS
# the matmul route's boundary kernels (csrc/route.cu), which its folded
# form (a split N x 1: the rings m = p - 1 past p = 4127) launches around
# each transform's GEMM; a path on that form launches them besides
ROUTE_KERNELS = ("route_enter", "route_leave")
FOLDED = NO_TRANSFORM + ROUTE_KERNELS
# XLA-fused jnp around the JAX package's stage products, not Pallas
ROUTE_REPLACES = {
    "route_enter": "fhe_si_tpu/ops/ntt_ct.py:319-320, :332-333, :350-355, "
                   ":370-374 (XLA-fused jnp, not Pallas)",
    "route_leave": "fhe_si_tpu/ops/ntt_ct.py:323, :377-380 (XLA-fused jnp, "
                   "not Pallas)"}
KERNELS = {   # wrapper -> (source, the TPU code it replaces)
    "ct_fwd": ("fhe_si_tpu_torch/csrc/ct_ntt.cu", f"{PALLAS}:148"),
    "ct_fwd_digits": ("fhe_si_tpu_torch/csrc/ct_ntt.cu", f"{PALLAS}:137"),
    "ct_inv": ("fhe_si_tpu_torch/csrc/ct_ntt.cu", f"{PALLAS}:158"),
    # not Pallas kernels: jnp code that XLA fuses on the TPU
    "crt_to_limbs": ("fhe_si_tpu_torch/csrc/crt.cu",
                     "fhe_si_tpu/ops/crt.py:234 (XLA-fused jnp, not Pallas)"),
    "limbs_to_residues": ("fhe_si_tpu_torch/csrc/crt.cu",
                          "fhe_si_tpu/ops/crt.py:38 (XLA-fused jnp, not "
                          "Pallas)"),
    "tensor_product": ("fhe_si_tpu_torch/csrc/modular.cu",
                       "fhe_si_tpu/device.py:558 (XLA-fused jnp, not "
                       "Pallas)"),
    "keyswitch_dot": ("fhe_si_tpu_torch/csrc/modular.cu",
                      "fhe_si_tpu/ops/modular.py:75 (XLA-fused jnp, not "
                      "Pallas)"),
    "byte_decomp": ("fhe_si_tpu_torch/csrc/digits.cu",
                    "fhe_si_tpu/ops/limbs.py:236 (XLA-fused jnp, not "
                    "Pallas)"),
}
# kernel vs plain, over phase 3 on (the route's kernels: time_route)
MAX_ERR = dict.fromkeys([*KERNELS, *ROUTE_KERNELS], 0)


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


def device_ms(fn, iters: int = 20) -> float | None:
    """Device time (ms) per call of fn, with the host ahead of the card: a
    spin kernel (torch.cuda._sleep, SPIN_CYCLES) holds the stream while the
    host enqueues `iters` calls between two events, so the events time the
    calls' kernels back to back and not the host's time between launches,
    which a short kernel's wrapper can exceed (cuda_ms times both).  None
    when the host took longer to enqueue than the spin lasted."""
    import torch
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    ev[0].record()
    torch.cuda._sleep(SPIN_CYCLES)
    ev[1].record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    ev[2].record()
    torch.cuda.synchronize()
    if host_ms >= ev[0].elapsed_time(ev[1]):
        return None
    return ev[1].elapsed_time(ev[2]) / iters


def reset_launches():
    """Every kernel's launch count to 0."""
    from fhe_si_tpu_torch.ops import cuda_build
    cuda_build.reset_launches()


def launch_counts() -> dict:
    """Every kernel's launch count since reset_launches."""
    from fhe_si_tpu_torch.ops import cuda_build
    return dict(cuda_build.LAUNCHES)


def digits_bound(rows: int, n: int, nd: int, lk: int,
                 phim: int) -> tuple[float, str]:
    """Least time (ms) the card could take for one byte_decomp call: its
    int32 limbs [rows, phim, n] read and its digits [rows, nd, phim] (or
    their residues, [rows, nd, lk, phim]) written once each over the HBM
    rate.  Its operations (a funnel shift and mask a digit, a product and
    a subtraction a residue) are far below the INT32 rate's bound."""
    nbytes = 4 * rows * phim * (n + nd * max(lk, 1))
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes"


def route_boundary_bound(kernel: str, mode: str, rows: int, L: int,
                         phim: int, N: int) -> tuple[float, str]:
    """Least time (ms) the card could take for one call of the matmul
    route's boundary kernel `kernel` (route_enter, route_leave) around the
    GEMM of a transform in enter mode `mode`: its operands read and
    written once each over the HBM rate, 4 B an int32 residue or digit, 8 B
    a float64 GEMM entry.  route_enter reads [rows, L, phim] residues (or
    [rows, phim] digits, once for every prime) and writes the [rows, L, N]
    operand; route_leave reads the [L, N, rows] output and writes
    [rows, L, phim] residues.  Their few operations an entry (a Shoup
    product, a float64 quotient and remainder) are far below the INT32
    and FP64 rates' bounds.  The benchmark has no counterpart: its
    route_roofline reads the GEMMs alone (bench_port/roofline_route.py)."""
    n_res = rows * L * phim
    n_in = rows * phim if mode == "fwd_digits" else n_res
    nbytes = 8 * rows * L * N + 4 * (n_in if kernel == "route_enter"
                                     else n_res)
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes"


def ptxas_report(log: str) -> list[str]:
    """ptxas -v lines per kernel: name, registers, spills, shared memory."""
    out, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and ("registers" in line or "spill" in line):
            out.append(f"{name}: {line.split('info    :')[-1].strip()}")
    return out


# the limb/CRT kernel instances of the main path (m = 8192): ScaleDown's
# reconstruction (n = 17, 9 words), the keyswitch's (n = 13, 7 words) and
# the lift at n_ct = 6 (3 words)
MAIN_CRT_SASS = ("crt_pass_kernel<9>", "crt_pass_kernel<7>", "lift_kernel<3>")
SASS_KINDS = ("IMAD.WIDE", "IMAD", "LDS", "LDG", "STS", "STG", "LDL", "STL")


def sass_kernel_name(mangled: str) -> str:
    """crt.cu's kernel names from their mangled form, with their integer
    template arguments (crt_pass_kernel<9>, crt_kernel<0, 24>, ...); the
    mangled name itself for anything else."""
    import re
    m = re.search(r"\d+(crt_pass_kernel|crt_kernel|lift_kernel)"
                  r"I((?:Li-?\d+E)+)E", mangled)
    if not m:
        return mangled
    return f"{m.group(1)}<{', '.join(re.findall(r'Li(-?\d+)E', m.group(2)))}>"


def sass_report(so_path: str, names) -> list[str]:
    """Static SASS instruction counts (cuobjdump -sass) of the kernels of
    the library so_path named in `names` (sass_kernel_name): the total
    and by kind (SASS_KINDS, IMAD without the .WIDE forms; LDL and STL
    are local memory), and the same for each loop (the instructions from
    a backward branch's target, a label or an address, to the branch),
    which is what a tile, a residue row or a prime pays per iteration.
    An empty list when cuobjdump is missing."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return []
    text = subprocess.run([tool, "-sass", so_path], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    out = []
    for block in text.split("Function : ")[1:]:
        name = sass_kernel_name(block.split(None, 1)[0])
        if name not in names:
            continue
        insts, labels, pending = [], {}, []
        for line in block.splitlines():
            lab = re.match(r"\s*(\.L_x_\d+):", line)
            if lab:
                pending.append(lab.group(1))
                continue
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                         r"([A-Z][A-Z0-9_.]*)(.*)", line)
            if not m:
                continue
            addr = int(m.group(1), 16)
            for lab_name in pending:
                labels[lab_name] = addr
            pending = []
            target = re.search(r"(0x[0-9a-f]+|\.L_x_\d+)", m.group(3))
            insts.append((addr, m.group(2), target and target.group(1)))

        def counts(sel):
            c = dict.fromkeys(SASS_KINDS, 0)
            for _, op, _ in sel:
                kind = next((k for k in SASS_KINDS if op.startswith(k)), None)
                if kind:
                    c[kind] += 1
            return (f"{len(sel)} ("
                    + ", ".join(f"{k} {v}" for k, v in c.items()) + ")")
        line = f"sass {name}: {counts(insts)}"
        for addr, op, target in insts:
            start = (int(target, 16) if target and target.startswith("0x")
                     else labels.get(target))
            if op.startswith("BRA") and start is not None and start < addr:
                body = [i for i in insts if start <= i[0] <= addr]
                line += f"; loop {start:#06x}-{addr:#06x}: {counts(body)}"
        out.append(line)
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
    rng = np.random.default_rng(SEED)
    check = check_equal

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

    wide = list(app_contexts().values()) + [
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
        check_basis_kernels(dc, f"m={cfg['m']} logQ={cfg['log_q']}")
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


def check_equal(name, got, want):
    """Kernel output == plain output, bit for bit; the largest difference
    seen is kept in MAX_ERR."""
    import torch
    d = (got.to(torch.int64) - want.to(torch.int64)).abs().max().item()
    MAX_ERR[name] = max(MAX_ERR[name], d)
    if d:
        raise AssertionError(f"{name}: kernel differs from plain by {d}")


def check_crt(dc, label, rows=RAGGED_ROWS, bases=("full", "ksw", "lin")):
    """Both limb/CRT kernels in every mode against their plain versions on
    the card, on each basis of dc, bit for bit: crt_to_limbs as partials,
    as finish (on the partials) and in one pass, each without a tail,
    with ScaleDown's rounding and with the signed reduction; the lift at
    the ciphertext and the reconstruction widths, and from two sources
    (the operands of _tensor_mul) against the plain lift of the two
    joined.  Inputs are random
    with a worst-case row: every residue q - 1, every limb 0xFFFF (the
    value -1), and negative values."""
    import torch
    from fhe_si_tpu_torch.ops import crt, crt_cuda
    rng = np.random.default_rng(SEED)
    seen = set()
    for basis in bases:
        T = getattr(dc, basis)
        if id(T) in seen:
            continue
        seen.add(id(T))
        q, fc = T['primes_np'], T['fast_crt']
        res = rng.integers(0, q[:, None], size=(rows, len(q), dc.phim))
        res[0] = q[:, None] - 1
        res = torch.as_tensor(res.astype(np.int32), device=dc.device)
        part = crt_cuda.crt_partials(res, fc, dc.wide)
        for got, want in zip(part, crt_cuda.crt_partials_plain(res, fc,
                                                               dc.wide)):
            check_equal("crt_to_limbs", got, want)
        for tail in (None, dc.tail("round_down"), dc.tail("reduce_signed")):
            want = crt_cuda.crt_to_limbs_plain(res, fc, dc.wide, tail)
            check_equal("crt_to_limbs",
                        crt_cuda.crt_to_limbs(res, fc, dc.wide, tail), want)
            check_equal("crt_to_limbs",
                        crt_cuda.crt_finish(*part, fc, dc.wide, tail), want)
        n = fc['B'].shape[-1]
        for width in (dc.n_ct, n):
            poly = rng.integers(0, 1 << 16, size=(rows, dc.phim, width))
            poly[0] = 0xFFFF
            poly[1, :, -1] |= 0x8000
            args = (torch.as_tensor(poly.astype(np.int32), device=dc.device),
                    T['chunk_tbl'], dc._wrap_const(q, width), T['q'],
                    T['qinv_f'], dc.wide)
            check_equal("limbs_to_residues", crt_cuda.limbs_to_residues(*args),
                        crt.limbs_to_residues(*args))
        # the two-source lift of _tensor_mul: 2 + 2 parts, each side read
        # in place, against the plain lift of the two joined
        poly = torch.as_tensor(rng.integers(0, 1 << 16, size=(
            rows, 4, dc.phim, dc.n_ct)).astype(np.int32), device=dc.device)
        poly[0, 0] = 0xFFFF
        a, b = poly[:, :2].contiguous(), poly[:, 2:].contiguous()
        args = (T['chunk_tbl'], dc._wrap_const(q, dc.n_ct), T['q'],
                T['qinv_f'], dc.wide)
        check_equal("limbs_to_residues",
                    crt_cuda.limbs_to_residues(a, *args, second=b),
                    crt.limbs_to_residues(poly, *args))
        print(f"crt kernels == plain: {label} "
              f"{'wide' if dc.wide else 'narrow'} basis={basis} "
              f"rows={len(q)} n={n} n_ct={dc.n_ct} phim={dc.phim}")
    torch.cuda.synchronize()


def check_modular(dc, label, rows=RAGGED_ROWS, bases=("full", "ksw", "lin")):
    """Both modular kernels against their plain versions on the card, on
    each basis of dc, bit for bit: tensor_product on the two halves of one
    [rows, 4, L, phim] tensor (views, as _tensor_mul passes them), on
    separate 3- and 2-part tensors and at 4 x 4 parts (the kernel's
    limit); keyswitch_dot at K = 3 x ndigits (a relinearization) over a
    [rows] lead.  Residues are random with a worst-case row: every residue
    q - 1."""
    import torch
    from fhe_si_tpu_torch.ops import modular_cuda as mc
    rng = np.random.default_rng(SEED)
    seen = set()
    for basis in bases:
        T = getattr(dc, basis)
        if id(T) in seen:
            continue
        seen.add(id(T))
        q = T['primes_np']

        def res(*lead):
            x = rng.integers(0, q[:, None], size=lead + (len(q), dc.phim))
            x[0] = q[:, None] - 1
            return torch.as_tensor(x.astype(np.int32), device=dc.device)
        ev = res(rows, 4)
        plain = (T['q'], T['qinv_f'], dc.wide)
        for a, b in ((ev[:, :2], ev[:, 2:]), (res(rows, 3), res(rows, 2)),
                     (res(2, 4), res(2, 4))):
            check_equal("tensor_product", mc.tensor_product(a, b, T, dc.wide),
                        mc.tensor_product_plain(a, b, T['p_mod_q'], *plain))
        K = 3 * dc.ndigits
        mat, dig = res(2, K), res(rows, K)
        check_equal("keyswitch_dot", mc.keyswitch_dot(mat, dig, T, dc.wide),
                    mc.keyswitch_dot_plain(mat, dig, *plain))
        print(f"modular kernels == plain: {label} "
              f"{'wide' if dc.wide else 'narrow'} basis={basis} "
              f"rows={len(q)} K={K} phim={dc.phim}")
    torch.cuda.synchronize()


def check_digits(dc, label, rows=RAGGED_ROWS):
    """byte_decomp against its plain version on the card, bit for bit, at
    dc's logQ and digits: limbs at the ciphertext and the reconstruction
    widths with a worst-case row (every limb 0xFFFF), the digits alone
    and their residues modulo the keyswitch basis' primes."""
    if dc.digit_bits > 24:
        return
    import torch
    from fhe_si_tpu_torch.ops import digits_cuda
    rng = np.random.default_rng(SEED)
    q = dc.ksw['q']
    for n in sorted({dc.n_ct, dc.full['fast_crt']['B'].shape[-1]}):
        x = rng.integers(0, 1 << 16, size=(rows, dc.phim, n))
        x[0] = (1 << 16) - 1
        x = torch.as_tensor(x.astype(np.int32), device=dc.device)
        for primes in (None, q):
            args = (x, dc.log_q, dc.digit_bits, dc.ndigits, primes)
            check_equal("byte_decomp", digits_cuda.byte_decomp(*args),
                        digits_cuda.byte_decomp_plain(*args))
    print(f"{label}: byte_decomp == plain ({rows} rows, widths n_ct and "
          f"the reconstruction's, digits and their residues)")


def check_basis_kernels(dc, label, rows=RAGGED_ROWS,
                        bases=("full", "ksw", "lin")):
    """check_crt, check_modular and (where the keyswitch basis is among
    `bases`) check_digits: every kernel that works on dc's bases (all but
    the transforms) against its plain version."""
    check_crt(dc, label, rows, bases)
    check_modular(dc, label, rows, bases)
    if "ksw" in bases:
        check_digits(dc, label, rows)


def _plaintext_mul_job(phim, phim_x, p, a, b):
    """oracle.plaintext_mul in a worker process: the product reads only
    the ring's phim, Phi_m and p."""
    from types import SimpleNamespace
    from fhe_si_tpu_torch.hostmath import oracle
    return oracle.plaintext_mul(SimpleNamespace(phim=phim, phim_x=phim_x,
                                                p=p), a, b)


def oracle_products(ctx, msgs, pool=None) -> list:
    """oracle.plaintext_mul(ctx, msgs[2i], msgs[2i + 1]) for every pair,
    as thunks: submitted to `pool` now (the reduction mod a dense Phi_m
    is seconds of Python per product at phim 4072), or computed in this
    process when a thunk is called."""
    from fhe_si_tpu_torch.hostmath import oracle
    pairs = list(zip(msgs[0::2], msgs[1::2]))
    if pool is None:
        return [lambda a=a, b=b: oracle.plaintext_mul(ctx, a, b)
                for a, b in pairs]
    return [pool.submit(_plaintext_mul_job, ctx.phim, ctx.phim_x, ctx.p,
                        a, b).result for a, b in pairs]


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


# the plain functions that the two limb/CRT kernels replace: ops/crt.py's
# and crt_cuda.tail_plain (the limb tails).  The decrypt tail
# (crt.limbs_to_mod_small) and the Garner cross-check
# (crt.residues_to_limbs) stay plain and are not counted.
PLAIN_CRT = {"crt": ("limbs_to_residues", "crt_partials", "crt_finish",
                     "residues_to_limbs_fast"),
             "crt_cuda": ("tail_plain",)}
# the plain modular functions: those of ops/modular.py that the two
# modular kernels replace on the mul+relin step, and their plain versions
# in ops/modular_cuda.py.  Keygen, encrypt, decrypt, the constant
# multiplies and signed_group_sum_tensored still call ops/modular.py on
# the card, so only the step is counted (lean_path, phase 10a); the
# mixed-radix fold's mod_add (ops/ntt_ct.py fold_mod_phim, the transform
# wrapper's plain phim <-> N step, imported by name) is not counted.
PLAIN_MODULAR = {"modular": ("mod_mul", "mod_add", "mod_dot"),
                 "modular_cuda": ("tensor_product_plain",
                                  "keyswitch_dot_plain")}


@contextlib.contextmanager
def plain_calls(table: dict, calls: list):
    """Appends to `calls` the name of each call, on a CUDA tensor, of the
    plain functions of `table` ({module of fhe_si_tpu_torch.ops: names})
    made while the block runs: the wrappers reach them only for CPU
    tensors, so a path on the card must make none."""
    import importlib
    mods = {m: importlib.import_module(f"fhe_si_tpu_torch.ops.{m}")
            for m in table}
    plain = {(m, n): getattr(mods[m], n)
             for m, names in table.items() for n in names}

    def counted(key):
        def call(x, *args, **kw):
            if x.is_cuda:
                calls.append(key[1])
            return plain[key](x, *args, **kw)
        return call
    for key in plain:
        setattr(mods[key[0]], key[1], counted(key))
    try:
        yield calls
    finally:
        for key, fn in plain.items():
            setattr(mods[key[0]], key[1], fn)


class PathCounts(NamedTuple):
    """What a block ran besides the kernels (transform_calls)."""
    dense: list      # ops/ntt.modmatmul calls: the dense family's
    #                  transforms, or the two-stage matmul route's stage
    #                  products (its folded form, N x 1, makes none)
    plain: list      # plain Cooley-Tukey transforms (ops/ntt_ct.py)
    route: dict      # ops/ntt_ct_matmul.CALLS, filled when the block ends
    plain_crt: list  # plain limb/CRT functions on CUDA tensors (PLAIN_CRT)
    plain_modular: list  # plain modular functions on CUDA tensors inside
    #                      the mul+relin steps the caller wraps in
    #                      plain_calls(PLAIN_MODULAR, ...)


@contextlib.contextmanager
def transform_calls():
    """dense_calls, plain_ct_calls, the plain limb/CRT calls and the
    matmul route's counts (set to 0 on entry) of the block, and an empty
    list for the plain modular calls of its mul+relin step."""
    from fhe_si_tpu_torch.ops import ntt_ct_matmul
    ntt_ct_matmul.reset_calls()
    route: dict = {}
    with dense_calls() as dense, plain_ct_calls() as plain, \
            plain_calls(PLAIN_CRT, []) as plain_crt:
        yield PathCounts(dense, plain, route, plain_crt, [])
    route.update(ntt_ct_matmul.CALLS)


def check_launches(label, launches, expect, calls: PathCounts,
                   route: bool = False):
    """The kernels in `expect` launched and no other, and no plain
    Cooley-Tukey transform, no plain limb/CRT function (PLAIN_CRT) and no
    plain modular function inside a wrapped mul+relin step
    (PLAIN_MODULAR) ran on a CUDA tensor.  With route, the block must have
    run the matmul route (ops/ntt_ct_matmul.py) and launched no transform
    kernel, and either its stage products ran as modmatmul calls or its
    boundary kernels launched (ROUTE_KERNELS: the folded form), not both;
    without, it must not have touched the route, and a run that launched
    no transform kernel must have gone through the dense transform, and
    one that did, not."""
    n_dense, n_plain = len(calls.dense), len(calls.plain)
    n_crt, n_mod = len(calls.plain_crt), len(calls.plain_modular)
    n_route = sum(calls.route.values())
    print(f"{label} launches: {launches}, modmatmul calls: {n_dense}, "
          f"plain Cooley-Tukey transforms: {n_plain}, plain limb/CRT calls "
          f"on the card: {n_crt}, plain modular calls in the step: {n_mod}, "
          f"matmul-route transforms: {calls.route}")
    for name, n in launches.items():
        if (n > 0) != (name in expect):
            raise AssertionError(f"{label}: {name} launched {n} times")
    ntt = any(name in NTT for name in expect)
    if route:
        folded = any(launches.get(k) for k in ROUTE_KERNELS)
        bad = ntt or not n_route or folded == bool(n_dense)
    else:
        bad = bool(n_route) or ntt == bool(n_dense)
    if n_plain or n_crt or n_mod or bad:
        raise AssertionError(f"{label}: {n_dense} modmatmul calls, {n_plain} "
                             f"plain Cooley-Tukey transforms, {n_crt} plain "
                             f"limb/CRT calls ({sorted(set(calls.plain_crt))}), "
                             f"{n_mod} plain modular calls "
                             f"({sorted(set(calls.plain_modular))}) "
                             f"and {n_route} matmul-route transforms ran")


class LeanRun(NamedTuple):
    dc: object
    ksw: object
    pairs: list
    out: list
    launches: dict
    sk: object
    msgs: list


def lean_path(dev, cfg, batch, label, expect=tuple(KERNELS), dc=None,
              route=False, pool=None):
    """keygen, relinearization key, batched encrypt of `batch` pairs,
    batched multiply + relinearize and batched decrypt at FheContext(cfg)
    (or on the DeviceContext dc), with the kernel counts set to 0 just
    before and read just after.  Every decrypt must equal
    oracle.plaintext_mul (computed on `pool`, a process pool, while the
    card works, when given), and the kernels in `expect` must have
    launched and no other (check_launches; route: the matmul route ran
    instead), and no plain modular function (PLAIN_MODULAR) may have run
    on a CUDA tensor inside the mul+relin step.  Returns a LeanRun (msgs: the 2 * batch messages, pair i of
    msgs[2i], msgs[2i + 1])."""
    import torch
    from fhe_si_tpu_torch import DeviceContext, FheContext, sampling, scheme
    t0 = time.perf_counter()
    if dc is None:
        dc = DeviceContext(FheContext(**cfg), dev)
    ctx = dc.ctx
    src = sampling.RandomSource(SEED)
    kg = sampling.sample_keygen(src, ctx.phim, ctx.stdev, ctx.log_q)
    kr = sampling.sample_keyswitch(src, ctx.phim, ctx.stdev, ctx.log_q, 3,
                                   ctx.ndigits)
    print(f"setup {ctx} on {dev}: {time.perf_counter() - t0:.2f} s")
    reset_launches()
    with transform_calls() as calls:
        sk, pk = scheme.keygen(dc, kg)
        ksw = scheme.KeySwitch.for_relinearization(sk, kr)
        msgs, pairs = encrypt_pairs(scheme, ctx, pk, src, batch)
        wants = oracle_products(ctx, msgs, pool)
        with plain_calls(PLAIN_MODULAR, calls.plain_modular):
            out = scheme.relin_batch(scheme.mul_batch(pairs), ksw)
        dec = sk.decrypt_batch(out)
        torch.cuda.synchronize()
    launches = launch_counts()
    check_launches(label, launches, expect, calls, route)
    for c in out:
        if c.parts.shape != (2, ctx.phim, ctx.n_limbs_ct) \
                or c.parts.dtype != torch.int32:
            raise AssertionError(f"bad output part {tuple(c.parts.shape)}")
    for i, want in enumerate(wants):
        if not np.array_equal(dec[i].message, want()):
            raise AssertionError(f"{label} pair {i}: decrypt != plaintext "
                                 "product")
    print(f"{label}: {batch}/{batch} decrypted products == plaintext "
          f"products at m={ctx.m} (phim {ctx.phim}, L={ctx.num_primes}, "
          f"Lk={len(ctx.ksw_rows)}, {ctx.ndigits} digits of "
          f"{ctx.digit_bits} bits, {'wide' if ctx.wide else 'narrow'} lane, "
          f"{'Cooley-Tukey' if ctx.use_ct else 'dense'} family)")
    return LeanRun(dc, ksw, pairs, out, launches, sk, msgs)


def step_cases(dc, batch, ntt=True):
    """The kernel calls of one mul+relin step on `batch` pairs, as (kernel,
    basis, rows, tail): 4 parts lifted (limbs_to_residues, ct_fwd), 3
    tensored parts back (ct_inv, then crt_to_limbs with ScaleDown's
    tail), 3 x ndigits digit rows transformed, and 2 keyswitched parts
    back on the ksw basis (ct_inv, crt_to_limbs with the signed
    reduction), the tensor product of the 2 x 2 lifted parts, the
    keyswitch dot of the 3 x ndigits digit rows (rows: the batch) and the
    digit split of the 3 ScaleDown parts (their residues on a ring
    without the transform kernel).
    ntt=False: the other kernels only (the dense family and the matmul
    route launch no transform kernel)."""
    cases = [("ct_fwd", "full", batch * 4, None),
             ("ct_inv", "full", batch * 3, None),
             ("ct_inv", "ksw", batch * 2, None),
             ("ct_fwd_digits", "ksw", batch * 3 * dc.ndigits, None)]
    other = [("crt_to_limbs", "full", batch * 3, "round_down"),
             ("crt_to_limbs", "ksw", batch * 2, "reduce_signed"),
             ("limbs_to_residues", "full", batch * 4, None),
             ("tensor_product", "full", batch, None),
             ("keyswitch_dot", "ksw", batch, None),
             ("byte_decomp", "ksw", batch * 3, None)]
    return (cases if ntt else []) + other


def check_twiddle_global(dc, pairs, ksw, label, want: int):
    """ntt_ct_cuda.TWIDDLE_GLOBAL over one mul+relin of the pairs, printed
    and held to `want` forward transforms (forward, digits) and 2 * want
    inverse ones: the launches whose layout reads the twiddle pairs from
    global memory."""
    import torch
    from fhe_si_tpu_torch.ops import ntt_ct_cuda
    a = torch.stack([x.parts for x, _ in pairs])
    b = torch.stack([y.parts for _, y in pairs])
    ntt_ct_cuda.reset_twiddle_global()
    dc.mul_relin(a, b, ksw.matrix_evals)
    torch.cuda.synchronize()
    got = dict(ntt_ct_cuda.TWIDDLE_GLOBAL)
    print(f"{label}: TWIDDLE_GLOBAL per mul+relin {got}")
    if got != {"ct_fwd": want, "ct_fwd_digits": want, "ct_inv": 2 * want}:
        raise AssertionError(f"{label}: TWIDDLE_GLOBAL {got}, want {want}, "
                             f"{want}, {2 * want}")


def time_step(card, dc, pairs, ksw, out, label):
    """mul+relin over the stacked pairs, held equal to `out` and timed in
    three windows of 10 steps; returns (a, b, the median window's ms per
    step, launches of one step)."""
    import torch
    a = torch.stack([x.parts for x, _ in pairs])
    b = torch.stack([y.parts for _, y in pairs])
    ref = torch.stack([c.parts for c in out])
    step = lambda: dc.mul_relin(a, b, ksw.matrix_evals)  # noqa: E731
    for _ in range(2):
        step()
    windows = [cuda_ms(step, 10) for _ in range(3)]
    ms = sorted(windows)[1]
    if not torch.equal(step(), ref):
        raise AssertionError(f"{label}: timed mul+relin output changed")
    print(f"[{card}] {label} mul+relin B={len(pairs)} m={dc.ctx.m}: "
          f"{ms:.3f} ms/step, {len(pairs) * 1000.0 / ms:.1f} mults/s "
          f"(median of windows {', '.join(f'{w:.3f}' for w in windows)})")
    reset_launches()
    step()
    return a, b, ms, launch_counts()


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


STEP_CONFIGS = {"m8192": (MAIN, BATCH), "m20480": (MIXED, BATCH_MIXED),
                "m32768": (M15, BATCH15)}


def steps_only(dev, name: str, repeats: int) -> int:
    """The mul+relin step of STEP_CONFIGS[name] alone: its lean path
    (decrypts checked), then `repeats` rounds of time_step (three windows
    of 10 steps each), for the small-batch steps whose windows spread."""
    cfg, batch = STEP_CONFIGS[name]
    card = card_line()
    dc, ksw, pairs, out = lean_path(dev, cfg, batch, f"{name} path")[:4]
    for _ in range(repeats):
        time_step(card, dc, pairs, ksw, out, f"{name} path")
    print(card)
    return 0


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


def _case(dc, name, basis, rows, tail, rng):
    """One timed case: (its input, run(kernel: bool), bound ms, bound_by).
    The transforms' run takes the wrapper of ops/ntt_ct_cuda.py or the
    plain ops/ntt_ct.py, the limb/CRT kernels' the wrapper of
    ops/crt_cuda.py or its plain version, the modular kernels' the wrapper
    of ops/modular_cuda.py or its plain version (tensor_product on the two
    halves of one [rows, 4, L, phim] tensor, keyswitch_dot at K = 3 x
    ndigits); the lift from two sources of rows / 4 x 2 parts, as
    _tensor_mul runs it (its plain version joins them first)."""
    import torch
    from fhe_si_tpu_torch.ops import (crt, crt_cuda, modular_cuda as mc,
                                      ntt_ct, ntt_ct_cuda)
    T = getattr(dc, basis)
    q_np, meta = T['primes_np'], dc.ct_meta
    if name == "byte_decomp":
        from fhe_si_tpu_torch.ops import digits_cuda
        x = torch.as_tensor(rng.integers(0, 1 << 16, size=(
            rows, dc.phim, dc.n_ct)).astype(np.int32), device=dc.device)
        primes = None if dc.use_ct else T['q']
        args = (x, dc.log_q, dc.digit_bits, dc.ndigits, primes)
        return (x, lambda k: (digits_cuda.byte_decomp if k else
                              digits_cuda.byte_decomp_plain)(*args),
                *digits_bound(rows, dc.n_ct, dc.ndigits,
                              0 if dc.use_ct else len(q_np), dc.phim))
    if name in MODULAR:
        L = len(q_np)

        def res(*lead):
            return torch.as_tensor(rng.integers(0, q_np[:, None], size=lead + (
                L, dc.phim)).astype(np.int32), device=dc.device)
        plain = (T['q'], T['qinv_f'], dc.wide)
        if name == "tensor_product":
            x = res(rows, 4)
            a, b = x[:, :2], x[:, 2:]
            return (x, lambda k: mc.tensor_product(a, b, T, dc.wide) if k
                    else mc.tensor_product_plain(a, b, T['p_mod_q'], *plain),
                    *modular_bound(name, rows, L, dc.phim))
        K = 3 * dc.ndigits
        mat, x = res(2, K), res(rows, K)
        return (x, lambda k: mc.keyswitch_dot(mat, x, T, dc.wide) if k
                else mc.keyswitch_dot_plain(mat, x, *plain),
                *modular_bound(name, rows, L, dc.phim, K))
    if name in NTT:
        tab = T['ct']
        if name == "ct_fwd_digits":
            x = rng.integers(0, 1 << dc.digit_bits, size=(rows, meta.phim))
            fn = lambda m, x: m.ct_fwd_digits(  # noqa: E731
                tab, x, meta, dc.digit_bits)
        else:
            x = rng.integers(0, q_np[:, None],
                             size=(rows, len(q_np), meta.phim))
            fn = (lambda m, x: m.ct_fwd(tab, x, meta)) if name == "ct_fwd" \
                else (lambda m, x: m.ct_inv(tab, x, meta, 't2i_crt'))
        x = torch.as_tensor(x.astype(np.int32), device=dc.device)
        return (x, lambda k: fn(ntt_ct_cuda if k else ntt_ct, x),
                *ntt_bound(name, rows, len(q_np), meta.phim, meta.N, meta.N1,
                           meta.N2))
    fc, n = T['fast_crt'], T['fast_crt']['B'].shape[-1]
    if name == "crt_to_limbs":
        t = dc.tail(tail) if tail else None
        x = torch.as_tensor(rng.integers(0, q_np[:, None], size=(
            rows, len(q_np), dc.phim)).astype(np.int32), device=dc.device)
        return (x, lambda k: (crt_cuda.crt_to_limbs if k else
                              crt_cuda.crt_to_limbs_plain)(x, fc, dc.wide, t),
                *crt_bound(name, rows, len(q_np), n, t.width if t else n,
                           dc.phim))
    # as _tensor_mul lifts: two sources of rows / 4 x 2 parts each; the
    # plain version joins them (torch.cat) and lifts
    x = torch.as_tensor(rng.integers(0, 1 << 16, size=(
        rows // 4, 4, dc.phim, dc.n_ct)).astype(np.int32), device=dc.device)
    a, b = x[:, :2].contiguous(), x[:, 2:].contiguous()
    args = (T['chunk_tbl'], dc._wrap_const(q_np, dc.n_ct), T['q'],
            T['qinv_f'], dc.wide)
    return (x, lambda k: crt_cuda.limbs_to_residues(a, *args, second=b) if k
            else crt.limbs_to_residues(torch.cat([a, b], dim=-3), *args),
            *crt_bound(name, rows, len(q_np), dc.n_ct, dc.n_ct, dc.phim))


def time_kernels(card, dev, dc, cases, per_step=None):
    """Each (kernel, basis, rows, tail) case against its plain version on
    random operands: held equal, then timed plain, kernel, kernel, plain
    with CUDA events (the wrapper's host time included), then the
    kernel's device time alone (device_ms), each set against its bound.
    With per_step, also the kernel's launches per mul+relin step.
    Returns {kernel: [(shape, kernel ms, plain ms, bound ms, bound_by,
    device ms or None), ...]} in case order."""
    import torch
    rng = np.random.default_rng(SEED)
    lane = "wide" if dc.wide else "narrow"
    out = {}
    for name, basis, rows, tail in cases:
        x, run, b_ms, b_by = _case(dc, name, basis, rows, tail, rng)
        if not torch.equal(run(True), run(False)):
            raise AssertionError(f"{name}: kernel != plain at {tuple(x.shape)}")
        for _ in range(2):
            run(True)
            run(False)
        p1 = cuda_ms(lambda: run(False), 5)
        k1 = cuda_ms(lambda: run(True), 5)
        k2 = cuda_ms(lambda: run(True), 5)
        p2 = cuda_ms(lambda: run(False), 5)
        k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
        what = f"{name}{' + ' + tail if tail else ''}"
        line = (f"[{card}] {what} {lane} m={dc.ctx.m} {basis} "
                f"{tuple(x.shape)}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms"
                f", bound {b_ms * 1e3:.1f} us ({b_by}), share of bound "
                f"{100 * b_ms / k_ms:.1f}%")
        d_ms = device_ms(lambda: run(True))
        line += ("; device time not measured (the host was slower than the "
                 "spin)" if d_ms is None else f"; device time {d_ms:.4f} ms, "
                 f"share of bound {100 * b_ms / d_ms:.1f}%")
        if per_step is not None:
            line += f", launches per mul+relin step {per_step[name]}"
        print(line)
        out.setdefault(name, []).append((tuple(x.shape), k_ms, p_ms, b_ms, b_by,
                                         d_ms))
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
    check_basis_kernels(dc, f"p={BIG['p']} m={BIG['m']} logQ={BIG['log_q']} dense")
    wdc = DeviceContext(FheContext(**DENSE_WIDE), dev)
    if wdc.use_ct or not wdc.wide or len(wdc.full['fwd']) != 2:
        raise AssertionError("p=2027 prime_bits=23: expected dense, wide, "
                             "the 12-bit split")
    check_dense(wdc)
    check_basis_kernels(wdc, f"p={DENSE_WIDE['p']} m={DENSE_WIDE['m']} dense")
    del wdc
    t0 = part("a")

    # b. mul+relin at bench_big, uncut
    dc, ksw, pairs, out, launches["dense_mul_relin"] = lean_path(
        dev, BIG, BATCH, "dense path", expect=NO_TRANSFORM, dc=dc)[:5]
    a, b, _, per_step = time_step(card, dc, pairs, ksw, out, "dense path")
    time_stages(card, dc, a, b, ksw, "dense path")
    time_kernels(card, dev, dc, step_cases(dc, BATCH, ntt=False), per_step)
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
                               expect=NO_TRANSFORM))
    t0 = part("c")

    # d. Test_General at its defaults, Test_AddMul at bench_big's ring
    rc, text, *_, launches["general"] = run_cli(
        dev, test_general, ["test_general", str(GENERAL["p"]),
                            str(GENERAL["generator"]), str(GENERAL["log_q"]),
                            str(SEED), f"--device={dev}"], "general",
        NO_TRANSFORM)
    if rc != 0 or text.strip() != "All tests finished.":
        raise AssertionError(f"Test_General failed (rc {rc})")
    t0 = part("d (Test_General)")
    rc, text, *_, launches["addmul"] = run_cli(
        dev, test_addmul, ["test_addmul", str(BIG["log_q"]), str(BIG["p"]),
                           str(BIG["generator"]), "--trials", "10",
                           f"--device={dev}"], "addmul", NO_TRANSFORM)
    if rc != 0 or not text.rstrip().endswith("All tests SUCCEEDED!"):
        raise AssertionError(f"Test_AddMul failed (rc {rc})")
    t0 = part("d (Test_AddMul)")

    # e. decompSize 4 on the main Cooley-Tukey ring: 32-bit digits as
    # residues through ct_fwd, no ct_fwd_digits
    dc, *_, launches["decomp4"] = lean_path(
        dev, DECOMP4, BATCH_DECOMP4, "decompSize 4",
        expect=("ct_fwd", "ct_inv") + CRT + MODULAR)[:5]
    if dc.digit_bits != 32:
        raise AssertionError(f"decompSize 4: {dc.digit_bits}-bit digits")
    del dc
    t0 = part("e")

    # f. the large-p decrypt tail
    p = find_large_p(LARGE_P["m"], LARGE_P["bits"])
    cfg = dict(m=LARGE_P["m"], log_q=LARGE_P["log_q"], p=p,
               generator=LARGE_P["generator"])
    dc, *_, launches["large_p"] = lean_path(dev, cfg, BATCH_LARGE_P,
                                            f"large p={p}",
                                            expect=NO_TRANSFORM)[:5]
    if dc.ctx.slot_degree != 1 or p < 1 << 20:
        raise AssertionError(f"p={p}: not a large p with slots of degree 1")
    del dc
    torch.cuda.empty_cache()
    part("f")
    return launches, dense_step, big_ctx


def run_cli(dev, cli, argv, label, expect, route=False):
    """One port CLI's main(argv) on the card, its output captured and
    echoed, with the kernel counts set to 0 just before and read just
    after; the kernels in `expect` must have launched and no other.
    Returns (rc, stdout, stderr, launches)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    out, err = io.StringIO(), io.StringIO()
    reset_launches()
    with transform_calls() as calls, \
            contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
        torch.cuda.synchronize()
    launches = launch_counts()
    print(out.getvalue(), end="")
    check_launches(label, launches, expect, calls, route)
    return rc, out.getvalue(), err.getvalue(), launches


def phase_apps(dev, card, app, lane, suffix="", expect=tuple(KERNELS),
               route=False, names=("regression", "statistics")):
    """The port's app CLIs `names` at `app` on the card, each on the
    `lane` residue lane; m None runs the CLIs' default ring m = p - 1.
    Returns each app's kernel launch counts, keyed by app name + suffix."""
    import torch
    from fhe_si_tpu_torch.cli.gen_data import generate
    from fhe_si_tpu_torch.cli import test_regression, test_statistics
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "data.txt")
        generate(path, app["dim"], app["n"], seed=SEED)
        for name, cli in (("regression", test_regression),
                          ("statistics", test_statistics)):
            if name not in names:
                continue
            argv = ["chip_smoke", path, str(app["p"]), str(app["generator"]),
                    str(SEED), f"--device={dev}"]
            if app["m"] is not None:
                argv.append(f"--m={app['m']}")
            rc, text, err, launches[name + suffix] = run_cli(
                dev, cli, argv, name + suffix, expect, route)
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
                                              "m=20480 path")[:5]
    if tuple(dc.ct_meta) != (128, 80, 8192, 5) or dc.wide or dc.L != 12:
        raise AssertionError(f"m=20480: {dc.ct_meta}, L={dc.L}, "
                             f"wide={dc.wide}")
    check_basis_kernels(dc, f"m={MIXED['m']} logQ={MIXED['log_q']}", rows=9)
    check_twiddle_global(dc, pairs, ksw, "m=20480 path", 1)
    print(f"m=20480 path wall time: {time.perf_counter() - t0:.2f} s "
          "(setup, keys, encrypt, mul+relin, decrypt)")
    a, b, _, per_step = time_step(card, dc, pairs, ksw, out, "m=20480 path")
    time_stages(card, dc, a, b, ksw, "m=20480 path")
    kms = time_kernels(card, dev, dc, step_cases(dc, BATCH_MIXED), per_step)
    time_mixed_transforms(card, dc, BATCH_MIXED_CELL)
    time_transform_grids(card, dc, BATCH_MIXED_CELL)
    print(f"peak device memory (phase 8): "
          f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB")
    print(f"phase 8 wall time: {time.perf_counter() - t0:.2f} s")
    return launches, kms


def time_mixed_transforms(card, dc, batch):
    """The four transforms of one mul+relin step at m = 20480 on `batch`
    pairs (the cell's 64), each through its wrapper, which does the
    phim <-> N steps in the kernel, held equal to the way the parent of
    that change ran it, the plain steps of ops/ntt_ct.py (pad_to_N and
    drop_excluded around the forward transforms, insert_excluded and
    fold_mod_phim around ct_inv) around the N-point kernel (fsi_ct_sync:
    the same kernel without the steps).  Each is timed alone on the
    device (device_ms): the wrapper, the N-point kernel, the plain steps;
    printed beside UNFUSED_MIXED_MS."""
    import torch
    from fhe_si_tpu_torch.ops import ntt_ct, ntt_ct_cuda
    meta = dc.ct_meta
    rng = np.random.default_rng(SEED)
    sums = {"wrapper": 0.0, "kernel": 0.0, "steps": 0.0}
    for name, basis, rows, _ in step_cases(dc, batch)[:4]:
        T, q = getattr(dc, basis)['ct'], getattr(dc, basis)['primes_np']
        L, inv = len(q), name == "ct_inv"
        if name == "ct_fwd_digits":
            x = rng.integers(0, 1 << dc.digit_bits, size=(rows, meta.phim))
            run = lambda x: ntt_ct_cuda.ct_fwd_digits(  # noqa: E731
                T, x, meta, dc.digit_bits)
        else:
            x = rng.integers(0, q[:, None], size=(rows, L, meta.phim))
            run = (lambda x: ntt_ct_cuda.ct_inv(T, x, meta, 't2i_crt')) \
                if inv else (lambda x: ntt_ct_cuda.ct_fwd(T, x, meta))
        x = torch.as_tensor(x.astype(np.int32), device=dc.device)

        def n_point(v):
            return _sync_transform(dc, name, T, v)
        if inv:
            pre = lambda: ntt_ct.insert_excluded(x, meta).contiguous()  # noqa: E731
            post = lambda full: ntt_ct.fold_mod_phim(  # noqa: E731
                full, T['q'], meta)
        else:
            pre = lambda: ntt_ct.pad_to_N(x, meta).contiguous()  # noqa: E731
            post = lambda full: ntt_ct.drop_excluded(full, meta)  # noqa: E731
        padded = pre()
        full = n_point(padded)
        if not torch.equal(run(x), post(full)):
            raise AssertionError(f"{name} m={dc.ctx.m}: the kernel's phim "
                                 "<-> N steps != the plain ones")
        ms = {"wrapper": device_ms(lambda: run(x)),
              "kernel": device_ms(lambda: n_point(padded)),
              "pre": device_ms(pre), "post": device_ms(lambda: post(full))}
        if None in ms.values():
            raise AssertionError(f"{name}: the host was slower than the spin")
        ms["steps"] = ms.pop("pre") + ms.pop("post")
        for k in sums:
            sums[k] += ms[k]
        print(f"[{card}] {name} m={dc.ctx.m} {basis} rows={rows}: the "
              f"wrapper (steps in the kernel) {ms['wrapper']:.4f} ms; apart: "
              f"the N-point kernel {ms['kernel']:.4f} + the plain steps "
              f"{ms['steps']:.4f} ms")
    was = UNFUSED_MIXED_MS
    print(f"[{card}] m={dc.ctx.m} B={batch} step's transforms, device ms: "
          f"the wrappers {sums['wrapper']:.4f}; apart: the N-point kernel "
          f"{sums['kernel']:.4f} + the plain steps {sums['steps']:.4f}; "
          f"the traced cell run before the kernel did the steps: the kernel "
          f"{was['ct_fwd'] + was['ct_fwd_digits'] + was['ct_inv']:.4f} "
          f"(ct_fwd {was['ct_fwd']}, ct_fwd_digits {was['ct_fwd_digits']}, "
          f"ct_inv x 2 {was['ct_inv']}) + the steps {was['steps']}")


def time_transform_grids(card, dc, batch):
    """The four transforms of one mul+relin step on `batch` pairs, each
    through its wrapper on random operands, timed alone on the device
    (device_ms) and printed beside its grid (ntt_ct_cuda.launch_grid:
    tiles a prime, rows a block, waves of the card's resident blocks),
    the grid of ceil(slots / L) tiles a prime that sync_tiles replaced,
    and the device time over waves x rows a block: the time of a row of
    one block, if the grid holds the time."""
    import torch
    from fhe_si_tpu_torch.ops import ntt_ct_cuda
    meta = dc.ct_meta
    rng = np.random.default_rng(SEED)
    total = 0.0
    for name, basis, rows, _ in step_cases(dc, batch)[:4]:
        T, q = getattr(dc, basis)['ct'], getattr(dc, basis)['primes_np']
        L = len(q)
        if name == "ct_fwd_digits":
            x = rng.integers(0, 1 << dc.digit_bits, size=(rows, meta.phim))
            run = lambda x: ntt_ct_cuda.ct_fwd_digits(  # noqa: E731
                T, x, meta, dc.digit_bits)
        else:
            x = rng.integers(0, q[:, None], size=(rows, L, meta.phim))
            run = (lambda x: ntt_ct_cuda.ct_inv(T, x, meta, 't2i_crt')) \
                if name == "ct_inv" else \
                (lambda x: ntt_ct_cuda.ct_fwd(T, x, meta))
        x = torch.as_tensor(x.astype(np.int32), device=dc.device)
        tiles, per_tile, slots = ntt_ct_cuda.launch_grid(
            name, (rows, L, meta.N1, meta.N2, meta.phim, meta.q_odd),
            dc.device)
        waves = -(-L * tiles // slots)
        was, was_per = ntt_ct_cuda.tile_grid(rows, -(-slots // L))
        ms = device_ms(lambda: run(x))
        if ms is None:
            raise AssertionError(f"{name}: the host was slower than the spin")
        total += ms
        print(f"[{card}] {name} m={dc.ctx.m} {basis} [{rows}, {L}]: grid "
              f"{L} x {tiles} tiles of {per_tile} rows, {waves} wave(s) of "
              f"{slots} slots (the ceil grid: {L} x {was} of {was_per}, "
              f"{-(-L * was // slots)}); device {ms:.4f} ms, "
              f"{1e3 * ms / (waves * per_tile):.2f} us a row of a block")
        del x
    print(f"[{card}] m={dc.ctx.m} B={batch} step's transforms: device "
          f"{total:.4f} ms")


def _sync_transform(dc, name, T, x):
    """fsi_ct_sync: the transform `name` of x on the sync schedule,
    whatever schedule its split takes (the forward transforms' row
    [N2][N1], the inverse's [N1][N2] with t2i_crt), N wide."""
    import torch
    from fhe_si_tpu_torch.ops import cuda_build
    meta, L = dc.ct_meta, T['q'].shape[0]
    inv = name == "ct_inv"
    keys, S, R = ((('k_t1i', 'k_t2i_crt', 'k_twi', 'k_consts'), meta.N1,
                   meta.N2) if inv else
                  (('k_t2', 'k_t1', 'k_tw', 'k_consts'), meta.N2, meta.N1))
    out = torch.empty((x.shape[0], L, meta.N), dtype=torch.int32,
                      device=x.device)
    err = cuda_build.library("ct_ntt").fsi_ct_sync(
        int(name == "ct_fwd_digits"), x.data_ptr(),
        *(T[k].data_ptr() for k in keys), out.data_ptr(), x.shape[0], L, S,
        R, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"fsi_ct_sync: CUDA error {err}")
    return out


def time_rowsplit(card, dc, batch):
    """The four transforms of one mul+relin step on `batch` pairs at
    m = 2^15 (the wide cell's shapes at 64 pairs: [256, 23] forward,
    [192, 23] and [128, 13] inverse, [1920, 16384] digits -> 13), each
    through its wrapper, which runs the rowsplit schedule there, held
    equal to the sync schedule (fsi_ct_sync) and timed alone on the device
    (device_ms) in turns, sync, rowsplit, rowsplit, sync: ns a (row, prime)
    and the share of ntt_bound of each.  Returns {name: (rowsplit ms,
    sync ms)}, summed over the two inverses."""
    import torch
    from fhe_si_tpu_torch.ops import cuda_build, ntt_ct_cuda
    meta = dc.ct_meta
    if {ntt_ct_cuda.kernel_schedule(meta.N2, meta.N1),
            ntt_ct_cuda.kernel_schedule(meta.N1, meta.N2)} != {"rowsplit"}:
        raise AssertionError(f"m={dc.ctx.m}: not a split of the rowsplit "
                             "schedule")
    rng = np.random.default_rng(SEED)
    got = {}
    for name, basis, rows, _ in step_cases(dc, batch)[:4]:
        T, q = getattr(dc, basis)['ct'], getattr(dc, basis)['primes_np']
        L = len(q)
        if name == "ct_fwd_digits":
            x = rng.integers(0, 1 << dc.digit_bits, size=(rows, meta.phim))
            run = lambda x: ntt_ct_cuda.ct_fwd_digits(  # noqa: E731
                T, x, meta, dc.digit_bits)
        else:
            x = rng.integers(0, q[:, None], size=(rows, L, meta.phim))
            run = (lambda x: ntt_ct_cuda.ct_inv(T, x, meta, 't2i_crt')) \
                if name == "ct_inv" else \
                (lambda x: ntt_ct_cuda.ct_fwd(T, x, meta))
        x = torch.as_tensor(x.astype(np.int32), device=dc.device)
        cuda_build.reset_launches()
        if not torch.equal(run(x), _sync_transform(dc, name, T, x)):
            raise AssertionError(f"{name} m={dc.ctx.m} [{rows}, {L}]: "
                                 "rowsplit != sync")
        if cuda_build.SCHEDULES != {"pingpong": 0, "sync": 0, "rowsplit": 1}:
            raise AssertionError(f"{name}: schedules {cuda_build.SCHEDULES}")
        ms = {"sync": [], "rowsplit": []}
        for which in ("sync", "rowsplit", "rowsplit", "sync"):
            fn = (lambda: run(x)) if which == "rowsplit" else \
                (lambda: _sync_transform(dc, name, T, x))
            t = device_ms(fn, 10)
            if t is None:
                raise AssertionError(f"{name}: the host was slower than the "
                                     "spin")
            ms[which].append(t)
        bound, by = ntt_bound(name, rows, L, meta.phim, meta.N, meta.N1,
                              meta.N2)
        line = f"[{card}] {name} m={dc.ctx.m} {basis} [{rows}, {L}]:"
        for which in ("rowsplit", "sync"):
            lo, hi = min(ms[which]), max(ms[which])
            line += (f" {which} {lo:.4f}-{hi:.4f} ms, "
                     f"{1e6 * lo / (rows * L):.1f}-{1e6 * hi / (rows * L):.1f}"
                     f" ns a (row, prime), {100 * bound / hi:.1f}-"
                     f"{100 * bound / lo:.1f}% of {1e3 * bound:.1f} us ({by});")
        print(line.rstrip(";"))
        prev = got.get(name, (0.0, 0.0))
        got[name] = (prev[0] + sum(ms["rowsplit"]) / 2,
                     prev[1] + sum(ms["sync"]) / 2)
        del x
    total = [sum(v[i] for v in got.values()) for i in (0, 1)]
    print(f"[{card}] m={dc.ctx.m} B={batch} step's transforms, device ms: "
          f"rowsplit {total[0]:.4f}, sync {total[1]:.4f}")
    return got


def rowsplit_only(dev) -> int:
    """The rowsplit schedule alone: the build's ptxas lines of
    ct_mma_kernel (registers, spills; C75xx warnings of serialized
    wgmma), then time_rowsplit at the wide cell's 64 pairs."""
    from fhe_si_tpu_torch import DeviceContext, FheContext
    from fhe_si_tpu_torch.ops import cuda_build
    card = card_line()
    print(f"card: {card}")
    log = cuda_build.build()
    for line in ptxas_report(log):
        if "ct_mma_kernel" in line:
            print(f"ptxas {line}")
    for line in log.splitlines():
        if "C75" in line:   # ptxas serialized the wgmma of some kernel
            print(f"nvcc: {line.strip()}")
    dc = DeviceContext(FheContext(**M15), dev)
    time_rowsplit(card, dc, BATCH15_CELL)
    print(card_line())
    return 0


def phase_objects(dev, big_ctx, main_dc):
    """Phase 9: DoubleCrt at p = 4007, m = 4006; an npz round trip from
    the m = 8192 DeviceContext; the reference byte format at m = 22.
    Returns the kernel launches of the npz part, and the keys, reference
    context and ciphertexts of the reference-format part with an m = 8192
    ciphertext (phase 10e's inputs)."""
    import torch
    from fhe_si_tpu_torch import (DeviceContext, FheContext, refcompat,
                                  refserial, sampling, scheme,
                                  serialization as ser)
    from fhe_si_tpu_torch.doublecrt import DoubleCrt
    from fhe_si_tpu_torch.hostmath import numbth, oracle
    from fhe_si_tpu_torch.indexmap import IndexSet
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
    reset_launches()
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
    launches = launch_counts()
    print(f"npz round trip at m={ctx.m} on {dev}: context, keys and "
          f"ciphertexts equal after import, decrypts right; launches "
          f"{launches}")
    t0 = part("b (npz)")

    ct8192 = cts[0]

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
    return launches, dict(ref=ref, sk=sk, pk=pk, ksw=ksw, cts=cts,
                          ct8192=ct8192)


def free_ports(n: int) -> list[int]:
    """n distinct free TCP ports of localhost (all held while picking)."""
    import socket
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def trace_kernels(log_dir: str) -> list[tuple[str, str, float, float]]:
    """The card's kernels in the one torch.profiler trace of log_dir
    (profiling.device_trace): (kernel name, the innermost aten op that
    launched it or the kernel name when none did, start us, duration
    us).  A kernel is tied to its op through the trace's External id,
    on the kernel itself or on its launch (by correlation)."""
    files = [f for f in os.listdir(log_dir) if f.endswith(".pt.trace.json")]
    if len(files) != 1:
        raise AssertionError(f"{log_dir}: expected one trace, found {files}")
    with open(os.path.join(log_dir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    op_of, ext_of = {}, {}
    for e in events:
        args = e.get("args") or {}
        if e.get("cat") == "cpu_op" and "External id" in args:
            op_of[args["External id"]] = e["name"]
        elif e.get("cat") == "cuda_runtime" and "correlation" in args:
            ext_of[args["correlation"]] = args.get("External id")
    out = []
    for e in events:
        if e.get("cat") != "kernel" or "dur" not in e:
            continue
        args = e.get("args") or {}
        ext = args.get("External id") or ext_of.get(args.get("correlation"))
        out.append((e["name"], op_of.get(ext, e["name"]), float(e["ts"]),
                    float(e["dur"])))
    return out


def print_breakdown(card, label, kernels, steps=1, top=14):
    """Device time by launching op (the kernel name where no aten op
    launched it) over the traced window, per step when it held `steps`
    steps, and the device's busy share of the window."""
    if not kernels:
        raise AssertionError(f"{label}: the trace holds no CUDA kernel")
    by: dict = {}
    for _, op, _, dur in kernels:
        t, n = by.get(op, (0.0, 0))
        by[op] = (t + dur, n + 1)
    busy, end = 0.0, float("-inf")
    for *_, ts, dur in sorted(kernels, key=lambda k: k[2]):
        busy += max(0.0, ts + dur - max(ts, end))
        end = max(end, ts + dur)
    window = end - min(k[2] for k in kernels)
    per = " per step" if steps > 1 else ""
    print(f"[{card}] {label}: {len(kernels) / steps:.0f} kernels{per}, "
          f"device busy {busy / steps / 1e3:.3f} ms{per} of a "
          f"{window / steps / 1e3:.3f} ms window ({100 * busy / window:.1f}%)")
    total = sum(t for t, _ in by.values())
    for name, (t, n) in sorted(by.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"[{card}]   {t / steps / 1e3:8.3f} ms {100 * t / total:5.1f}% "
              f"x{n / steps:.0f}  {name[:100]}")
    return by


def coeff_step_bound(dc, batch: int) -> tuple[float, float]:
    """The float64 stage products of one coefficient-sharded mul+relin
    step of `batch` pairs on dc's ring (m = 2^k, every transform on the
    full chain, as parallel/shard.py runs them), counted from the shapes:
    per transformed row and prime 2 N (N1 + N2) operations, doubled in a
    stage whose table _stage splits.  Rows: 4 parts lifted, 3 tensored
    parts back, 2 x ndigits digit rows, 2 keyswitched parts back.
    Returns (GFLOP, FP64 bound in ms)."""
    from fhe_si_tpu_torch.ops import ntt, ntt_ct
    meta, L = dc.ct_meta, dc.ctx.num_primes
    N1, N2 = meta.N1, meta.N2

    def per_row(y_max):
        return 2 * meta.N * sum(
            n * (1 + ntt.needs_split(n, ntt_ct.Q_MAX + 1, y_max))
            for n in (N1, N2))
    flops = L * (batch * (4 + 3 + 2) * per_row(ntt_ct.Q_MAX)
                 + batch * 2 * dc.ndigits * per_row(
                     (1 << ntt_ct.MAX_DIGIT_BITS) - 1))
    return flops / 1e9, flops / F64_OPS_PER_S * 1e3


def run_worlds(dev, specs, timeout=400) -> dict:
    """Every rank of every world of `specs` (label, ranks, backend, extra
    arguments of fhe_si_tpu_torch.parallel.run_distributed) started at
    once on the card; each rank's line echoed; returns rank 0's JSON per
    label.  Any rank that fails fails the phase; no rank outlives it."""
    root = os.path.dirname(os.path.abspath(__file__))
    procs = []
    with tempfile.TemporaryDirectory() as tmp:
        try:
            for (label, world, backend, extra), port in zip(
                    specs, free_ports(len(specs))):
                for rank in range(world):
                    cmd = [sys.executable, "-m",
                           "fhe_si_tpu_torch.parallel.run_distributed",
                           str(rank), str(world), "--port", str(port),
                           "--m", str(MAIN["m"]), "--device", str(dev),
                           "--backend", backend, *extra]
                    if rank == 0:
                        cmd += ["--out", os.path.join(tmp, f"{label}.json")]
                    procs.append((label, rank, subprocess.Popen(
                        cmd, cwd=root, stdout=subprocess.PIPE,
                        stderr=subprocess.STDOUT, text=True)))
            deadline = time.monotonic() + timeout
            for label, rank, p in procs:
                log, _ = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
                if p.returncode:
                    raise AssertionError(f"world {label} rank {rank} exited "
                                         f"{p.returncode}:\n{log[-4000:]}")
                print(f"world {label}: " + next(
                    ln for ln in log.splitlines() if ln.startswith("rank ")))
        finally:
            for *_, p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        out = {}
        for label, *_ in specs:
            with open(os.path.join(tmp, f"{label}.json")) as f:
                out[label] = json.load(f)
    return out


def phase_sharded(dev, card, main_run, codec):
    """Phase 10: the sharded pipelines, the profiler and the native codec
    core.  Returns the kernel launches of the sharded path (10a)."""
    import torch
    import torch.distributed as dist
    from fhe_si_tpu_torch import DeviceContext, refcompat, refserial, scheme
    from fhe_si_tpu_torch.cli import test_regression
    from fhe_si_tpu_torch.cli.gen_data import generate
    from fhe_si_tpu_torch.hostmath import oracle
    from fhe_si_tpu_torch.parallel import (ShardedPipelines, make_mesh,
                                           shard_matrix)
    from fhe_si_tpu_torch.profiling import annotate, device_trace
    t0 = time.perf_counter()

    def part(name):
        print(f"phase 10{name} wall time: {time.perf_counter() - t0:.2f} s")
        return time.perf_counter()

    # a. NCCL, world size 1: ShardedPipelines (dp = 1, limb = 1) at the
    # main path's width, against the unsharded step
    dc, ksw, pairs, out, _, sk, msgs = main_run
    ctx = dc.ctx
    a = torch.stack([x.parts for x, _ in pairs])
    b = torch.stack([y.parts for _, y in pairs])
    ref = torch.stack([c.parts for c in out])
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", world_size=1, rank=0,
                            init_method=f"tcp://localhost:{free_ports(1)[0]}")
    try:
        mesh = make_mesh(1, 1, dev)
        sp = ShardedPipelines(ctx, mesh)
        # the shard contexts' own basis tables (their rows' slices): this
        # world's, and both halves of a limb = 2 world's (the first
        # without the redundant row)
        half = ctx.num_primes // 2
        for rows in (None, np.arange(half), np.arange(half, 2 * half)):
            shard = sp.local if rows is None else DeviceContext(ctx, dev, rows)
            check_basis_kernels(shard, f"limb shard rows {rows}", bases=("full",))
        mat = shard_matrix(mesh, ksw.matrix_evals)
        reset_launches()
        with transform_calls() as calls, \
                plain_calls(PLAIN_MODULAR, calls.plain_modular):
            got = sp.batched_mul_relin(a, b, mat)
            red = sp.mul_relin_block_reduce(a, b, mat)
            torch.cuda.synchronize()
        launches = launch_counts()
        check_launches("sharded path (NCCL, world 1)", launches,
                       tuple(KERNELS), calls)
        if not torch.equal(got, ref):
            raise AssertionError("sharded mul+relin != DeviceContext.mul_relin")
        dec = sk.decrypt_batch([scheme.Ciphertext(dc, parts=p) for p in got])
        want_sum = np.zeros(ctx.phim, dtype=np.int64)
        for i in range(len(pairs)):
            want = oracle.plaintext_mul(ctx, msgs[2 * i], msgs[2 * i + 1])
            if not np.array_equal(dec[i].message, want):
                raise AssertionError(f"sharded pair {i}: decrypt != product")
            want_sum = (want_sum + want) % ctx.p
        if not np.array_equal(sk.decrypt(scheme.Ciphertext(
                dc, parts=red)).message, want_sum):
            raise AssertionError("sharded block reduce: decrypt != the sum "
                                 "of the products")
        print(f"sharded path (NCCL, world 1) at m={ctx.m} B={len(pairs)}: "
              f"== DeviceContext.mul_relin bit for bit, {len(pairs)}/"
              f"{len(pairs)} decrypts == oracle.plaintext_mul, the block "
              "reduce decrypts to their sum")
        steps = {"unsharded": lambda: dc.mul_relin(a, b, ksw.matrix_evals),
                 "sharded": lambda: sp.batched_mul_relin(a, b, mat)}
        for fn in steps.values():
            fn()
            fn()
        ms = {k: [] for k in steps}
        for k in ("unsharded", "sharded", "sharded", "unsharded"):
            ms[k].append(cuda_ms(steps[k], 10))
        print(f"[{card}] mul+relin B={len(pairs)} m={ctx.m}, in turns: "
              f"unsharded {ms['unsharded'][0]:.3f} / {ms['unsharded'][1]:.3f}"
              f" ms/step, sharded (NCCL world 1, limb 1) {ms['sharded'][0]:.3f}"
              f" / {ms['sharded'][1]:.3f} ms/step")
    finally:
        dist.destroy_process_group()
    # the unsharded step by kernel name, from a torch.profiler trace
    with tempfile.TemporaryDirectory() as tdir:
        with device_trace(tdir):
            for _ in range(3):
                with annotate("mul_relin"):
                    steps["unsharded"]()
            torch.cuda.synchronize()
        kernels = trace_kernels(tdir)
        print_breakdown(card, f"mul+relin B={len(pairs)} m={ctx.m} step "
                        "(torch.profiler, 3 steps)", kernels, steps=3)
        n_cat = sum(op == "aten::cat" for _, op, *_ in kernels)
        print(f"[{card}] aten::cat per mul+relin step: {n_cat / 3:.0f} "
              "(torch.profiler, 3 steps)")
    t0 = part("a (NCCL world 1)")

    # b, c. worlds of run_distributed on the one card, all at once: a
    # single rank (NCCL), two ranks over gloo as limb = 2 and as dp = 2,
    # and two ranks as coeff = 2 (the coefficient path launches no kernel)
    worlds = run_worlds(dev, [
        ("single", 1, "nccl", ["--batch", str(BATCH)]),
        ("limb2", 2, "gloo", ["--batch", str(BATCH), "--n-limb", "2"]),
        ("dp2", 2, "gloo", ["--batch", str(BATCH)]),
        ("coeff2", 2, "gloo", ["--batch", "8", "--n-coeff", "2"])])
    one = worlds["single"]
    for label in ("limb2", "dp2"):
        w = worlds[label]
        if w["sha256"] != one["sha256"] or w["reduce_result"] != \
                one["reduce_result"]:
            raise AssertionError(f"world {label}: block reduce != single rank")
        if w["batched_sha256"] != one["batched_sha256"]:
            raise AssertionError(f"world {label}: batched output != single")
        # the m = 8192 step launches every kernel of KERNELS, and no
        # route boundary kernel (ROUTE_KERNELS)
        if any((n > 0) != (k in KERNELS) for k, n in w["launches"].items()):
            raise AssertionError(f"world {label}: launches {w['launches']}")
    for label, w in worlds.items():
        if w["batched_sha256"] != w["unsharded_sha256"]:
            raise AssertionError(f"world {label}: batched output != "
                                 "DeviceContext.mul_relin")
        print(f"[{card}] world {label} {w['mesh']} ({w['backend']}, B="
              f"{w['batch']}): step {w['step_s'] * 1e3:.3f} ms, first call "
              f"{w['first_call_s']:.3f} s, launches {w['launches']} (ranks "
              "share one card and run at once: not a scaling figure)")
    coeff = worlds["coeff2"]["launches"]
    if any(coeff[k] for k in NTT) or not all(coeff[k] for k in CRT + MODULAR):
        raise AssertionError(f"the coeff path launched {coeff}")
    print("worlds: limb = 2 and dp = 2 over gloo == the single rank (NCCL), "
          "block reduce and batched output; coeff = 2 == the unsharded "
          "step, no transform kernel launched there (plain transforms, as "
          "the JAX package's XLA einsums), both limb/CRT and both modular "
          "kernels on the rank's block")
    gflop, bound = coeff_step_bound(dc, 8)
    w = worlds["coeff2"]
    print(f"[{card}] coeff-sharded transforms of one B=8 step: {gflop:.3f} "
          f"GFLOP of float64 stage products, bound {bound:.4f} ms "
          f"(operations, FP64) against a {w['step_s'] * 1e3:.3f} ms step")
    t0 = part("b-c (worlds)")

    # d. Test_Regression --trace at phase 6's config
    with tempfile.TemporaryDirectory() as tmp:
        data, tdir = os.path.join(tmp, "data.txt"), os.path.join(tmp, "trace")
        generate(data, APP["dim"], APP["n"], seed=SEED)
        rc, text, err, _ = run_cli(
            dev, test_regression,
            ["chip_smoke", data, str(APP["p"]), str(APP["generator"]),
             str(SEED), f"--device={dev}", f"--m={APP['m']}", "--trace",
             tdir], "regression --trace", tuple(KERNELS))
        if rc != 0 or text.rstrip().splitlines()[-1] != "MATCH":
            raise AssertionError(f"regression --trace: no MATCH (rc {rc})\n"
                                 f"{err}")
        kernels = trace_kernels(tdir)
    if not any("ct_mma_kernel" in name for name, *_ in kernels):
        raise AssertionError("the --trace trace names no ct_mma_kernel")
    print_breakdown(card, f"regression phase m={APP['m']} (--trace)", kernels)
    t0 = part("d (--trace)")

    # e. the native codec core against the pure-Python path
    if not refserial.native_available():
        raise AssertionError("the native codec core did not build")
    parts8192 = codec["ct8192"].to_python_parts()
    ref = codec["ref"]
    cases = {
        "secret key": lambda: refcompat.export_secret_key(codec["sk"], ref),
        "public key": lambda: refcompat.export_public_key(codec["pk"], ref),
        "keyswitch": lambda: refcompat.export_keyswitch(codec["ksw"], ref),
        "ciphertexts m=22": lambda: [refcompat.export_ciphertext(c)
                                     for c in codec["cts"]],
        f"write ciphertext m={MAIN['m']}": lambda: refserial.write_ciphertext(
            parts8192),
    }
    buf8192 = refserial.write_ciphertext(parts8192)
    cases[f"read ciphertext m={MAIN['m']}"] = lambda: \
        refserial.read_ciphertext(buf8192)
    get_lib = refserial.native.get_lib
    for name, fn in cases.items():
        t1 = time.perf_counter()
        nat = fn()
        t_nat = time.perf_counter() - t1
        refserial.native.get_lib = lambda: None
        try:
            t1 = time.perf_counter()
            py = fn()
            t_py = time.perf_counter() - t1
        finally:
            refserial.native.get_lib = get_lib
        if nat != py:
            raise AssertionError(f"native codec: {name} differs from the "
                                 "pure-Python path")
        print(f"native codec == pure Python: {name}: {1e3 * t_nat:.3f} ms "
              f"native, {1e3 * t_py:.3f} ms Python (host)")
    if refserial.read_ciphertext(buf8192) != parts8192:
        raise AssertionError(f"native codec: m={MAIN['m']} ciphertext round "
                             "trip")
    part("e (native codec)")
    return launches


def _route_cpu(T):
    """A route operand dict (ntt_ct_matmul.stage_operands) on the CPU."""
    return {k: tuple(t.cpu() for t in v) if isinstance(v, tuple) else v.cpu()
            for k, v in T.items()}


def check_route(dc, lead_shapes):
    """The matmul route's transforms of every basis of dc on the card
    against the same functions on the CPU, on the same operands copied
    there, bit for bit: forward, raw and prescaled inverse and the digit
    transform (24-bit digits), then the round trip on the card."""
    import torch
    from fhe_si_tpu_torch.ops import ntt_ct_matmul as route
    ctx, meta = dc.ctx, dc.ct_meta
    label = f"m={ctx.m} logQ {ctx.log_q} {'wide' if ctx.wide else 'narrow'}"
    rng = np.random.default_rng(SEED)
    seen = set()
    for basis in ("full", "ksw", "lin"):
        T = getattr(dc, basis)
        if id(T) in seen:
            continue
        seen.add(id(T))
        tab, q_np = T['ct'], T['primes_np']
        tab_cpu = _route_cpu(tab)
        for lead in lead_shapes:
            x = rng.integers(0, q_np[:, None], size=lead + (
                len(q_np), meta.phim)).astype(np.int32)
            d = rng.integers(0, 1 << 24, size=lead + (meta.phim,)).astype(
                np.int32)
            xc, dcpu = torch.as_tensor(x), torch.as_tensor(d)
            xg, dg = xc.to(dc.device), dcpu.to(dc.device)
            ev = route.ct_fwd(tab, xg, meta)
            ev_cpu = route.ct_fwd(tab_cpu, xc, meta)
            same = [torch.equal(ev.cpu(), ev_cpu)]
            for key in ("t2i", "t2i_crt"):
                same.append(torch.equal(route.ct_inv(tab, ev, meta, key).cpu(),
                                        route.ct_inv(tab_cpu, ev_cpu, meta,
                                                     key)))
            same.append(torch.equal(
                route.ct_fwd_digits(tab, dg, meta, 24).cpu(),
                route.ct_fwd_digits(tab_cpu, dcpu, meta, 24)))
            same.append(torch.equal(route.ct_inv(tab, ev, meta), xg))
            if not all(same):
                raise AssertionError(f"matmul route {label} basis={basis} "
                                     f"lead={lead}: card != CPU "
                                     "(fwd, inv, inv_crt, digits, round "
                                     f"trip: {same})")
        del tab_cpu
        form = ("folded: route_enter, one GEMM, route_leave" if 'tw_t2' in tab
                else f"stages of {len(tab['t1'])} + {len(tab['t2'])} "
                f"matmul(s) (forward), {len(tab['t2_digits'])} for the digit "
                "stage")
        print(f"matmul route on the card == CPU: {label} basis={basis} "
              f"L={len(q_np)} N1xN2={meta.N1}x{meta.N2}, {form}")
    torch.cuda.synchronize()


def time_route(card, dev, cfg, batch):
    """The matmul route's folded form at the shapes of one mul+relin step
    of FheContext(cfg) on `batch` pairs (the four transforms of
    step_cases), on random operands and the ring's folded twiddles (the
    GEMM's tables random residues: its time does not depend on them).
    Each transform's route_enter and route_leave are held equal, bit for
    bit, to their plain versions (route_cuda.enter_plain, leave_plain) on
    CPU copies of the same operands, and MAX_ERR keeps the largest
    difference; then enter, the GEMM and leave are timed alone with CUDA
    events, three readings of 10 launches, the plain versions on the card
    in two, and the kernels' device time alone (device_ms).  Each beside
    its bound: route_boundary_bound for the kernels, the benchmark's
    route_bound (bench_port/roofline_route.py: the whole transform's, on
    N x 1 the GEMM's operations and one product an entry) for the GEMM.
    Returns ((GEMMs per step, ms per step, bound ms per step),
    {kernel: [(shape, kernel ms, plain ms, bound ms, bound_by, device ms),
    ...]} in step order)."""
    import torch
    from fhe_si_tpu_torch import FheContext
    from fhe_si_tpu_torch.ops import ntt_ct, route_cuda
    ctx = FheContext(**cfg)
    meta, ct = ntt_ct.ct_tables(ctx.m, ctx.primes, ctx.roots)
    N, phim = meta.N, meta.phim
    if meta.N2 != 1:
        raise AssertionError(f"m={ctx.m}: split {meta}, not N x 1")
    rng = np.random.default_rng(SEED)
    bases = {"full": np.arange(ctx.num_primes), "ksw": ctx.ksw_rows}
    steps = [("ct_fwd", "fwd", "full", 4 * batch),
             ("ct_inv", "inv", "full", 3 * batch),
             ("ct_inv", "inv", "ksw", 2 * batch),
             ("ct_fwd_digits", "fwd_digits", "ksw",
              3 * ctx.ndigits * batch)]
    rows_out = {k: [] for k in ROUTE_KERNELS}
    tot_ms = tot_bound = 0.0
    for name, mode, basis, rows in steps:
        q = ct['q'][bases[basis]].astype(np.int64)
        L = len(q)
        inv = mode == "inv"
        tw = ct['twi' if inv else 'tw'][bases[basis]][..., 0]
        one = ct['t2i' if inv else 't2'][bases[basis]][:, 0, 0]
        tab_cpu = torch.as_tensor(route_cuda.folded_table(tw, one, q))
        tab = tab_cpu.to(dev)
        q_cpu = torch.as_tensor(q.astype(np.int32)[:, None])
        qd = q_cpu.to(dev)
        if mode == "fwd_digits":
            x_cpu = rng.integers(0, 1 << 24, (rows, phim))
        else:
            x_cpu = rng.integers(0, q[:, None], (rows, L, phim))
        x_cpu = torch.as_tensor(x_cpu.astype(np.int32))
        x = x_cpu.to(dev)
        t1 = (torch.randint(0, int(q.min()), (L, N, N), device=dev)
              .to(torch.float64))
        leave_mode = "inv" if inv else "fwd"
        args = {"route_enter": (x, None if inv else tab, qd, meta, mode),
                "route_leave": (None, tab if inv else None, qd, meta,
                                leave_mode)}
        y = route_cuda.enter(*args["route_enter"])
        z = torch.matmul(t1, y.permute(1, 2, 0))
        args["route_leave"] = (z,) + args["route_leave"][1:]
        cpu = {"route_enter": (x_cpu, None if inv else tab_cpu, q_cpu, meta,
                               mode),
               "route_leave": (z.cpu(), tab_cpu if inv else None, q_cpu,
                               meta, leave_mode)}
        plain = {"route_enter": route_cuda.enter_plain,
                 "route_leave": route_cuda.leave_plain}
        wrapper = {"route_enter": route_cuda.enter,
                   "route_leave": route_cuda.leave}
        for k in ROUTE_KERNELS:
            got = wrapper[k](*args[k]).cpu()
            want = plain[k](*cpu[k])
            err = int((got.to(torch.float64) - want.to(torch.float64))
                      .abs().max())
            MAX_ERR[k] = max(MAX_ERR[k], err)
            if got.dtype != want.dtype or err:
                raise AssertionError(f"{k} of {name} {basis} "
                                     f"{tuple(args[k][0].shape)}: kernel != "
                                     f"plain (max abs err {err})")
        del cpu, got, want
        gemm_bound = route_bound(name, rows, L, phim, N, meta.N1, meta.N2)
        pieces = [
            ("route_enter", lambda: wrapper["route_enter"](
                *args["route_enter"])) + route_boundary_bound(
                "route_enter", mode, rows, L, phim, N),
            ("GEMM", lambda: torch.matmul(t1, y.permute(1, 2, 0)))
            + gemm_bound,
            ("route_leave", lambda: wrapper["route_leave"](
                *args["route_leave"])) + route_boundary_bound(
                "route_leave", mode, rows, L, phim, N)]
        for what, fn, bound, by in pieces:
            for _ in range(2):
                fn()
            readings = sorted(cuda_ms(fn, 10) for _ in range(3))
            ms = readings[1]
            line = (f"[{card}] matmul route {what} of {name} {basis} "
                    f"m={ctx.m} ({rows}, {L}, {phim}): {ms:.4f} ms "
                    f"(readings {', '.join(f'{r:.4f}' for r in readings)})")
            if what in ROUTE_KERNELS:
                p_ms = sorted(cuda_ms(lambda: plain[what](*args[what]), 10)
                              for _ in range(2))[0]
                d_ms = device_ms(fn)
                line += (f", plain {p_ms:.4f} ms, device " + (
                    "not measured (the host was slower than the spin)"
                    if d_ms is None else f"{d_ms:.4f} ms"))
                rows_out[what].append((tuple(args[what][0].shape), ms, p_ms,
                                       bound, by, d_ms))
            print(f"{line}, bound {bound * 1e3:.1f} us ({by}), share of "
                  f"bound {100 * bound / ms:.1f}%")
            tot_ms += ms
            tot_bound += bound
        del x, y, z, t1, args
        torch.cuda.empty_cache()
    print(f"[{card}] matmul route m={ctx.m} logQ {ctx.log_q} B={batch}: "
          f"{len(steps)} GEMMs per step, enter + GEMM + leave {tot_ms:.3f} "
          f"ms per step against a bound of {tot_bound:.3f} ms; boundary "
          f"kernels == plain, max abs err "
          f"{max(MAX_ERR[k] for k in ROUTE_KERNELS)}")
    return (len(steps), tot_ms, tot_bound), rows_out


def cli_child(dev, argv) -> int:
    """`chip_smoke.py --route-cli NAME ARGS...`: the port's CLI NAME run
    by run_cli on the matmul route (no kernel may launch), its output
    echoed.  Phase 11 runs Test_AddMul so, beside its other parts: its
    oracle products are minutes of host Python."""
    import importlib
    cli = importlib.import_module(f"fhe_si_tpu_torch.cli.{argv[0]}")
    rc, _, err, _ = run_cli(dev, cli, list(argv), argv[0], FOLDED,
                            route=True)
    sys.stderr.write(err)
    return rc


def phase_route(dev, card):
    """Phase 11: the rings on the matmul route (ops/ntt_ct_matmul.py).
    Returns the route's GEMMs and times per step at the route cell's
    shapes (time_route), the kernel launches of each path, keyed by path,
    and time_route's readings of the boundary kernels."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    import torch
    from fhe_si_tpu_torch import DeviceContext, FheContext
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)

    def part(name):
        print(f"phase 11{name} wall time: {time.perf_counter() - t0:.2f} s")
        return time.perf_counter()

    # c (started first). Test_AddMul 170 8147 3 --trials 10 in a process
    # of its own: ten trials of three dependent oracle products
    root = os.path.dirname(os.path.abspath(__file__))
    addmul = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--route-cli",
         "test_addmul", str(ROUTE["log_q"]), str(ROUTE["p"]),
         str(ROUTE["generator"]), "--trials", "10", f"--device={dev}"],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        with ProcessPoolExecutor(ORACLE_WORKERS, mp_context=multiprocessing
                                 .get_context("spawn")) as pool:
            # a. the route on the card against the CPU, p = 8147
            t1 = time.perf_counter()
            dc = DeviceContext(FheContext(**ROUTE), dev)
            print(f"route context {dc.ctx}: {time.perf_counter() - t1:.2f} s "
                  f"(host tables included), ct_route {dc.ct_route}")
            if dc.ct_route != "matmul" or dc.ct_meta.N2 != 1 or dc.wide:
                raise AssertionError(f"p={ROUTE['p']}: route {dc.ct_route}, "
                                     f"{dc.ct_meta}, wide={dc.wide}")
            if any(k.startswith("k_") for k in dc.full['ct']):
                raise AssertionError("p=8147: kernel tables were built")
            check_route(dc, ((RAGGED_ROWS,), (2, 3)))
            check_basis_kernels(dc, f"p={ROUTE['p']} m={ROUTE['m']} logQ="
                      f"{ROUTE['log_q']} route")
            t0 = part(f"a (p={ROUTE['p']})")

            # b. mul+relin at p = 8147, batch 64, the oracle on the pool
            label = f"p={ROUTE['p']} route path"
            run = lean_path(dev, ROUTE, BATCH, label, expect=FOLDED, dc=dc,
                            route=True, pool=pool)
            print(f"peak device memory (phase 11a-b): "
                  f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB")
            t0 = part(f"b (p={ROUTE['p']} mul+relin, {BATCH} pairs)")

            # d. m = 2^16: the route on the card against the CPU, then
            # mul+relin on 4 pairs
            dc16 = DeviceContext(FheContext(**M16), dev)
            print(f"route context {dc16.ctx}: ct_route {dc16.ct_route}")
            if dc16.ct_route != "matmul" or not dc16.wide:
                raise AssertionError(f"m={M16['m']}: route {dc16.ct_route}, "
                                     f"wide={dc16.wide}")
            check_route(dc16, ((3,),))
            check_basis_kernels(dc16, f"m={M16['m']} logQ={M16['log_q']} route", rows=3)
            launches = {"route_mul_relin": run.launches,
                        "route_mul_relin_m65536": lean_path(
                            dev, M16, BATCH16, f"m={M16['m']} route path",
                            expect=NO_TRANSFORM, dc=dc16,
                            route=True).launches}
            del dc16
            torch.cuda.empty_cache()
            t0 = part(f"d (m={M16['m']})")

        # c. Test_Statistics at p = 8147 (m = p - 1)
        launches.update(phase_apps(dev, card, ROUTE_APP, "narrow",
                                   f"_p{ROUTE['p']}", expect=FOLDED,
                                   route=True,
                                   names=("statistics",)))
        t0 = part("c (Test_Statistics)")
        log, _ = addmul.communicate(timeout=600)
    finally:
        if addmul.poll() is None:
            addmul.kill()
            addmul.wait()
    print(log, end="")
    if addmul.returncode or "\nAll tests SUCCEEDED!\n" not in log:
        raise AssertionError(f"Test_AddMul at p={ROUTE['p']} failed (rc "
                             f"{addmul.returncode})")
    t0 = part("c (Test_AddMul, waited for)")

    # b, timed: the step, its stages and the route's matmuls per step
    dc, ksw, pairs, out = run[:4]
    a, b, _, per_step = time_step(card, dc, pairs, ksw, out, label)
    time_stages(card, dc, a, b, ksw, label)
    time_kernels(card, dev, dc, step_cases(dc, BATCH, ntt=False), per_step)
    del run, dc, ksw, pairs, out, a, b
    torch.cuda.empty_cache()
    step, route_rows = time_route(card, dev, ROUTE_CELL, BATCH)
    part("b (timing)")
    return step, launches, route_rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; the port's "
              "kernels run only on a CUDA card", file=sys.stderr)
        return 1
    from fhe_si_tpu_torch import DeviceContext, FheContext
    from fhe_si_tpu_torch.ops import cuda_build, ntt_ct_cuda

    # 1. device
    dev = torch.device("cuda:0")
    if sys.argv[1:2] == ["--route-cli"]:
        return cli_child(dev, sys.argv[2:])
    if sys.argv[1:2] == ["--sass"]:
        for line in sass_report(sys.argv[2], sys.argv[3:]):
            print(line)
        return 0
    if sys.argv[1:2] == ["--steps"]:
        return steps_only(dev, sys.argv[2], int(sys.argv[3]))
    if sys.argv[1:2] == ["--rowsplit"]:
        return rowsplit_only(dev)
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    # 2. build
    t0 = time.perf_counter()
    log = cuda_build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc, sm_90a)")
    report = ptxas_report(log)
    if not report:
        raise AssertionError(f"no ptxas report in the build log:\n{log}")
    for line in report:
        print(f"ptxas {line}")
    for line in sass_report(str(cuda_build._so_path("crt")), MAIN_CRT_SASS):
        print(line)
    # DeviceContext picks the transform route on the host, against
    # ntt_ct_cuda.SMEM_MAX: the card must allow at least that much
    optin = ntt_ct_cuda._smem_limit(dev)
    print(f"shared memory per block (opt-in): {optin} bytes, the route "
          f"rule assumes {ntt_ct_cuda.SMEM_MAX}")
    if optin < ntt_ct_cuda.SMEM_MAX:
        raise AssertionError("the card allows less shared memory per block "
                             "than ntt_ct_cuda.kernel_takes assumes")

    # 3. kernels against their plain versions
    probe_semantics(dev)
    print("int32 wraparound, round-half-even, arithmetic >>, int32 sums, "
          "barrett: as on the CPU")
    phase_kernels(dev)

    # 4. the main path
    oracle_check_small(dev)
    main_run = lean_path(dev, MAIN, BATCH, "main path")
    dc, ksw, pairs, out, launches = main_run[:5]

    # 4b. the same path at m = 2^15
    t0 = time.perf_counter()
    dc15, ksw15, pairs15, out15, launches15 = lean_path(
        dev, M15, BATCH15, "m=32768 path")[:5]
    check_basis_kernels(dc15, f"m={M15['m']} logQ={M15['log_q']}", rows=5)
    check_twiddle_global(dc15, pairs15, ksw15, "m=32768 path", 1)
    check_twiddle_global(dc, pairs, ksw, "main path", 0)
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
        ("ct_fwd", "full", 14 * 4, None), ("ct_inv", "full", 14 * 3, None),
        ("ct_inv", "ksw", 20 * 2, None),
        ("ct_fwd_digits", "ksw", 20 * 2 * rdc.ndigits, None),
        ("crt_to_limbs", "full", 14 * 3, "round_down"),
        ("crt_to_limbs", "ksw", 20 * 2, "reduce_signed"),
        ("limbs_to_residues", "full", 14 * 4, None),
        ("tensor_product", "full", 14, None), ("keyswitch_dot", "ksw", 20, None),
        ("byte_decomp", "ksw", 20 * 2, None)])
    del rdc
    *_, per_step15 = time_step(card, dc15, pairs15, ksw15, out15,
                               "m=32768 path")
    m15_ms = time_kernels(card, dev, dc15, step_cases(dc15, BATCH15),
                          per_step15)
    time_transform_grids(card, dc15, BATCH15_CELL)
    time_rowsplit(card, dc15, BATCH15_CELL)
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
    npz_launches, codec_objects = phase_objects(dev, big_ctx, dc)
    print(f"phase 9 wall time: {time.perf_counter() - t0:.2f} s")

    # 10. the sharded pipelines, the profiler, the native codec core
    t0 = time.perf_counter()
    sharded_launches = phase_sharded(dev, card, main_run, codec_objects)
    print(f"phase 10 wall time: {time.perf_counter() - t0:.2f} s")

    # 11. the matmul route: the splits the kernel cannot take
    t0 = time.perf_counter()
    ((n_route, route_ms, route_bound_ms), route_launches,
     route_rows) = phase_route(dev, card)
    print(f"phase 11 wall time: {time.perf_counter() - t0:.2f} s")
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        by_path = dict(mul_relin=launches[name],
                       mul_relin_m32768=launches15[name],
                       mul_relin_m20480=mixed_launches[name],
                       npz_m8192=npz_launches[name],
                       mul_relin_sharded=sharded_launches[name],
                       **{path: n[name] for path, n in
                          (app_launches | dense_launches
                           | route_launches).items()})
        _, k_ms, p_ms, b_ms, b_by, d_ms = narrow_ms[name][0]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(by_path.values()), launches_by_path=by_path,
            max_abs_err=MAX_ERR[name], ms=k_ms, plain_ms=p_ms,
            bound_ms=b_ms, bound_by=b_by, device_ms=d_ms,
            # no PyTorch call computes a transform mod q, a CRT
            # reconstruction into limbs, a lift of limbs to residues, a
            # modular product or dot, or ByteDecomp's digits
            library_ms=None,
            wide_ms=wide_ms[name][0][1], wide_plain_ms=wide_ms[name][0][2],
            m32768_ms=m15_ms[name][0][1], m32768_plain_ms=m15_ms[name][0][2],
            m32768_bound_ms=m15_ms[name][0][3],
            m20480_ms=mixed_ms[name][0][1], m20480_plain_ms=mixed_ms[name][0][2],
            m20480_bound_ms=mixed_ms[name][0][3]))
    # the matmul route's boundary kernels: the forward's shapes of the route
    # cell's step lead, every transform's in route_cell; no other timed
    # path runs them
    for name in ROUTE_KERNELS:
        by_path = dict(mul_relin=launches[name],
                       mul_relin_m32768=launches15[name],
                       mul_relin_m20480=mixed_launches[name],
                       npz_m8192=npz_launches[name],
                       mul_relin_sharded=sharded_launches[name],
                       **{path: n[name] for path, n in
                          (app_launches | dense_launches
                           | route_launches).items()})
        _, k_ms, p_ms, b_ms, b_by, d_ms = route_rows[name][0]
        kernels.append(dict(
            name=name, route="cuda", source="fhe_si_tpu_torch/csrc/route.cu",
            replaces=ROUTE_REPLACES[name],
            launches=sum(by_path.values()), launches_by_path=by_path,
            max_abs_err=MAX_ERR[name], ms=k_ms, plain_ms=p_ms,
            bound_ms=b_ms, bound_by=b_by, device_ms=d_ms,
            bound_by_config=f"m={ROUTE_CELL['m']} logQ "
            f"{ROUTE_CELL['log_q']} B={BATCH}",
            route_cell=[dict(shape=list(shape), ms=k, plain_ms=p, bound_ms=b,
                             device_ms=d)
                        for shape, k, p, b, _, d in route_rows[name]],
            # no PyTorch call reduces a float64 GEMM's output mod q with a
            # twiddle and the phim <-> N steps, nor builds its operand so
            library_ms=None, wide_ms=None, wide_plain_ms=None,
            m32768_ms=None, m32768_plain_ms=None, m32768_bound_ms=None,
            m20480_ms=None, m20480_plain_ms=None, m20480_bound_ms=None))

    # not a kernel of the port: the XLA einsum of the JAX package
    # (fhe_si_tpu/ops/ntt.py modmatmul) is plain float64 torch.matmul here
    print(json.dumps({"dense_transform": dict(
        source="fhe_si_tpu_torch/ops/ntt.py", calls_per_step=n_dense,
        ms_per_step=dense_ms, bound_ms_per_step=dense_bound,
        bound_by_config=f"m={BIG['m']} B={BATCH}")}))
    # nor is the matmul route: the XLA stage products of the JAX package
    # (fhe_si_tpu/ops/ntt_ct.py ct_fwd, ct_fwd_digits, ct_inv) as float64
    # torch.matmul, on the splits the tensor-core kernel cannot take (on
    # N x 1, one a transform between the kernels of csrc/route.cu)
    print(json.dumps({"matmul_route": dict(
        source="fhe_si_tpu_torch/ops/ntt_ct_matmul.py",
        replaces="fhe_si_tpu/ops/ntt_ct.py:327-380 (XLA, not Pallas)",
        matmuls_per_step=n_route, ms_per_step=route_ms,
        bound_ms_per_step=route_bound_ms, library="torch.matmul",
        bound_by_config=f"m={ROUTE_CELL['m']} logQ {ROUTE_CELL['log_q']} "
        f"B={BATCH}")}))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
