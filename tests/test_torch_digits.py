"""ops/digits_cuda.py on the CPU: the plain version of the digit split
(what a CPU tensor takes, and what the card's kernel is held to in
tests/test_torch_cuda.py) against the exact Python-integer ByteDecomp of
hostmath/oracle.py, over the shapes and parameters the kernel takes; a
numpy model of csrc/digits.cu's arithmetic (its words, register bucket,
select, funnel shift and reduction by floor(2^32 / q)) against the plain
version; a CPU tensor never counts a launch."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fhe_si_tpu_torch.hostmath import oracle
from fhe_si_tpu_torch.ops import cuda_build, digits_cuda

SEED = 2_718_281_828
NARROW = [786433, 1032193, 974849, 737281]      # primes below 2^20
WIDE = [8257537, 7340033, 6684673, 5767169]     # below 2^23
# (log_q, decompSize, limbs n): logQ a multiple of 16 or not, n the
# ciphertext width (logQ + 16) // 16 or wider (automorph outputs reach the
# keyswitch unreduced at the reconstruction width)
PARAMS = [pytest.param(80, 3, 6, id="q80-d3-n6"),
          pytest.param(80, 2, 6, id="q80-d2-n6"),
          pytest.param(80, 1, 6, id="q80-d1-n6"),
          pytest.param(80, 3, 17, id="q80-d3-wide17"),
          pytest.param(77, 3, 5, id="q77-d3-n5"),
          pytest.param(77, 1, 9, id="q77-d1-wide9"),
          pytest.param(170, 3, 11, id="q170-d3-n11"),
          pytest.param(170, 2, 11, id="q170-d2-n11"),
          pytest.param(176, 3, 12, id="q176-d3-n12"),
          pytest.param(213, 3, 14, id="q213-d3-n14")]
LEADS = [pytest.param((), id="lead0"), pytest.param((3,), id="lead1"),
         pytest.param((2, 2), id="lead2")]
PHIM = 37


def _limbs(rng, lead, n):
    """Random 16-bit limbs [*lead, PHIM, n]: every bit above logQ set at
    random, and the all-ones and all-zeros coefficients."""
    x = rng.integers(0, 1 << 16, size=lead + (PHIM, n))
    x[..., 0, :] = (1 << 16) - 1
    x[..., 1, :] = 0
    return torch.as_tensor(x.astype(np.int32))


def _oracle(x, log_q, decomp, primes=None):
    """oracle.byte_decomp of every row of x [..., phim, n] (as parts of one
    ciphertext), as [..., nd, phim] (or [..., nd, Lk, phim])."""
    nd = -(-log_q // (8 * decomp))
    ctx = SimpleNamespace(ndigits=nd, digit_bits=8 * decomp, log_q=log_q)
    rows = x.reshape(-1, *x.shape[-2:]).tolist()
    parts = [[sum(limb << (16 * k) for k, limb in enumerate(c)) for c in row]
             for row in rows]
    digs = oracle.byte_decomp(oracle.OracleCiphertext(ctx, parts=parts)).parts
    want = np.array(digs, dtype=np.int64).reshape(
        x.shape[:-2] + (nd, x.shape[-2]))
    if primes is not None:
        want = want[..., None, :] % np.array(primes)[:, None]
    return want


@pytest.mark.parametrize("lead", LEADS)
@pytest.mark.parametrize("log_q, decomp, n", PARAMS)
def test_plain_equals_oracle(log_q, decomp, n, lead):
    rng = np.random.default_rng([SEED, log_q, decomp, n, len(lead)])
    x = _limbs(rng, lead, n)
    nd = -(-log_q // (8 * decomp))
    got = digits_cuda.byte_decomp(x, log_q, 8 * decomp, nd)
    assert got.dtype == torch.int32 and got.is_contiguous()
    assert got.shape == lead + (nd, PHIM)
    np.testing.assert_array_equal(got.numpy(), _oracle(x, log_q, decomp))


@pytest.mark.parametrize("primes", [pytest.param(NARROW, id="narrow"),
                                    pytest.param(WIDE, id="wide")])
@pytest.mark.parametrize("log_q, decomp, n", [
    pytest.param(170, 3, 11, id="q170-d3-n11"),
    pytest.param(77, 2, 9, id="q77-d2-wide9"),
    pytest.param(80, 1, 6, id="q80-d1-n6")])
def test_plain_residues_equal_oracle(log_q, decomp, n, primes):
    """The dense ring's output: each digit modulo each prime, the primes
    as DeviceContext's basis holds them ([Lk, 1])."""
    rng = np.random.default_rng([SEED, log_q, decomp, n, primes[0]])
    x = _limbs(rng, (2,), n)
    nd = -(-log_q // (8 * decomp))
    q = torch.tensor(primes, dtype=torch.int32)[:, None]
    got = digits_cuda.byte_decomp(x, log_q, 8 * decomp, nd, q)
    assert got.shape == (2, nd, len(primes), PHIM)
    np.testing.assert_array_equal(got.numpy(),
                                  _oracle(x, log_q, decomp, primes))


def _kernel_model(x, log_q, digit_bits, nd, primes=None):
    """byte_decomp_kernel's arithmetic in numpy uint32/uint64: limbs ->
    NW words (NW the kernel's bucket of ceil(logQ / 32)), masked at logQ;
    digit j the low bits of the words after j funnel shifts of them all
    down by digit_bits; a residue as d - umulhi(d, floor(2^32 / q)) q,
    less q once."""
    need = -(-log_q // 32)
    nw = need if need <= 8 else next(b for b in (12, 16, 24) if b >= need)
    limbs = x.numpy().astype(np.uint32)
    n = limbs.shape[-1]
    w = []
    for k in range(nw):
        lo = limbs[..., 2 * k] if 2 * k < min(n, 2 * nw) else 0
        hi = limbs[..., 2 * k + 1] if 2 * k + 1 < min(n, 2 * nw) else 0
        keep = (0xFFFFFFFF if log_q >= 32 * k + 32 else 0
                if log_q <= 32 * k else (1 << (log_q - 32 * k)) - 1)
        w.append((np.uint32(lo) & 0xFFFF | (np.uint32(hi) & 0xFFFF) << 16)
                 & np.uint32(keep) | np.zeros(limbs.shape[:-1], np.uint32))
    b = np.uint32(digit_bits)
    digits = []
    for _ in range(nd):
        digits.append(w[0] & np.uint32((1 << digit_bits) - 1))
        w = [(w[k] >> b) | (w[k + 1] << np.uint32(32 - digit_bits))
             for k in range(nw - 1)] + [w[-1] >> b]
    d = np.stack(digits, axis=-2)                    # [..., nd, phim]
    if primes is None:
        return d
    q = np.array(primes, np.uint64)[:, None]
    d = d[..., None, :].astype(np.uint64)           # [..., nd, 1, phim]
    v = d - ((d * (np.uint64(1 << 32) // q)) >> np.uint64(32)) * q
    assert (v < 2 * q).all()
    return np.where(v >= q, v - q, v)


@pytest.mark.parametrize("log_q, decomp, n", PARAMS + [
    pytest.param(300, 1, 19, id="q300-d1-n19"),
    pytest.param(760, 3, 48, id="q760-d3-n48")])
def test_kernel_model_equals_plain(log_q, decomp, n):
    """The kernel's arithmetic, modelled in numpy, equals the plain
    version at every register bucket the tested logQs reach (3, 6, 7,
    12 and 24 words), alone and with both lanes' residues."""
    rng = np.random.default_rng([SEED, 1, log_q, decomp, n])
    x = _limbs(rng, (2,), n)
    nd = -(-log_q // (8 * decomp))
    np.testing.assert_array_equal(
        _kernel_model(x, log_q, 8 * decomp, nd),
        digits_cuda.byte_decomp_plain(x, log_q, 8 * decomp, nd).numpy())
    for primes in (NARROW, WIDE):
        q = torch.tensor(primes, dtype=torch.int32)
        np.testing.assert_array_equal(
            _kernel_model(x, log_q, 8 * decomp, nd, primes),
            digits_cuda.byte_decomp_plain(x, log_q, 8 * decomp, nd,
                                          q).numpy())


def test_cpu_tensor_counts_no_launch():
    """A CPU tensor takes the plain version: no library is loaded and no
    launch counted; the span is entered once a call."""
    from fhe_si_tpu_torch import profiling
    cuda_build.reset_launches()
    x = _limbs(np.random.default_rng(SEED), (2,), 6)
    with profiling.counting() as table:
        digits_cuda.byte_decomp(x, 80, 24, 4)
        digits_cuda.byte_decomp(x, 80, 24, 4, torch.tensor(NARROW,
                                                           dtype=torch.int32))
    assert cuda_build.LAUNCHES["byte_decomp"] == 0
    assert table["fhe.byte_decomp"][0] == 2
