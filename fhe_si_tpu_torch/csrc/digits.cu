// The digit split of mul+relin's keyswitch, written for Hopper (sm_90a):
// ByteDecomp's digits, read once from the limbs and written once in the
// layout the digits' forward transform reads.  Wrapper: ops/digits_cuda.py.
//
// Not a Pallas kernel in the JAX package: there the same jnp code runs
// fused by XLA.
//
//   byte_decomp_kernel<NW, false> <- fhe_si_tpu/ops/limbs.py:236 byte_decomp and the
//                                    digits' moveaxis/reshape of fhe_si_tpu/device.py:628
//                                    _digit_evals (fhe_si_tpu_torch/ops/limbs.py
//                                    byte_decomp, device.py _digit_evals)
//   byte_decomp_kernel<NW, true>  <- the same, then the dense ring's residues of every
//                                    digit (fhe_si_tpu/device.py:659, modular.barrett;
//                                    in the port digs[..., None, :] % q)
//
// ---- What it computes, per coefficient x of a row r ----
// parts[r, x, k], k < n: 16-bit limbs in [0, 2^16) of a two's complement
// value v mod 2^16n.  u = v mod 2^logQ, the positive representative
// (limbs.py reduce_mod_q(positive=True): the low logQ bits), needs
// 16 n >= logQ.  Digit j < nd is bits [b j, b j + b) of u, b = digit_bits
// <= 24 (Ciphertext.cpp:82-121); bits at or above logQ read as 0.
//   out[r nd + j, x]        = digit j                  (no prime table)
//   out[r nd + j, l, x]     = digit j mod q_l, l < Lk  (a table of Lk primes)
// Row r nd + j is part r's digit j: [R, nd, phim] read as [R nd, phim], the
// layout ct_fwd_digits reads.
//
// ---- Exactness ----
// * Words: w_k = limb_2k | limb_2k+1 << 16 (PRMT of the two low halves),
//   masked at logQ: the NW words hold u.  Digit j = (u >> b j) & (2^b - 1):
//   the words shifted down by b, j times (a funnel shift of each word with
//   the next, b < 32), then their low b bits.
// * d mod q for d < 2^24 and q in [2, 2^31): with r = floor(2^32 / q),
//   qhat = umulhi(d, r) is floor(d / q) or one less, so d - qhat q lies in
//   [0, 2q) and one conditional subtraction makes it canonical.
//
// ---- What bounds it on the H100, and the design ----
// Main path (m = 8192, batch 512, logQ 80, n = 6, 4 digits of 24 bits):
// [1536, 4096, 6] int32 in (151.0 MB), [6144, 4096] out (100.7 MB), 75 us
// at 3.35 TB/s, against some 40 integer operations a coefficient: bound by
// bytes.  The dense ring at batch 64 (logQ 170, n = 11, 8 digits, Lk = 12):
// 16.9 MB in, 147.6 MB of residues out, 49 us.  Eager PyTorch took 21
// launches there (38 on the dense ring), each reading the limbs at a stride
// of n words or writing a [.., nd] plane to transpose later.
// * A block per tile of kTile coefficients of one row: the tile's n kTile
//   words are contiguous in device memory, so they are copied to shared
//   memory as 16-byte cp.async vectors (the ragged words at the two ends one
//   by one), coalesced whatever n (24 or 44 bytes a coefficient is not a
//   multiple of 16).
// * A thread per coefficient (kPer a thread): its limbs read from the tile
//   (threads n words apart: gcd(n, 32)-way bank conflicts, 2 at n = 6, none
//   at odd n) and packed into NW 32-bit words.  NW is a template parameter,
//   so the words live in registers and every index is a constant: a limb
//   array indexed by a loop variable lives in local memory.  Digit j is the
//   low digit_bits bits of the words; then every word moves down by
//   digit_bits, a funnel shift each, so no index depends on j (a select of a
//   digit's two words by j compiles to an indexed array in local memory).
// * Stores: for each digit row (and prime) a warp writes 32 consecutive
//   words, 128 coalesced bytes whatever phim's alignment (the dense ring's
//   rows of phim = 2002 words do not start at 16-byte boundaries); a
//   thread's kPer stores of one row go together, so a block writes its
//   tile's stretch of each row at once.
// On one H100 (700 W), device time per call: 86 us at b512 (87% of the
// bound); 90 us on the dense ring, where the same shape at phim = 2048 took
// 59 us: the 2002-word rows leave a partial 32-byte sector at both ends of
// every warp's store.  One, two or four coefficients a thread time alike.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 2;                   // coefficients a thread
constexpr int kTile = kPer * kThreads;    // coefficients a tile
constexpr int kMaxLimbs = 48;             // as crt.cu: the widest reconstruction
constexpr int kMaxPrimes = 64;            // as crt.cu kMaxRows
constexpr int kMaxWords = 24;             // logQ <= 16 * kMaxLimbs
constexpr int kTableWords = 2 * kMaxPrimes;  // q_l, floor(2^32 / q_l)
constexpr int kMaxSmem = 4 * (kTableWords + 4 + kTile * kMaxLimbs);

__host__ __device__ constexpr int smem_bytes(int n) {
  return 4 * (kTableWords + 4 + kTile * n);
}

// The words of a tile sit at tile[pad + i], pad being the offset of the
// tile's first word in device memory within its 16 bytes, so that tile and
// device memory line up in 16-byte vectors (crt.cu word_pad).
__device__ __forceinline__ int word_pad(const void* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

__device__ __forceinline__ void cp_async16(uint32_t* dst, const uint32_t* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// tile[pad + i] = src[i], i < count: whole vectors as 16-byte cp.async,
// the words of the two partial vectors at the ends one by one
__device__ __forceinline__ void load_tile(uint32_t* tile, const int32_t* src, int pad,
                                          int count) {
  const uint32_t* base = reinterpret_cast<const uint32_t*>(src) - pad;
  const int end = pad + count;
  for (int v = threadIdx.x; 4 * v < end; v += kThreads) {
    const int w = 4 * v;
    if (w >= pad && w + 4 <= end) {
      cp_async16(tile + w, base + w);
    } else {
      for (int e = 0; e < 4; ++e)
        if (w + e >= pad && w + e < end) tile[w + e] = __ldg(base + w + e);
    }
  }
  cp_async_wait_all();
}

// parts [R, phim, n] -> out [R nd, phim] (kPerPrime false) or
// [R nd, Lk, phim] (true, primes [Lk]).  NW >= ceil(logQ / 32).  Grid: one
// block per tile, R ceil(phim / kTile) of them.
template <int NW, bool kPerPrime>
__global__ void __launch_bounds__(kThreads)
    byte_decomp_kernel(const int32_t* __restrict__ parts, const int32_t* __restrict__ primes,
                       int32_t* __restrict__ out, int phim, int n, int log_q, int digit_bits,
                       int nd, int lk) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* qs = smem;                   // [kMaxPrimes]: q_l
  uint32_t* rs = smem + kMaxPrimes;      // [kMaxPrimes]: floor(2^32 / q_l)
  uint32_t* tile = smem + kTableWords;   // [pad + kTile n]
  if (kPerPrime) {
    for (int l = static_cast<int>(threadIdx.x); l < lk; l += kThreads) {
      const uint32_t q = static_cast<uint32_t>(primes[l]);
      qs[l] = q;
      rs[l] = static_cast<uint32_t>((1ull << 32) / q);
    }
  }
  const int t = threadIdx.x;
  const int tiles_x = (phim + kTile - 1) / kTile;
  const int r = blockIdx.x / tiles_x;
  const int x0 = (blockIdx.x - r * tiles_x) * kTile;
  const int cnt = min(kTile, phim - x0);
  const int32_t* src = parts + (static_cast<long long>(r) * phim + x0) * n;
  const int pad = word_pad(src);
  load_tile(tile, src, pad, cnt * n);
  __syncthreads();

  uint32_t keep[NW];  // word k's bits below logQ
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    const int lo = 32 * k;
    keep[k] = log_q >= lo + 32 ? 0xFFFFFFFFu
                               : (log_q <= lo ? 0u : (1u << (log_q - lo)) - 1u);
  }
  const int nl = min(n, 2 * NW);  // the limbs that reach a word
  uint32_t w[kPer][NW];           // coefficient t + h kThreads
#pragma unroll
  for (int h = 0; h < kPer; ++h) {
    // a thread past the tile's end reads its last coefficient and stores nothing
    const uint32_t* lp = tile + pad + min(t + h * kThreads, cnt - 1) * n;
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      const uint32_t lo = 2 * k < nl ? lp[2 * k] : 0u;
      const uint32_t hi = 2 * k + 1 < nl ? lp[2 * k + 1] : 0u;
      w[h][k] = __byte_perm(lo, hi, 0x5410) & keep[k];
    }
  }
  const uint32_t dmask = (1u << digit_bits) - 1u;
  int32_t* dst = out + static_cast<long long>(r) * nd * (kPerPrime ? lk : 1) * phim + x0 + t;
  for (int j = 0; j < nd; ++j) {
    // digit j is the low digit_bits bits; then the words move down by as many
    uint32_t d[kPer];
#pragma unroll
    for (int h = 0; h < kPer; ++h) {
      d[h] = w[h][0] & dmask;
#pragma unroll
      for (int k = 0; k < NW; ++k)
        w[h][k] = k + 1 < NW ? __funnelshift_r(w[h][k], w[h][k + 1], digit_bits)
                             : w[h][k] >> digit_bits;
    }
    if (kPerPrime) {
      for (int l = 0; l < lk; ++l) {
        const uint32_t q = qs[l], rq = rs[l];
#pragma unroll
        for (int h = 0; h < kPer; ++h) {
          uint32_t v = d[h] - __umulhi(d[h], rq) * q;
          v = v >= q ? v - q : v;
          if (t + h * kThreads < cnt) dst[h * kThreads] = static_cast<int32_t>(v);
        }
        dst += phim;
      }
    } else {
#pragma unroll
      for (int h = 0; h < kPer; ++h)
        if (t + h * kThreads < cnt) dst[h * kThreads] = static_cast<int32_t>(d[h]);
      dst += phim;
    }
  }
}

// f(std::integral_constant<int, NW>()) for the smallest bucket NW >= nw
// (1 <= nw <= kMaxWords): every count up to 8, then 12, 16 and 24
template <typename F>
void with_words(int nw, F&& f) {
#define FSI_WORDS(k)                     \
  case k:                                \
    f(std::integral_constant<int, k>()); \
    break;
  switch (nw) {
    FSI_WORDS(1) FSI_WORDS(2) FSI_WORDS(3) FSI_WORDS(4)
    FSI_WORDS(5) FSI_WORDS(6) FSI_WORDS(7) FSI_WORDS(8)
    case 9: case 10: case 11: FSI_WORDS(12)
    case 13: case 14: case 15: FSI_WORDS(16)
    default: f(std::integral_constant<int, kMaxWords>());
  }
#undef FSI_WORDS
}

// The first launch of a kernel lets it take up to kMaxSmem of shared memory.
template <auto kKernel>
cudaError_t allow_smem() {
  static const cudaError_t err =
      cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  return err;
}

template <bool kPerPrime>
cudaError_t launch(const void* parts, const void* primes, void* out, int R, int phim, int n,
                   int log_q, int digit_bits, int nd, int lk, void* stream) {
  cudaError_t err = cudaSuccess;
  with_words((log_q + 31) / 32, [&](auto c) {
    constexpr int NW = decltype(c)::value;
    err = allow_smem<byte_decomp_kernel<NW, kPerPrime>>();
    if (err != cudaSuccess) return;
    const int tiles = R * ((phim + kTile - 1) / kTile);
    byte_decomp_kernel<NW, kPerPrime>
        <<<tiles, kThreads, smem_bytes(n), static_cast<cudaStream_t>(stream)>>>(
            static_cast<const int32_t*>(parts), static_cast<const int32_t*>(primes),
            static_cast<int32_t*>(out), phim, n, log_q, digit_bits, nd, lk);
  });
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

extern "C" {

// parts [R, phim, n] (contiguous, 16 n >= log_q, R phim < 2^31) -> out
// [R nd, phim] digits of digit_bits <= 24 bits, or, with lk >= 1 primes
// [lk] (each in [2, 2^31)), out [R nd, lk, phim] of their residues.
// lk = 0: no prime table (primes may be null).
int fsi_byte_decomp(const void* parts, const void* primes, void* out, int R, int phim, int n,
                    int log_q, int digit_bits, int nd, int lk, void* stream) {
  if (R < 0 || phim < 1 || n < 1 || n > kMaxLimbs || log_q < 1 || 16 * n < log_q ||
      digit_bits < 1 || digit_bits > 24 || nd < 1 || lk < 0 || lk > kMaxPrimes ||
      (lk > 0 && primes == nullptr) || static_cast<long long>(R) * phim >= (1ll << 31))
    return cudaErrorInvalidValue;
  if (R == 0) return cudaSuccess;
  return lk ? launch<true>(parts, primes, out, R, phim, n, log_q, digit_bits, nd, lk, stream)
            : launch<false>(parts, primes, out, R, phim, n, log_q, digit_bits, nd, lk, stream);
}

}  // extern "C"
