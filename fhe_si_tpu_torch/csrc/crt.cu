// The limb <-> residue conversions of the device pipelines, written for
// Hopper (sm_90a): the single-pass CRT reconstruction with its limb tails,
// and the lift of limbs to residues.  Wrappers: ops/crt_cuda.py.
//
// Neither is a Pallas kernel in the JAX package: there the same jnp code
// runs fused by XLA.  Run eagerly by PyTorch it is one launch per tensor
// op, and every intermediate [R, L, phim, n] plane goes through device
// memory.  Here each is one launch that keeps a coefficient's multi-limb
// integer in registers.
//
//   crt_kernel<kPartials>  <- fhe_si_tpu/ops/crt.py:90 crt_partials
//                             (fhe_si_tpu_torch/ops/crt.py crt_partials)
//   crt_kernel<kFinish>    <- fhe_si_tpu/ops/crt.py:213 crt_finish + limbs.py:21 normalize
//                             (fhe_si_tpu_torch/ops/crt.py crt_finish)
//   crt_kernel<kToLimbs>   <- fhe_si_tpu/ops/crt.py:234 residues_to_limbs_fast
//                             (fhe_si_tpu_torch/ops/crt.py residues_to_limbs_fast)
//     with tail kRoundDown:    + the limb tail of fhe_si_tpu/device.py:617 _scale_down
//                             (shift_left 1, + 2^logQ, arith_shift_right logQ + 1,
//                              limbs.py:54 reduce_mod_q signed at n_ct)
//     with tail kReduceSigned: + limbs.py:54 reduce_mod_q signed at n_ct, the
//                             keyswitch output of fhe_si_tpu/device.py:685
//                             _keyswitch_digits
//   lift_kernel            <- fhe_si_tpu/ops/crt.py:38 limbs_to_residues
//                             (fhe_si_tpu_torch/ops/crt.py limbs_to_residues)
//
// ---- crt_kernel: what it computes, per coefficient x of a row r ----
// Input res[r, l, x], l < rows: residues prescaled by the basis' CRT
// factor (the inverse transform folds b_l^-1 in), the redundant modulus
// m_r's row last.  With the basis tables (ops/crt_cuda.py kernel_table):
//   acc[k]  = sum_l (cl*B[l,k] & M) + (ch*Bh[l,k] & M)
//             + sum_l (cl*B[l,k-1] >> 16) + (ch*Bh[l,k-1] >> 16)    (k >= 1)
//             with cl = c & 1023, ch = c >> 10, c = res[r, l, x], M = 2^16 - 1
//   sig_raw = sum_l (c * Bmodr[l] mod m_r),   er = sum_l er_mask[l] * c
// (kPartials writes these three, the partial-limb form that the 'limb'
// shards all-reduce; the top limb's carry is dropped, as ops/limbs.py
// _shift_up drops it.)  Then
//   w   = ((sig_raw mod m_r) - er mod m_r) * P^-1 mod m_r
//   acc[k] -= (w*P)'s partial limbs, normalize (carry chain, mod 2^16n)
// the centred value E as n two's complement 16-bit limbs.  The tails
// then work on those limbs exactly as ops/limbs.py does (every step mod
// 2^(16 width)), so they agree bit for bit whatever the value.
//
// ---- lift_kernel ----
// limbs [r, x, k] (k < n, two's complement) -> res[r, l, x] in [0, q_l):
//   S = sum_k limb_k * (2^(16k) mod q_l)  (64 bits),  res = (S - sign*wrap_l) mod q_l
// with wrap_l = 2^(16n) mod q_l and sign the top bit of limb n-1.  The
// table is chunk_tbl's rows 0, 4, 8, ... (2^(4c) mod q_l at c = 4k).
//
// ---- Exactness (both lanes: primes q < 2^23, rows <= 64, n <= 48) ----
// * acc: a row adds below 2^16 + 2^16 (masked products) and below
//   2^10 + 2^13 (carries: cl*B < 2^26, ch*Bh < 2^13 * 2^16 = 2^29), so
//   fewer than 2^17.2 per row and 2^23.2 over 64 rows; the w*P
//   subtraction takes off below 2^16 + 2^13 per limb (wl < 2^10,
//   wh < 2^13).  int32 throughout, as ops/crt.py's bound of 2^29 says.
// * sig_raw: 64 canonical terms below m_r < 2^23: below 2^29.
// * Shoup products: for w < q < 2^31 and w' = floor(w 2^32 / q), any
//   a < 2^32 gives a*w - umulhi(a, w')*q in [0, 2q), all in 32 bits.
// * lift: each term below 2^16 * 2^23, the sum of n <= 48 terms below
//   2^45; S mod q = hi * (2^32 mod q) + lo, two Shoup products below 2q
//   each, a sum below 4q < 2^25, two conditional subtractions.
// The narrow lane's mod_mul (10-bit Horner, float32 Barrett) and the wide
// lane's (int64 %) return the canonical residue, so any exact method
// gives their numbers; the kernels take every product in 32 or 64 bits.
//
// ---- What bounds them on the H100, and the design ----
// Main path (m = 8192, batch 64, L = 12, n = 17, n_ct = 6):
//   crt_kernel, ScaleDown: [192, 12, 4096] in (37.7 MB), [192, 4096, 6]
//     out (18.9 MB): 17 us of memory at 3.35 TB/s against the 0.43 G
//     int32 operations the reconstruction needs (one multiply-add per
//     row and limb, the wrap count, the w*P subtraction and the carries;
//     chip_smoke.py crt_bound), 13 us at 33.5 T/s: bound by bytes.  The
//     kernel itself forms the partials in the split, masked form above
//     (10 operations per row and limb, ~1.8 G, 55 us), which the
//     'limb' shards' all-reduce needs element for element;
//   lift_kernel, tensor_mul: [256, 4096, 6] in (25 MB), [256, 12, 4096]
//     out (50 MB): 22 us of memory against 0.3 G operations, 9 us:
//     bound by bytes.
// * One thread per coefficient (a grid-stride loop), its n limbs in
//   registers: the arrays are sized by a template bucket NMAX (8 ... 48)
//   and every loop over them is unrolled, so every index is a constant;
//   a runtime n < NMAX only predicates the top limbs off.  The runtime
//   limb shift of the ScaleDown tail runs as a barrel of constant shifts.
// * The basis tables (B, Bh, per-row and per-basis constants; 22 KB at
//   64 rows and 48 limbs) are copied into shared memory once per block;
//   a warp reads one entry for all its lanes (a broadcast).
// * A warp's 32 coefficients are adjacent, so residue reads and writes
//   ([r, l, x] with x fastest) are coalesced.  Limb reads and writes
//   ([r, x, k]) are strided by n words per lane; L1 serves a warp's later
//   limbs from the sectors of its first.
// Nothing here is tuned: no staging of the limb rows through shared
// memory, no vector loads, no 8-bit tensor-core form of the accumulation.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxRows = 64;
constexpr int kMaxLimbs = 48;
constexpr int kHeader = 8;    // words: rows, n, mr, Pinv_r, Pinv_r', 0, 0, 0
constexpr int kRowWords = 4;  // per row: Bmodr, Bmodr', er_mask, 0
constexpr int kBlocksPerSm = 8;
constexpr int32_t kMask = 0xFFFF;

enum Mode { kPartials = 0, kFinish = 1, kToLimbs = 2 };
enum Tail { kNone = 0, kRoundDown = 1, kReduceSigned = 2 };

__host__ __device__ constexpr int table_words(int rows, int n) {
  return kHeader + kRowWords * rows + 2 * rows * n + 2 * n;
}

// a * w mod q in [0, 2q), for w < q < 2^31 and wr = floor(w 2^32 / q)
__device__ __forceinline__ uint32_t shoup(uint32_t a, uint32_t w, uint32_t wr,
                                          uint32_t q) {
  return a * w - __umulhi(a, wr) * q;
}

__device__ __forceinline__ uint32_t csub(uint32_t x, uint32_t q) {
  return x >= q ? x - q : x;
}

// ops/limbs.py normalize on the first n limbs: carry-propagate signed
// int32 partial limbs into [0, 2^16), the top carry dropped (mod 2^16n).
template <int NMAX>
__device__ __forceinline__ void normalize(int32_t (&v)[NMAX], int n) {
  int32_t carry = 0;
#pragma unroll
  for (int k = 0; k < NMAX; ++k) {
    if (k < n) {
      const int32_t t = v[k] + carry;
      v[k] = t & kMask;
      carry = t >> 16;  // arithmetic: borrows propagate
    }
  }
}

// ops/limbs.py reduce_mod_q(v, log_q, positive=False, out_width=nw) of the
// n limbs of v: the value mod 2^logQ centred into [-2^(logQ-1), 2^(logQ-1)),
// as nw limbs (nw <= NMAX, 16 nw > logQ).
template <int NMAX>
__device__ __forceinline__ void reduce_signed(int32_t (&v)[NMAX], int n, int log_q,
                                              int nw) {
  const int hi_limb = log_q >> 4, hi_bits = log_q & 15;
  const int sb_limb = (log_q - 1) >> 4, sb_off = (log_q - 1) & 15;
  int32_t sign = 0;
#pragma unroll
  for (int k = 0; k < NMAX; ++k) {
    int32_t m = 0;
    if (k < n && k < hi_limb)
      m = v[k];
    else if (k < n && k == hi_limb && hi_bits)
      m = v[k] & ((1 << hi_bits) - 1);
    v[k] = m;
    if (k == sb_limb) sign = (m >> sb_off) & 1;
  }
#pragma unroll
  for (int k = 0; k < NMAX; ++k)
    if (k == hi_limb) v[k] -= sign << hi_bits;
  normalize(v, nw);
}

// ScaleDown's tail (ops/crt_cuda.py plain_tail): floor((2x + 2^logQ) /
// 2^(logQ+1)) of the n-limb value x, each step mod 2^16n as ops/limbs.py
// computes it, then reduce_signed at nw limbs.
template <int NMAX>
__device__ __forceinline__ void round_down(int32_t (&v)[NMAX], int n, int log_q,
                                           int nw) {
  // shift_left(x, 1)
#pragma unroll
  for (int k = NMAX - 1; k >= 0; --k) {
    const uint32_t lo = static_cast<uint32_t>(v[k]);
    const uint32_t hi = k ? static_cast<uint32_t>(v[k ? k - 1 : 0]) : 0u;
    v[k] = static_cast<int32_t>(((lo << 1) | (hi >> 15)) & kMask);
  }
  // + 2^logQ (its limbs: 1 << (logQ mod 16) at limb logQ / 16)
#pragma unroll
  for (int k = 0; k < NMAX; ++k)
    if (k == (log_q >> 4)) v[k] += 1 << (log_q & 15);
  normalize(v, n);
  // arith_shift_right(y, logQ + 1): limbs down by ls, bits down by bs,
  // the sign limb filled in above the top
  const int s = log_q + 1, ls = s >> 4, bs = s & 15;
  int32_t fill = 0;
#pragma unroll
  for (int k = 0; k < NMAX; ++k)
    if (k == n - 1) fill = (v[k] >> 15) & 1 ? kMask : 0;
#pragma unroll
  for (int b = 0; (1 << b) < NMAX; ++b) {
    const int step = 1 << b;
    if (ls & step) {
#pragma unroll
      for (int k = 0; k < NMAX; ++k) {
        const int j = k + step < NMAX ? k + step : 0;
        v[k] = (k + step < NMAX && k + step < n) ? v[j] : fill;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < NMAX; ++k) {
    const int j = k + 1 < NMAX ? k + 1 : 0;
    const uint32_t hi =
        static_cast<uint32_t>((k + 1 < NMAX && k + 1 < n) ? v[j] : fill);
    const uint32_t lo = static_cast<uint32_t>(v[k]);
    v[k] = static_cast<int32_t>(((lo >> bs) | (hi << (16 - bs))) & kMask);
  }
  reduce_signed(v, n, log_q, nw);
}

template <int kMode, int NMAX>
__global__ void __launch_bounds__(kThreads)
    crt_kernel(const int32_t* __restrict__ res, const int32_t* __restrict__ acc_in,
               const int32_t* __restrict__ sig_in, const int32_t* __restrict__ er_in,
               const int32_t* __restrict__ tab, int32_t* __restrict__ out,
               int32_t* __restrict__ sig_out, int32_t* __restrict__ er_out,
               long long coeffs, int phim, int tail, int log_q, int n_out) {
  extern __shared__ int32_t smem[];
  const int rows = tab[0], n = tab[1];
  for (int i = threadIdx.x; i < table_words(rows, n); i += blockDim.x) smem[i] = tab[i];
  __syncthreads();
  const uint32_t mr = smem[2], pinv = smem[3], pinv_r = smem[4];
  const int32_t* rowc = smem + kHeader;
  const int32_t* B = rowc + kRowWords * rows;
  const int32_t* Bh = B + rows * n;
  const int32_t* P = Bh + rows * n;
  const int32_t* P10 = P + n;
  const int width = tail == kNone ? n : n_out;

  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < coeffs; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    int32_t acc[NMAX];
    int32_t sig = 0, er = 0;
    if (kMode == kFinish) {
#pragma unroll
      for (int k = 0; k < NMAX; ++k) acc[k] = k < n ? acc_in[i * n + k] : 0;
      sig = sig_in[i];
      er = er_in[i];
    } else {
#pragma unroll
      for (int k = 0; k < NMAX; ++k) acc[k] = 0;
      const long long r = i / phim, x = i - r * phim;
      const int32_t* src = res + r * rows * phim + x;
      for (int l = 0; l < rows; ++l) {
        const int32_t c = __ldg(src + static_cast<long long>(l) * phim);
        const int32_t cl = c & 1023, ch = c >> 10;
        const int32_t* b = B + l * n;
        const int32_t* bh = Bh + l * n;
#pragma unroll
        for (int k = 0; k < NMAX; ++k) {
          if (k < n) {
            const int32_t p0 = cl * b[k], p1 = ch * bh[k];
            acc[k] += (p0 & kMask) + (p1 & kMask);
            if (k + 1 < NMAX) acc[k + 1] += (p0 >> 16) + (p1 >> 16);
          }
        }
        const int32_t* rc = rowc + kRowWords * l;
        sig += static_cast<int32_t>(csub(shoup(c, rc[0], rc[1], mr), mr));
        er += rc[2] * c;
      }
    }
    if (kMode == kPartials) {
#pragma unroll
      for (int k = 0; k < NMAX; ++k)
        if (k < n) out[i * n + k] = acc[k];
      sig_out[i] = sig;
      er_out[i] = er;
      continue;
    }
    // the wrap count w = ((S mod m_r) - E_r) P^-1 mod m_r, then E = S - w P
    int32_t s = sig % static_cast<int32_t>(mr);
    if (s < 0) s += mr;
    int32_t diff = s - er;
    if (diff < 0) diff += mr;
    const uint32_t w = csub(shoup(diff, pinv, pinv_r, mr), mr);
    const int32_t wl = w & 1023, wh = w >> 10;
#pragma unroll
    for (int k = 0; k < NMAX; ++k) {
      if (k < n) {
        const int32_t sub = wl * P[k] + wh * P10[k];
        acc[k] -= sub & kMask;
        if (k + 1 < NMAX) acc[k + 1] -= sub >> 16;
      }
    }
    normalize(acc, n);
    if (tail == kRoundDown)
      round_down(acc, n, log_q, n_out);
    else if (tail == kReduceSigned)
      reduce_signed(acc, n, log_q, n_out);
#pragma unroll
    for (int k = 0; k < NMAX; ++k)
      if (k < width) out[i * width + k] = acc[k];
  }
}

template <int NMAX>
__global__ void __launch_bounds__(kThreads)
    lift_kernel(const int32_t* __restrict__ limbs, const int32_t* __restrict__ chunk_tbl,
                const int32_t* __restrict__ q, const int32_t* __restrict__ wrap,
                int32_t* __restrict__ out, long long coeffs, int phim, int L, int n) {
  extern __shared__ uint32_t lsm[];
  uint32_t* T = lsm;          // [L][n]: 2^(16k) mod q_l
  uint32_t* C = lsm + L * n;  // [L][5]: q, floor(2^32/q), 2^32 mod q, its w', wrap
  for (int idx = threadIdx.x; idx < L * n; idx += blockDim.x) {
    const int l = idx / n, k = idx - l * n;
    T[idx] = chunk_tbl[static_cast<long long>(4 * k) * L + l];
  }
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    const unsigned long long ql = static_cast<uint32_t>(q[l]);
    const uint32_t c32 = static_cast<uint32_t>((1ull << 32) % ql);
    C[5 * l] = static_cast<uint32_t>(ql);
    C[5 * l + 1] = static_cast<uint32_t>((1ull << 32) / ql);
    C[5 * l + 2] = c32;
    C[5 * l + 3] = static_cast<uint32_t>((static_cast<unsigned long long>(c32) << 32) / ql);
    C[5 * l + 4] = static_cast<uint32_t>(wrap[l]);
  }
  __syncthreads();

  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < coeffs; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int32_t* src = limbs + i * n;
    uint32_t x[NMAX];
#pragma unroll
    for (int k = 0; k < NMAX; ++k) x[k] = k < n ? (src[k] & kMask) : 0u;
    const uint32_t sign = (src[n - 1] >> 15) & 1;
    const long long r = i / phim, xc = i - r * phim;
    int32_t* dst = out + r * L * phim + xc;
    for (int l = 0; l < L; ++l) {
      const uint32_t* t = T + l * n;
      unsigned long long acc = 0;
#pragma unroll
      for (int k = 0; k < NMAX; ++k)
        if (k < n) acc += static_cast<unsigned long long>(x[k]) * t[k];
      const uint32_t* c = C + 5 * l;
      const uint32_t ql = c[0];
      uint32_t v = shoup(static_cast<uint32_t>(acc >> 32), c[2], c[3], ql) +
                   shoup(static_cast<uint32_t>(acc), 1u, c[1], ql);
      v = csub(csub(v, 2 * ql), ql);
      int32_t rv = static_cast<int32_t>(v) - static_cast<int32_t>(sign * c[4]);
      if (rv < 0) rv += static_cast<int32_t>(ql);
      dst[static_cast<long long>(l) * phim] = rv;
    }
  }
}

int grid_for(long long coeffs) {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
  }
  const long long blocks = (coeffs + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms) * kBlocksPerSm;
  return static_cast<int>(blocks < cap ? blocks : cap);
}

// f(std::integral_constant<int, NMAX>()) for the smallest bucket NMAX >= n
template <typename F>
void with_nmax(int n, F&& f) {
  if (n <= 8) f(std::integral_constant<int, 8>());
  else if (n <= 16) f(std::integral_constant<int, 16>());
  else if (n <= 24) f(std::integral_constant<int, 24>());
  else if (n <= 32) f(std::integral_constant<int, 32>());
  else if (n <= 40) f(std::integral_constant<int, 40>());
  else f(std::integral_constant<int, 48>());
}

template <int kMode>
cudaError_t launch_crt(const void* res, const void* acc_in, const void* sig_in,
                       const void* er_in, const void* tab, void* out, void* sig_out,
                       void* er_out, long long coeffs, int phim, int rows, int n,
                       int tail, int log_q, int n_out, void* stream) {
  if (coeffs < 0 || phim < 1 || rows < 1 || rows > kMaxRows || n < 1 || n > kMaxLimbs ||
      tail < kNone || tail > kReduceSigned ||
      (tail != kNone && (n_out < 1 || n_out > kMaxLimbs || log_q < 1 ||
                         16 * n_out <= log_q || 16 * n <= log_q)))
    return cudaErrorInvalidValue;
  if (coeffs == 0) return cudaSuccess;
  const size_t smem = sizeof(int32_t) * table_words(rows, n);
  const int grid = grid_for(coeffs);
  with_nmax(tail == kNone || n > n_out ? n : n_out, [&](auto nmax) {
    crt_kernel<kMode, decltype(nmax)::value>
        <<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const int32_t*>(res), static_cast<const int32_t*>(acc_in),
            static_cast<const int32_t*>(sig_in), static_cast<const int32_t*>(er_in),
            static_cast<const int32_t*>(tab), static_cast<int32_t*>(out),
            static_cast<int32_t*>(sig_out), static_cast<int32_t*>(er_out), coeffs, phim,
            tail, log_q, n_out);
  });
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The single-pass CRT reconstruction.  tab: the basis table of
// ops/crt_cuda.py kernel_table (rows and n in its first two words, which
// must equal `rows` and `n`).
//   fsi_crt_partials: res [coeffs / phim, rows, phim] -> acc [coeffs, n],
//                     sig_raw [coeffs], er [coeffs];
//   fsi_crt_finish:   (acc, sig_raw, er) -> out [coeffs, width];
//   fsi_crt_to_limbs: res -> out [coeffs, width];
// width = n without a tail (tail 0), n_out with ScaleDown's (1) or the
// signed reduction's (2), both mod 2^log_q.
int fsi_crt_partials(const void* res, const void* tab, void* acc, void* sig, void* er,
                     long long coeffs, int phim, int rows, int n, void* stream) {
  return launch_crt<kPartials>(res, nullptr, nullptr, nullptr, tab, acc, sig, er, coeffs,
                               phim, rows, n, kNone, 0, n, stream);
}

int fsi_crt_finish(const void* acc, const void* sig, const void* er, const void* tab,
                   void* out, long long coeffs, int rows, int n, int tail, int log_q,
                   int n_out, void* stream) {
  return launch_crt<kFinish>(nullptr, acc, sig, er, tab, out, nullptr, nullptr, coeffs, 1,
                             rows, n, tail, log_q, n_out, stream);
}

int fsi_crt_to_limbs(const void* res, const void* tab, void* out, long long coeffs,
                     int phim, int rows, int n, int tail, int log_q, int n_out,
                     void* stream) {
  return launch_crt<kToLimbs>(res, nullptr, nullptr, nullptr, tab, out, nullptr, nullptr,
                              coeffs, phim, rows, n, tail, log_q, n_out, stream);
}

// limbs [coeffs, n] (coeffs = rows * phim) -> res [coeffs / phim, L, phim].
// chunk_tbl [>= 4n, L] (2^(4c) mod q_l), q [L], wrap [L] = 2^(16n) mod q_l.
int fsi_limbs_to_residues(const void* limbs, const void* chunk_tbl, const void* q,
                          const void* wrap, void* out, long long coeffs, int phim, int L,
                          int n, void* stream) {
  if (coeffs < 0 || phim < 1 || L < 1 || L > kMaxRows || n < 1 || n > kMaxLimbs)
    return cudaErrorInvalidValue;
  if (coeffs == 0) return cudaSuccess;
  const size_t smem = sizeof(uint32_t) * (L * n + 5 * L);
  const int grid = grid_for(coeffs);
  with_nmax(n, [&](auto nmax) {
    lift_kernel<decltype(nmax)::value>
        <<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const int32_t*>(limbs), static_cast<const int32_t*>(chunk_tbl),
            static_cast<const int32_t*>(q), static_cast<const int32_t*>(wrap),
            static_cast<int32_t*>(out), coeffs, phim, L, n);
  });
  return cudaGetLastError();
}

}  // extern "C"
