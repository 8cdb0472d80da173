// The limb <-> residue conversions of the device pipelines, written for
// Hopper (sm_90a): the CRT reconstruction with its limb tails, and the
// lift of limbs to residues.  Wrappers: ops/crt_cuda.py.
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
//   crt_pass_kernel        <- fhe_si_tpu/ops/crt.py:234 residues_to_limbs_fast, the
//                             one-pass reconstruction (fhe_si_tpu_torch/ops/crt.py
//                             residues_to_limbs_fast)
//     with tail kRoundDown:    + the limb tail of fhe_si_tpu/device.py:617 _scale_down
//                             (shift_left 1, + 2^logQ, arith_shift_right logQ + 1,
//                              limbs.py:54 reduce_mod_q signed at n_ct)
//     with tail kReduceSigned: + limbs.py:54 reduce_mod_q signed at n_ct, the
//                             keyswitch output of fhe_si_tpu/device.py:685
//                             _keyswitch_digits
//   lift_kernel            <- fhe_si_tpu/ops/crt.py:38 limbs_to_residues
//                             (fhe_si_tpu_torch/ops/crt.py limbs_to_residues), from
//                             one limb tensor or from two (the operands of
//                             fhe_si_tpu/device.py:558 _tensor_mul, which the JAX
//                             package joins with jnp.concatenate first)
//
// ---- What the reconstruction computes, per coefficient x of a lead row r ----
// Input res[r, l, x], l < rows: residues c_l prescaled by the basis' CRT
// factor (the inverse transform folds b_l^-1 in), the redundant modulus
// m_r's row last.  With B_l = P / q_l (zero on the redundant row):
//   S = sum_l c_l B_l,   sig = sum_l c_l (B_l mod m_r),   er = sum_l er_mask_l c_l
//   w = ((sig mod m_r) - er mod m_r) P^-1 mod m_r,   E = S - w P  (mod 2^16n)
// E, the centred value, as n two's complement 16-bit limbs.  The tails
// then work on those limbs exactly as ops/limbs.py does (every step mod
// 2^(16 width)), so they agree bit for bit whatever the value.
//
// crt_kernel (the 'limb' shards' modes, ops/crt_cuda.py kernel_table's
// first words) forms S in the split, masked form whose int32 partials the
// shards all-reduce element for element:
//   acc[k]  = sum_l (cl*B[l,k] & M) + (ch*Bh[l,k] & M)
//             + sum_l (cl*B[l,k-1] >> 16) + (ch*Bh[l,k-1] >> 16)    (k >= 1)
//             with cl = c & 1023, ch = c >> 10, M = 2^16 - 1
//   sig_raw = sum_l (c * Bmodr[l] mod m_r)
// (kPartials writes acc, sig_raw, er; kFinish subtracts w P's partial
// limbs and normalizes: the carry chain mod 2^16n, as ops/limbs.py
// _shift_up drops the top carry.)
//
// crt_pass_kernel, which the main path runs, needs no partials.  B_l is
// ceil(n/2) 32-bit words B_l[j] (limbs 2j and 2j + 1), P likewise, and
// per coefficient it keeps ceil(n/2) + 2 exact 64-bit column sums:
//   S_j = sum_l c_l B_l[j],  sig = sum_l c_l Bmodr_l,  er = sum_l er_mask_l c_l
// (one 32 x 32 -> 64-bit product, IMAD.WIDE.U32, per row and column), then
//   sig mod m_r (two Shoup products of its 32-bit halves), w as above,
//   T_j = S_j - w P[j] in signed 64 bits, and one carry pass
//   word_j = (T_j + carry_j) mod 2^32, carry_j+1 = (T_j + carry_j) >> 32
// split into the 16-bit limbs 2j, 2j + 1; limbs from n up are dropped
// (at odd n the last word holds one limb).  That is S - w P mod 2^16n,
// the integer the split form normalizes to, so the limbs are the same.
//
// ---- The lift ----
// limbs [r, x, k] (k < n, two's complement) -> res[r, l, x] in [0, q_l):
//   x_j = (limb_2j & M) | (limb_2j+1 & M) << 16        (j < ceil(n/2))
//   S   = sum_j x_j (2^(32j) mod q_l)  (64 bits),   res = (S - sign*wrap_l) mod q_l
// with wrap_l = 2^(16n) mod q_l and sign the top bit of limb n-1.  The
// table is chunk_tbl's rows 0, 8, 16, ... (2^(4c) mod q_l at c = 8j).
//
// ---- Exactness (both lanes: primes q < 2^23, rows <= 64, n <= 48) ----
// crt_pass_kernel:
// * A product c_l B_l[j] is below 2^23 * 2^32 = 2^55, a column sum of at
//   most 64 rows below 2^61; sig's terms c_l Bmodr_l < 2^46 sum below
//   2^52, er below 2^29.
// * w < m_r < 2^23, so w P[j] < 2^55 and T_j = S_j - w P[j] lies in
//   (-2^55, 2^61): exact as a signed 64-bit integer (the unsigned
//   difference read as int64).  The carries stay below 2^30 in size.
// * sig mod m_r: sig = hi 2^32 + lo with hi < 2^20; hi (2^32 mod m_r) and
//   lo * 1 by Shoup products below 2 m_r each, a sum below 4 m_r, two
//   conditional subtractions.
// crt_kernel (unchanged):
// * acc: a row adds below 2^16 + 2^16 (masked products) and below
//   2^10 + 2^13 (carries: cl*B < 2^26, ch*Bh < 2^13 * 2^16 = 2^29), so
//   fewer than 2^17.2 per row and 2^23.2 over 64 rows; the w*P
//   subtraction takes off below 2^16 + 2^13 per limb (wl < 2^10,
//   wh < 2^13).  int32 throughout, as ops/crt.py's bound of 2^29 says.
// * sig_raw: 64 canonical terms below m_r < 2^23: below 2^29.
// The lift:
// * x_j < 2^32 and a table word below q < 2^23 give a product below 2^55;
//   at most ceil(48/2) = 24 terms sum below 2^60.  S mod q = hi (2^32 mod
//   q) + lo with hi < 2^28: two Shoup products below 2q each, a sum below
//   4q < 2^25, two conditional subtractions.
// * Shoup products: for w < q < 2^31 and w' = floor(w 2^32 / q), any
//   a < 2^32 gives a*w - umulhi(a, w')*q in [0, 2q), all in 32 bits.
// The narrow lane's mod_mul (10-bit Horner, float32 Barrett) and the wide
// lane's (int64 %) return the canonical residue, so any exact method
// gives their numbers; the kernels take every product in 32 or 64 bits.
//
// ---- What bounds them on the H100, and the design ----
// Main path (m = 8192, batch 64, L = 12, n = 17, n_ct = 6):
//   ScaleDown's reconstruction: [192, 12, 4096] in (37.7 MB), [192, 4096, 6]
//     out (18.9 MB): 17 us of memory at 3.35 TB/s against the 0.43 G
//     int32 operations the function needs (chip_smoke.py crt_bound),
//     13 us at 33.5 T/s: bound by bytes;
//   the lift of _tensor_mul: [2 x 128, 4096, 6] in (25 MB), [256, 12,
//     4096] out (50 MB): 22 us of memory against 0.3 G operations, 9 us:
//     bound by bytes.
// What held the first versions (the one-pass mode of crt_kernel, and the
// lift over 16-bit limbs) far from that, from their SASS (cuobjdump;
// chip_smoke.py sass_report):
// * the reconstruction, crt_kernel<kToLimbs, 24> at n = 17: 331
//   instructions per residue row and coefficient (83 IMAD, 49 LDS: the
//   split, masked form's 10 integer operations and 2 shared loads per row
//   and limb, the 24-limb bucket's predicated slots issuing too), then a
//   64-bit divide, sig % m_r, and tails whose limb array lived in local
//   memory (281 STL in the coefficient loop: the barrel's run-time step
//   kept its indices from folding): 0.252 ms, 6.7% of the bound;
// * the lift, lift_kernel<8> at n = 6: 79 instructions per prime and
//   coefficient (9 IMAD.WIDE and 13 LDS: a table word per 16-bit limb, 5
//   scalar constants), a 64-bit divide per coefficient, the limb row as
//   n strided loads: 0.058 ms, 38.6%.
// The design:
// * Two coefficients a thread (x and x + 128 of a 256-coefficient tile),
//   so one shared-memory read of the table feeds two products; the table
//   rows are 16-byte aligned and read as uint4 (LDS.128) broadcasts.
// * crt_pass_kernel: one IMAD.WIDE.U32 (a 32 x 32 -> 64-bit product and
//   its sum) per row and column, the columns Bmodr, er_mask and B's words
//   of one 28-word table row, so the wrap count's sums ride the same
//   loads; the residue rows are read kAhead rows ahead, unpredicated.
//   Register buckets by 32-bit word count (with_words: every count to 16,
//   then even counts), so the main widths run no dead word (n = 17: 9
//   words) or one.
// * Its tails work on the 32-bit words as bit fields (sign extensions
//   from a bit, a word barrel and a funnel shift for ScaleDown's
//   >> (logQ + 1)), every index constant; the launch-uniform masks are
//   made once per block in shared memory.
// * A persistent grid over tiles (one per (lead row, 256 coefficients)):
//   the lead row is a 32-bit divide per tile, none per coefficient; the
//   basis table is copied into shared memory once per block.
// * Stores (crt_pass_kernel) and limb loads (lift_kernel) go through a
//   [256 x width] tile in shared memory, moved as 16-byte vectors that
//   line up with device memory whatever the tile's offset (single words
//   at its two ends).  Residue reads and writes ([r, l, x], x fastest)
//   are coalesced 4-byte accesses.
// * The lift pairs 16-bit limbs into 32-bit words (half the products) and
//   reads each prime's table row as uint4 and its constants as one
//   8-word record (two LDS.128).  It takes its input from one limb tensor
//   or from two: each output row r of ka + kb parts reads part k of the
//   first (k < ka) or part k - ka of the second, so _tensor_mul needs no
//   torch.cat of its operands.
// What holds crt_pass_kernel<9> now (ScaleDown at m = 8192, 94 registers,
// no local memory): 19 instructions per residue row and coefficient (11
// IMAD.WIDE products, one pointer step, 1.5 LDS.128, one LDG), and per
// coefficient the finish and ScaleDown's tail, about as many again (the
// tile loop holds 920 instructions, 152 of them the row loop's four
// rows): the IMAD.WIDE products the function needs and the finish's
// serial carry and shift chains, not the bytes (PERF.md, section 6).
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 128;
constexpr int kTile = 2 * kThreads;  // coefficients per tile: two per thread
constexpr int kMaxRows = 64;
constexpr int kMaxLimbs = 48;
constexpr int kMaxWords = kMaxLimbs / 2;
constexpr int kHeader = 8;    // words: rows, n, mr, Pinv_r, Pinv_r', 0, 0, 0
constexpr int kRowWords = 4;  // per row: Bmodr, Bmodr', er_mask, 0
// The one-pass section of the table (after the split form's words, at a
// 16-byte boundary): a header of kHeader words (ceil(n/2), 2^32 mod m_r,
// its Shoup w', floor(2^32 / m_r), 0, 0, 0, 0), then per row kPassRow
// words (Bmodr, er_mask, B's 32-bit words, zeros) and one more row with
// P's words in B's columns.
constexpr int kPassRow = 28;
static_assert(kPassRow % 4 == 0 && kPassRow >= 2 + kMaxWords, "one-pass table row");
constexpr int kBlocksPerSm = 8;
constexpr int kAhead = 4;  // residue rows crt_pass_kernel reads ahead
constexpr int kMaxSmem = 64 * 1024;  // bytes: a [256 x 48] tile and the tables
constexpr int32_t kMask = 0xFFFF;

enum Mode { kPartials = 0, kFinish = 1 };
enum Tail { kNone = 0, kRoundDown = 1, kReduceSigned = 2 };

// words of the split form's table (crt_kernel)
__host__ __device__ constexpr int split_words(int rows, int n) {
  return kHeader + kRowWords * rows + 2 * rows * n + 2 * n;
}

__host__ __device__ constexpr int pass_offset(int rows, int n) {
  return (split_words(rows, n) + 3) & ~3;
}

__host__ __device__ constexpr int pass_words(int rows) {
  return kHeader + kPassRow * (rows + 1);
}

// a * w mod q in [0, 2q), for w < q < 2^31 and wr = floor(w 2^32 / q)
__device__ __forceinline__ uint32_t shoup(uint32_t a, uint32_t w, uint32_t wr,
                                          uint32_t q) {
  return a * w - __umulhi(a, wr) * q;
}

__device__ __forceinline__ uint32_t csub(uint32_t x, uint32_t q) {
  return x >= q ? x - q : x;
}

// x mod q, canonical, for any x = hi 2^32 + lo (q < 2^30), given
// floor(2^32 / q), 2^32 mod q and its Shoup w'
__device__ __forceinline__ uint32_t reduce64(u64 x, uint32_t q, uint32_t r32, uint32_t c32,
                                             uint32_t c32_r) {
  const uint32_t v = shoup(static_cast<uint32_t>(x >> 32), c32, c32_r, q) +
                     shoup(static_cast<uint32_t>(x), 1u, r32, q);
  return csub(csub(v, 2 * q), q);
}

// The words of a tile in shared memory sit at tile[pad + i], pad being the
// offset of the tile's first word in device memory within its 16 bytes,
// so that tile and device memory line up in 16-byte vectors.
__device__ __forceinline__ int word_pad(const void* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// dst[i] = tile[pad + i], i < count: whole vectors as 16-byte stores,
// the words of the two partial vectors at the ends one by one
__device__ __forceinline__ void store_tile(int32_t* dst, const uint32_t* tile, int pad,
                                           int count) {
  uint32_t* base = reinterpret_cast<uint32_t*>(dst) - pad;
  const int end = pad + count;
  for (int v = threadIdx.x; 4 * v < end; v += kThreads) {
    const int w = 4 * v;
    if (w >= pad && w + 4 <= end) {
      reinterpret_cast<uint4*>(base)[v] = reinterpret_cast<const uint4*>(tile)[v];
    } else {
      for (int e = 0; e < 4; ++e)
        if (w + e >= pad && w + e < end) base[w + e] = tile[w + e];
    }
  }
}

// tile[pad + i] = src[i], i < count, the same way round
__device__ __forceinline__ void load_tile(uint32_t* tile, const int32_t* src, int pad,
                                          int count) {
  const uint32_t* base = reinterpret_cast<const uint32_t*>(src) - pad;
  const int end = pad + count;
  for (int v = threadIdx.x; 4 * v < end; v += kThreads) {
    const int w = 4 * v;
    if (w >= pad && w + 4 <= end) {
      reinterpret_cast<uint4*>(tile)[v] = __ldg(reinterpret_cast<const uint4*>(base) + v);
    } else {
      for (int e = 0; e < 4; ++e)
        if (w + e >= pad && w + e < end) tile[w + e] = __ldg(base + w + e);
    }
  }
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
  for (int i = threadIdx.x; i < split_words(rows, n); i += blockDim.x) smem[i] = tab[i];
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

// ---- crt_pass_kernel's tails, on 32-bit words ----
// They give what crt_kernel's limb tails give (ops/limbs.py's steps, each
// mod 2^16n or 2^(16 width)), read as bit fields of one integer:
//   reduce_signed at width: sext(X from bit logQ - 1) mod 2^(16 width);
//   round_down: Y = (2X + 2^logQ) mod 2^16n, sign-extended from bit
//   16n - 1 (arith_shift_right's fill), then sext((Y >> (logQ + 1)) from
//   bit logQ - 1), its reduce_signed.
// Runtime word and bit positions are reached by unrolled loops with
// constant indices (a compare selects), so the words stay in registers.

// The masks of a sign extension from bit b of an NW-word integer, word k:
// the sign bit's (1 << (b mod 32) in word b / 32, 0 elsewhere) and the
// bits kept (all below b + 1).  Uniform over a launch: crt_pass_kernel
// makes them once per block, in shared memory.
__device__ __forceinline__ uint32_t sign_mask(int b, int k) {
  return k == (b >> 5) ? 1u << (b & 31) : 0u;
}

__device__ __forceinline__ uint32_t keep_mask(int b, int k) {
  const int hw = b >> 5, hb = b & 31;
  return k < hw ? ~0u : k > hw ? 0u : hb == 31 ? ~0u : (2u << hb) - 1u;
}

// x sign-extended from the bit that the masks sel and keep describe
template <int NW>
__device__ __forceinline__ void sign_extend(uint32_t (&x)[NW], const uint32_t* sel,
                                            const uint32_t* keep) {
  uint32_t s = 0;
#pragma unroll
  for (int k = 0; k < NW; ++k) s |= x[k] & sel[k];
  const uint32_t fill = s ? ~0u : 0u;
#pragma unroll
  for (int k = 0; k < NW; ++k) x[k] = (x[k] & keep[k]) | (fill & ~keep[k]);
}

// x >>= 32 ws bits (ws <= NW), `fill` shifted in: a barrel of constant
// word shifts, one stage per bit of ws
template <int B, int NW>
__device__ __forceinline__ void words_down(uint32_t (&x)[NW], int ws, uint32_t fill) {
  if constexpr ((1 << B) <= NW) {
    constexpr int kStep = 1 << B;
    if (ws & kStep) {
#pragma unroll
      for (int k = 0; k < NW; ++k)
        x[k] = k + kStep < NW ? x[k + kStep < NW ? k + kStep : 0] : fill;
    }
    words_down<B + 1>(x, ws, fill);
  }
}

// The launch-uniform words of the tails, per word k of NW: the masks of
// sign extensions from bit logQ - 1 (kSelQ, kKeepQ) and 16n - 1 (kSelN,
// kKeepN), and 2^logQ (kTwoQ); each array 16-byte aligned
enum TailWords { kSelQ = 0, kKeepQ = 1, kSelN = 2, kKeepN = 3, kTwoQ = 4, kTailArrays = 5 };

// ScaleDown's rounding before its reduce_signed: x = X (valid below bit
// 16n) -> (Y >> (logQ + 1)) as above, valid at every bit of the NW words.
// tw: the tail words, TS = NW rounded up to 4 apart.
template <int NW>
__device__ __forceinline__ void round_down_words(uint32_t (&x)[NW], const uint32_t* tw,
                                                 int ts, int log_q) {
  uint32_t prev = 0;
  u64 c = 0;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    const uint32_t d = __funnelshift_l(prev, x[k], 1);  // 2X
    prev = x[k];
    c += static_cast<u64>(d) + tw[kTwoQ * ts + k];      // + 2^logQ
    x[k] = static_cast<uint32_t>(c);
    c >>= 32;
  }
  sign_extend(x, tw + kSelN * ts, tw + kKeepN * ts);
  const uint32_t fill = static_cast<uint32_t>(static_cast<int32_t>(x[NW - 1]) >> 31);
  const int s = log_q + 1;
  words_down<0>(x, s >> 5, fill);
#pragma unroll
  for (int k = 0; k < NW; ++k)
    x[k] = __funnelshift_r(x[k], k + 1 < NW ? x[k + 1] : fill, s & 31);
}

// The one-pass reconstruction of one coefficient from its column sums
// acc (sig, er, then NW words of S) and the table row prow of P's words
// (in the same columns), its tail, and its `width` limbs into dst.
template <int NW>
__device__ __forceinline__ void pass_finish(const u64 (&acc)[NW + 2],
                                            const uint4* __restrict__ prow, uint32_t mr,
                                            uint32_t pinv, uint32_t pinv_r, uint32_t r32,
                                            uint32_t c32, uint32_t c32_r, const uint32_t* tw,
                                            int ts, int tail, int log_q, int width,
                                            uint32_t* dst) {
  constexpr int NC = NW + 2;
  uint32_t P[NC];
#pragma unroll
  for (int v = 0; v < (NC + 3) / 4; ++v) {
    const uint4 p = prow[v];
    const uint32_t e4[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (4 * v + e < NC) P[4 * v + e] = e4[e];
  }
  // the wrap count w = ((S mod m_r) - E_r) P^-1 mod m_r, as crt_kernel
  const int32_t s = static_cast<int32_t>(reduce64(acc[0], mr, r32, c32, c32_r));
  int32_t diff = s - static_cast<int32_t>(acc[1]);
  if (diff < 0) diff += mr;
  const uint32_t w = csub(shoup(diff, pinv, pinv_r, mr), mr);
  // E = S - w P: signed 64-bit columns, one carry pass into 32-bit words
  uint32_t x[NW];
  long long carry = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const long long t =
        static_cast<long long>(acc[2 + j] - static_cast<u64>(w) * P[2 + j]) + carry;
    x[j] = static_cast<uint32_t>(t);
    carry = t >> 32;
  }
  if (tail == kRoundDown) round_down_words(x, tw, ts, log_q);
  if (tail != kNone) sign_extend(x, tw + kSelQ * ts, tw + kKeepQ * ts);
#pragma unroll
  for (int k = 0; k < 2 * NW; ++k)
    if (k < width) dst[k] = k & 1 ? x[k >> 1] >> 16 : x[k >> 1] & kMask;
}

// res [lead, rows, phim] -> out [lead, phim, width]; NW >= ceil(n/2) and
// 2 NW >= width.  Grid: any number of blocks, each walking the tiles.
template <int NW>
__global__ void __launch_bounds__(kThreads)
    crt_pass_kernel(const int32_t* __restrict__ res, const int32_t* __restrict__ tab,
                    int32_t* __restrict__ out, int lead, int phim, int rows, int n, int tail,
                    int log_q, int width) {
  constexpr int NC = NW + 2;        // columns: Bmodr, er_mask, NW words of B
  constexpr int NV = (NC + 3) / 4;  // 16-byte reads of a table row
  constexpr int kRowVecs = kPassRow / 4;
  extern __shared__ __align__(16) uint32_t psm[];
  const uint32_t* tabw = reinterpret_cast<const uint32_t*>(tab);
  const int twords = pass_words(rows);
  for (int i = threadIdx.x; i < twords; i += kThreads)
    psm[i] = __ldg(tabw + pass_offset(rows, n) + i);
  const uint32_t mr = __ldg(tabw + 2), pinv = __ldg(tabw + 3), pinv_r = __ldg(tabw + 4);
  __syncthreads();
  const uint32_t c32 = psm[1], c32_r = psm[2], r32 = psm[3];
  const uint4* rowv = reinterpret_cast<const uint4*>(psm + kHeader);
  const uint4* prow = rowv + rows * kRowVecs;  // P's words
  constexpr int TS = (NW + 3) & ~3;
  uint32_t* tw = psm + twords;        // the tail words (twords is a multiple of 4)
  uint32_t* tile = tw + kTailArrays * TS;  // [pad + kTile * width]
  for (int k = threadIdx.x; k < TS; k += kThreads) {
    tw[kSelQ * TS + k] = sign_mask(log_q - 1, k);
    tw[kKeepQ * TS + k] = keep_mask(log_q - 1, k);
    tw[kSelN * TS + k] = sign_mask(16 * n - 1, k);
    tw[kKeepN * TS + k] = keep_mask(16 * n - 1, k);
    tw[kTwoQ * TS + k] = sign_mask(log_q, k);
  }
  __syncthreads();
  const int tiles_x = (phim + kTile - 1) / kTile;
  const int ntiles = lead * tiles_x;
  const int i0 = threadIdx.x, i1 = threadIdx.x + kThreads;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int r = t / tiles_x, x0 = (t - r * tiles_x) * kTile;
    const int cnt = min(kTile, phim - x0);
    const int32_t* src = res + static_cast<long long>(r) * rows * phim + x0;
    u64 acc0[NC], acc1[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) acc0[c] = acc1[c] = 0;
    // The residue rows stream in kAhead rows ahead of the products.  A
    // thread past the tile's end reads coefficient 0 of each row and drops
    // what it computes, and the last row is read again past the end, so
    // no load is predicated.
    const int32_t* q0 = src + (i0 < cnt ? i0 : 0);
    const int32_t* q1 = src + (i1 < cnt ? i1 : 0);
    uint32_t c0[kAhead], c1[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      c0[u] = __ldg(q0);
      c1[u] = __ldg(q1);
      if (u + 1 < rows) q0 += phim, q1 += phim;
    }
    for (int l0 = 0; l0 < rows; l0 += kAhead) {
      uint32_t n0[kAhead], n1[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        n0[u] = __ldg(q0);
        n1[u] = __ldg(q1);
        if (l0 + kAhead + u + 1 < rows) q0 += phim, q1 += phim;
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        if (l0 + u < rows) {
          const uint4* row = rowv + (l0 + u) * kRowVecs;
#pragma unroll
          for (int v = 0; v < NV; ++v) {
            const uint4 b = row[v];
            const uint32_t e4[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if (4 * v + e < NC) {
                acc0[4 * v + e] += static_cast<u64>(c0[u]) * e4[e];
                acc1[4 * v + e] += static_cast<u64>(c1[u]) * e4[e];
              }
            }
          }
        }
        c0[u] = n0[u];
        c1[u] = n1[u];
      }
    }
    int32_t* dst = out + (static_cast<long long>(r) * phim + x0) * width;
    const int pad = word_pad(dst);
    if (i0 < cnt)
      pass_finish<NW>(acc0, prow, mr, pinv, pinv_r, r32, c32, c32_r, tw, TS, tail, log_q,
                      width, tile + pad + i0 * width);
    if (i1 < cnt)
      pass_finish<NW>(acc1, prow, mr, pinv, pinv_r, r32, c32, c32_r, tw, TS, tail, log_q,
                      width, tile + pad + i1 * width);
    __syncthreads();
    store_tile(dst, tile, pad, cnt * width);
    __syncthreads();
  }
}

// Limbs -> residues of L primes.  Output row o of [R * (ka + kb), L, phim]
// (r = o / (ka + kb), part k = o mod (ka + kb)) lifts part k of a
// [R, ka, phim, n] (k < ka) or part k - ka of b [R, kb, phim, n].
// NW >= ceil(n/2).  Grid: any number of blocks, each walking the tiles.
template <int NW>
__global__ void __launch_bounds__(kThreads)
    lift_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                const int32_t* __restrict__ chunk_tbl, const int32_t* __restrict__ q,
                const int32_t* __restrict__ wrap, int32_t* __restrict__ out, int R, int ka,
                int kb, int phim, int L, int n) {
  constexpr int TS = (NW + 3) & ~3;  // table words per prime, 16-byte rows
  extern __shared__ __align__(16) uint32_t lsm[];
  uint32_t* T = lsm;           // [L][TS]: 2^(32j) mod q_l, zero from ceil(n/2)
  uint32_t* C = lsm + L * TS;  // [L][8]: q, floor(2^32/q), 2^32 mod q, its w', wrap, 0, 0, 0
  uint32_t* tile = C + 8 * L;  // [pad + kTile * n]
  const int nw = (n + 1) >> 1;
  for (int idx = threadIdx.x; idx < L * TS; idx += kThreads) {
    const int l = idx / TS, j = idx - l * TS;
    T[idx] = j < nw ? static_cast<uint32_t>(__ldg(chunk_tbl + 8 * j * L + l)) : 0u;
  }
  for (int l = threadIdx.x; l < L; l += kThreads) {
    const u64 ql = static_cast<uint32_t>(q[l]);
    const uint32_t c32 = static_cast<uint32_t>((1ull << 32) % ql);
    uint32_t* c = C + 8 * l;
    c[0] = static_cast<uint32_t>(ql);
    c[1] = static_cast<uint32_t>((1ull << 32) / ql);
    c[2] = c32;
    c[3] = static_cast<uint32_t>((static_cast<u64>(c32) << 32) / ql);
    c[4] = static_cast<uint32_t>(wrap[l]);
    c[5] = c[6] = c[7] = 0;
  }
  __syncthreads();
  const int k = ka + kb;
  const int tiles_x = (phim + kTile - 1) / kTile;
  const int ntiles = R * k * tiles_x;
  const int i0 = threadIdx.x, i1 = threadIdx.x + kThreads;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int o = t / tiles_x, x0 = (t - o * tiles_x) * kTile;
    const int r = o / k, part = o - r * k;
    const int cnt = min(kTile, phim - x0);
    const int32_t* src =
        part < ka ? a + (static_cast<long long>(r * ka + part) * phim + x0) * n
                  : b + (static_cast<long long>(r * kb + part - ka) * phim + x0) * n;
    const int pad = word_pad(src);
    load_tile(tile, src, pad, cnt * n);
    __syncthreads();
    uint32_t x[2][NW], sign[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = h ? i1 : i0;
      const uint32_t* lp = tile + pad + i * n;
      const bool in = i < cnt;
#pragma unroll
      for (int j = 0; j < NW; ++j) {
        const uint32_t lo = in && 2 * j < n ? lp[2 * j] & kMask : 0u;
        const uint32_t hi = in && 2 * j + 1 < n ? lp[2 * j + 1] & kMask : 0u;
        x[h][j] = lo | (hi << 16);
      }
      sign[h] = in ? (lp[n - 1] >> 15) & 1 : 0u;
    }
    __syncthreads();  // the tile is free for the next one
    int32_t* dst = out + static_cast<long long>(o) * L * phim + x0;
    for (int l = 0; l < L; ++l) {
      const uint4* tv = reinterpret_cast<const uint4*>(T + l * TS);
      u64 s0 = 0, s1 = 0;
#pragma unroll
      for (int v = 0; v < TS / 4; ++v) {
        const uint4 w = tv[v];
        const uint32_t e4[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (4 * v + e < NW) {
            s0 += static_cast<u64>(x[0][4 * v + e]) * e4[e];
            s1 += static_cast<u64>(x[1][4 * v + e]) * e4[e];
          }
        }
      }
      const uint4 c = reinterpret_cast<const uint4*>(C + 8 * l)[0];
      const uint4 c2 = reinterpret_cast<const uint4*>(C + 8 * l)[1];
      const uint32_t ql = c.x;
      int32_t r0 = static_cast<int32_t>(reduce64(s0, ql, c.y, c.z, c.w)) -
                   static_cast<int32_t>(sign[0] * c2.x);
      int32_t r1 = static_cast<int32_t>(reduce64(s1, ql, c.y, c.z, c.w)) -
                   static_cast<int32_t>(sign[1] * c2.x);
      if (r0 < 0) r0 += static_cast<int32_t>(ql);
      if (r1 < 0) r1 += static_cast<int32_t>(ql);
      if (i0 < cnt) dst[l * phim + i0] = r0;
      if (i1 < cnt) dst[l * phim + i1] = r1;
    }
  }
}

int sm_count() {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
  }
  return sms;
}

// crt_kernel's grid: a block per 128 coefficients, at most kBlocksPerSm a SM
int grid_for(long long coeffs) {
  const long long blocks = (coeffs + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sm_count()) * kBlocksPerSm;
  return static_cast<int>(blocks < cap ? blocks : cap);
}

// The tile kernels' grid: as many blocks as fit on the card at once with
// `smem` bytes each (the tiles are walked in a loop), at most `tiles`.
// The first call for a kernel lets it take up to kMaxSmem.
template <auto kKernel>
int tile_grid(size_t smem, int tiles, cudaError_t* err) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  static size_t last_smem = 0;
  static int per_sm = 0;
  *err = attr;
  if (smem != last_smem) {
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kKernel, kThreads, smem) !=
            cudaSuccess ||
        per_sm < 1)
      per_sm = 1;
    last_smem = smem;
  }
  const long long cap = static_cast<long long>(sm_count()) * per_sm;
  return static_cast<int>(tiles < cap ? tiles : cap);
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

// f(std::integral_constant<int, NW>()) for the smallest bucket NW >= nw
// (1 <= nw <= 24): every count up to 16, then the even ones
template <typename F>
void with_words(int nw, F&& f) {
#define FSI_WORDS(k) \
  case k:            \
    f(std::integral_constant<int, k>()); \
    break;
  switch (nw) {
    FSI_WORDS(1) FSI_WORDS(2) FSI_WORDS(3) FSI_WORDS(4) FSI_WORDS(5) FSI_WORDS(6)
    FSI_WORDS(7) FSI_WORDS(8) FSI_WORDS(9) FSI_WORDS(10) FSI_WORDS(11) FSI_WORDS(12)
    FSI_WORDS(13) FSI_WORDS(14) FSI_WORDS(15) FSI_WORDS(16)
    case 17: FSI_WORDS(18)
    case 19: FSI_WORDS(20)
    case 21: FSI_WORDS(22)
    default: f(std::integral_constant<int, 24>());
  }
#undef FSI_WORDS
}

bool bad_tail(int n, int tail, int log_q, int n_out) {
  return tail < kNone || tail > kReduceSigned ||
         (tail != kNone && (n_out < 1 || n_out > kMaxLimbs || log_q < 1 ||
                            16 * n_out <= log_q || 16 * n <= log_q));
}

template <int kMode>
cudaError_t launch_crt(const void* res, const void* acc_in, const void* sig_in,
                       const void* er_in, const void* tab, void* out, void* sig_out,
                       void* er_out, long long coeffs, int phim, int rows, int n,
                       int tail, int log_q, int n_out, void* stream) {
  if (coeffs < 0 || phim < 1 || rows < 1 || rows > kMaxRows || n < 1 || n > kMaxLimbs ||
      bad_tail(n, tail, log_q, n_out))
    return cudaErrorInvalidValue;
  if (coeffs == 0) return cudaSuccess;
  const size_t smem = sizeof(int32_t) * split_words(rows, n);
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

// The CRT reconstruction.  tab: the basis table of ops/crt_cuda.py
// kernel_table (rows and n in its first two words, which must equal
// `rows` and `n`).
//   fsi_crt_partials: res [coeffs / phim, rows, phim] -> acc [coeffs, n],
//                     sig_raw [coeffs], er [coeffs];
//   fsi_crt_finish:   (acc, sig_raw, er) -> out [coeffs, width];
//   fsi_crt_to_limbs: res -> out [coeffs, width] (the one-pass kernel;
//                     coeffs < 2^31);
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
  if (coeffs < 0 || coeffs >= (1ll << 31) || phim < 1 || coeffs % phim || rows < 1 ||
      rows > kMaxRows || n < 1 || n > kMaxLimbs || bad_tail(n, tail, log_q, n_out))
    return cudaErrorInvalidValue;
  if (coeffs == 0) return cudaSuccess;
  const int width = tail == kNone ? n : n_out;
  const int lead = static_cast<int>(coeffs / phim);
  const int tiles = lead * ((phim + kTile - 1) / kTile);
  const int need = ((width > n ? width : n) + 1) / 2;
  cudaError_t err = cudaSuccess;
  with_words(need, [&](auto nw) {
    constexpr int TS = (decltype(nw)::value + 3) & ~3;
    const size_t smem =
        sizeof(uint32_t) * (pass_words(rows) + kTailArrays * TS + kTile * width + 4);
    const int grid = tile_grid<crt_pass_kernel<decltype(nw)::value>>(smem, tiles, &err);
    if (err != cudaSuccess) return;
    crt_pass_kernel<decltype(nw)::value>
        <<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(res), static_cast<const int32_t*>(tab),
        static_cast<int32_t*>(out), lead, phim, rows, n, tail, log_q, width);
  });
  return err != cudaSuccess ? err : cudaGetLastError();
}

// a [R, ka, phim, n] and, where kb > 0, b [R, kb, phim, n] (each
// contiguous) -> res [R, ka + kb, L, phim]: part k < ka from a, the rest
// from b.  chunk_tbl [>= 4n, L] (2^(4c) mod q_l), q [L], wrap [L] =
// 2^(16n) mod q_l.  R (ka + kb) phim < 2^31.
int fsi_limbs_to_residues(const void* a, const void* b, const void* chunk_tbl, const void* q,
                          const void* wrap, void* out, int R, int ka, int kb, int phim,
                          int L, int n, void* stream) {
  if (R < 0 || ka < 1 || kb < 0 || phim < 1 || L < 1 || L > kMaxRows || n < 1 ||
      n > kMaxLimbs || static_cast<long long>(R) * (ka + kb) * phim >= (1ll << 31))
    return cudaErrorInvalidValue;
  if (R == 0) return cudaSuccess;
  const int tiles = R * (ka + kb) * ((phim + kTile - 1) / kTile);
  cudaError_t err = cudaSuccess;
  with_words((n + 1) / 2, [&](auto nw) {
    constexpr int TS = (decltype(nw)::value + 3) & ~3;
    const size_t smem = sizeof(uint32_t) * (L * (TS + 8) + kTile * n + 4);
    const int grid = tile_grid<lift_kernel<decltype(nw)::value>>(smem, tiles, &err);
    if (err != cudaSuccess) return;
    lift_kernel<decltype(nw)::value>
        <<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(a), static_cast<const int32_t*>(b),
        static_cast<const int32_t*>(chunk_tbl), static_cast<const int32_t*>(q),
        static_cast<const int32_t*>(wrap), static_cast<int32_t*>(out), R, ka, kb, phim, L,
        n);
  });
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // extern "C"
