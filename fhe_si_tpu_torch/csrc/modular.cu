// The evaluation-domain products of mul+relin, written for Hopper (sm_90a):
// the tensor product of two ciphertexts' evaluations and the keyswitch dot
// of the digits' evaluations with the key matrix.  Wrappers:
// ops/modular_cuda.py.
//
// Neither is a Pallas kernel in the JAX package: there the same jnp code
// runs fused by XLA.  Run eagerly by PyTorch, the plain versions (the
// narrow lane's 10-bit Horner with float32 Barretts of ops/modular.py) are
// about 35 launches per product over the whole [..., L, phim] tensor, and
// the dot's four split partial products go through device memory.  Here
// each is one launch that reads every input once and writes every output
// once.
//
//   tensor_product_kernel <- fhe_si_tpu/device.py:558-582 _tensor_mul, its
//                            evaluation-domain half
//                            (ops/modular_cuda.py tensor_product_plain)
//   keyswitch_dot_kernel  <- fhe_si_tpu/ops/modular.py:75 mod_dot as
//                            fhe_si_tpu/device.py:693 _keyswitch_digits calls it
//                            (ops/modular_cuda.py keyswitch_dot_plain)
//
// ---- What they compute, per lead index r, residue row l, coefficient x ----
// tensor_product: a [R, na, L, phim], b [R, nb, L, phim], canonical residues
//   a'_i   = a_i * (p mod q_l) mod q_l                      i < na
//   out[k] = sum_{i + j = k} a'_i * b_j mod q_l             k < na + nb - 1
// keyswitch_dot: mat [2, K, L, phim], dig [R, K, L, phim]
//   out[j] = sum_k mat[j, k] * dig[k] mod q_l               j < 2
// Every output is the canonical residue in [0, q_l), as the plain
// versions' is (ops/modular.py: the narrow lane's Horner, the wide lane's
// int64 %), so any exact method gives their numbers.
//
// The table (ops/modular_cuda.py kernel_table), per row l, 4 words:
// q_l, p mod q_l, and mu_l = floor(2^64 / q_l) as its low and high words.
//
// ---- Exactness (primes 2 <= q < 2^23, na, nb <= kMaxParts = 4,
//      K <= kMaxTerms = 384; ops/modular_cuda.py checks each on the host) ----
// * Every input is a canonical residue below q < 2^23, so a product of two
//   is below 2^46 (uint64).
// * A tensor-product output sums at most min(na, nb) <= 4 products: below
//   2^48.  A dot sums K <= 384 products: below 384 * 2^46 < 2^55.
// * reduce(x), for any x < 2^64: t = floor(x mu / 2^64) (__umul64hi).
//   With x = Q q + s, 0 <= s < q: mu > 2^64 / q - 1 gives
//   x mu / 2^64 > x / q - 1, so t >= Q - 1; mu <= 2^64 / q gives t <= Q.
//   So r = x - t q lies in [0, 2q) (below 2^24, 32 bits), and one
//   conditional subtraction makes it canonical.
//
// ---- What bounds them on the H100, and the design ----
// Main path (m = 8192, batch 64, L = 12, Lk = 8, K = 3 parts x 4 digits
// = 12; chip_smoke.py modular_bound):
//   tensor_product: [64, 4, 12, 4096] in, [64, 3, 12, 4096] out: 88.1 MB,
//     26.3 us at 3.35 TB/s, against about 0.23 G int32 operations (2 per
//     multiply-add, 12 per reduction), 6.8 us at 33.5 T/s: bytes;
//   keyswitch_dot: [64, 12, 8, 4096] digits and the [2, 12, 8, 4096]
//     matrix in, [64, 2, 8, 4096] out: 120.6 MB, 36.0 us, against 0.15 G
//     operations, 4.5 us: bytes.
// * One thread per (lead index, residue row, coefficient): the grid's x
//   covers the coefficients, y the residue row, z the lead index (a
//   stride loop past 65535), so no thread divides, a block's row
//   constants are one broadcast load, and a warp's 32 coefficients are
//   adjacent: every read and write is coalesced.
// * The tensor product keeps the na + nb residues in registers (arrays of
//   kMaxParts, zero past na and nb, so the unrolled part loops need no
//   predicate) and reads a and b through their lead strides: the two
//   halves of one lifted tensor need no copy.
// * The dot streams its K terms, two 64-bit sums per thread; the matrix
//   (3 MB at the main shape) is read once per lead index, from L2.
// Nothing here is tuned: one word per load, one coefficient per thread.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxParts = 4;
constexpr int kMaxTerms = 384;
constexpr int kRowWords = 4;  // per row: q, p mod q, mu lo, mu hi
constexpr int kMaxGridZ = 65535;

typedef unsigned long long u64;

struct Row {
  uint32_t q, pq;
  u64 mu;
};

__device__ __forceinline__ Row load_row(const int32_t* __restrict__ tab, int l) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(tab) + kRowWords * l;
  return Row{__ldg(w), __ldg(w + 1),
             static_cast<u64>(__ldg(w + 2)) | (static_cast<u64>(__ldg(w + 3)) << 32)};
}

// x mod q, canonical, for any x < 2^64 (header: Exactness)
__device__ __forceinline__ uint32_t reduce(u64 x, const Row& row) {
  const u64 t = __umul64hi(x, row.mu);
  const uint32_t r = static_cast<uint32_t>(x - t * row.q);
  return r >= row.q ? r - row.q : r;
}

__global__ void __launch_bounds__(kThreads)
    tensor_product_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                          const int32_t* __restrict__ tab, int32_t* __restrict__ out,
                          long long a_stride, long long b_stride, int R, int phim, int na,
                          int nb) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= phim) return;
  const int l = blockIdx.y;
  const long long plane = static_cast<long long>(gridDim.y) * phim;  // one part
  const long long lx = static_cast<long long>(l) * phim + x;
  const int nk = na + nb - 1;
  const Row row = load_row(tab, l);
  for (long long r = blockIdx.z; r < R; r += gridDim.z) {
    const int32_t* ar = a + r * a_stride + lx;
    const int32_t* br = b + r * b_stride + lx;
    uint32_t av[kMaxParts], bv[kMaxParts];
#pragma unroll
    for (int i = 0; i < kMaxParts; ++i) {
      av[i] = i < na ? reduce(static_cast<u64>(static_cast<uint32_t>(__ldg(ar + i * plane))) *
                                  row.pq,
                              row)
                     : 0u;
      bv[i] = i < nb ? static_cast<uint32_t>(__ldg(br + i * plane)) : 0u;
    }
    int32_t* dst = out + r * nk * plane + lx;
#pragma unroll
    for (int k = 0; k < 2 * kMaxParts - 1; ++k) {
      if (k < nk) {
        u64 acc = 0;
#pragma unroll
        for (int i = 0; i < kMaxParts; ++i) {
          const int j = k - i;
          if (j >= 0 && j < kMaxParts) acc += static_cast<u64>(av[i]) * bv[j];
        }
        dst[k * plane] = static_cast<int32_t>(reduce(acc, row));
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    keyswitch_dot_kernel(const int32_t* __restrict__ mat, const int32_t* __restrict__ dig,
                         const int32_t* __restrict__ tab, int32_t* __restrict__ out, int R,
                         int phim, int K) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= phim) return;
  const int l = blockIdx.y;
  const long long plane = static_cast<long long>(gridDim.y) * phim;
  const long long lx = static_cast<long long>(l) * phim + x;
  const Row row = load_row(tab, l);
  const int32_t* m0 = mat + lx;
  const int32_t* m1 = mat + K * plane + lx;
  for (long long r = blockIdx.z; r < R; r += gridDim.z) {
    const int32_t* d = dig + r * K * plane + lx;
    u64 acc0 = 0, acc1 = 0;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const u64 dk = static_cast<uint32_t>(__ldg(d + k * plane));
      acc0 += dk * static_cast<uint32_t>(__ldg(m0 + k * plane));
      acc1 += dk * static_cast<uint32_t>(__ldg(m1 + k * plane));
    }
    int32_t* dst = out + r * 2 * plane + lx;
    dst[0] = static_cast<int32_t>(reduce(acc0, row));
    dst[plane] = static_cast<int32_t>(reduce(acc1, row));
  }
}

dim3 grid_for(int R, int L, int phim) {
  return dim3((phim + kThreads - 1) / kThreads, L, R < kMaxGridZ ? R : kMaxGridZ);
}

}  // namespace

extern "C" {

// a [R, na, L, phim] and b [R, nb, L, phim], each part a contiguous
// [L, phim] block at a stride of L * phim words, the lead index at a_stride
// and b_stride words -> out [R, na + nb - 1, L, phim] (contiguous).
// tab: the kernel table of the L rows.
int fsi_tensor_product(const void* a, const void* b, const void* tab, void* out,
                       long long a_stride, long long b_stride, int R, int L, int phim, int na,
                       int nb, void* stream) {
  if (R < 0 || L < 1 || L > 65535 || phim < 1 || na < 1 || na > kMaxParts || nb < 1 ||
      nb > kMaxParts)
    return cudaErrorInvalidValue;
  if (R == 0) return cudaSuccess;
  tensor_product_kernel<<<grid_for(R, L, phim), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), static_cast<const int32_t*>(b),
      static_cast<const int32_t*>(tab), static_cast<int32_t*>(out), a_stride, b_stride, R, phim,
      na, nb);
  return cudaGetLastError();
}

// mat [2, K, L, phim] and dig [R, K, L, phim] (contiguous) -> out
// [R, 2, L, phim].  tab: the kernel table of the L rows.
int fsi_keyswitch_dot(const void* mat, const void* dig, const void* tab, void* out, int R, int L,
                      int phim, int K, void* stream) {
  if (R < 0 || L < 1 || L > 65535 || phim < 1 || K < 1 || K > kMaxTerms)
    return cudaErrorInvalidValue;
  if (R == 0) return cudaSuccess;
  keyswitch_dot_kernel<<<grid_for(R, L, phim), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(mat), static_cast<const int32_t*>(dig),
      static_cast<const int32_t*>(tab), static_cast<int32_t*>(out), R, phim, K);
  return cudaGetLastError();
}

}  // extern "C"
