// Two-level Cooley-Tukey NTT kernels for both residue lanes (primes
// q < 2^23, q >= 2^14; power-of-two m up to 2^15), written for Hopper
// (sm_90a).
//
// Replaces the three Pallas TPU kernels of fhe_si_tpu/ops/ntt_ct_pallas.py
// with one tensor-core kernel:
//   fsi_ct_fwd        <- _fwd_res_kernel    (:148)  ct_mma_kernel<false>, S = N2
//   fsi_ct_fwd_digits <- _fwd_digits_kernel (:137)  ct_mma_kernel<true>,  S = N2
//   fsi_ct_inv        <- _inv_kernel        (:158)  ct_mma_kernel<false>, S = N1
//
// What they compute (the index maps of fhe_si_tpu_torch/ops/ntt_ct.py):
//   forward:  y[c1,j2] = (sum_c2 T2[j2,c2] x[c1 + N1*c2]) mod q
//             y[c1,j2] = y[c1,j2] * tw[c1,j2] mod q
//             X[j1,j2] = (sum_c1 T1[j1,c1] y[c1,j2]) mod q,  out[j2 + N2*j1]
//   inverse:  z[c1,j2] = (sum_j1 T1i[c1,j1] X[j1,j2]) mod q * twi[c1,j2] mod q
//             x[c1,c2] = (sum_j2 T2i[c2,j2] z[c1,j2]) mod q,  out[c1 + N1*c2]
// Every stage output is the canonical residue, so the kernels are
// bit-identical to the TPU kernels' int8-plane Karatsuba + Barrett-Horner
// and to the plain versions.
//
// ---- ct_mma_kernel: tensor cores ----
// Every transform is two stages C = A @ B of a per-prime table A and the
// row viewed as a matrix, then a mod-q epilogue.  With the row viewed as
// [S][R] (forward, on residues or digits: S = N2, R = N1, the row read as
// [c2][c1]; inverse: S = N1, R = N2):
//   stage 1: C1[S][R] = A1[S][S] @ in[S][R], reduce, times the twiddle
//            tw1[S][R] (forward: tw transposed; inverse: twi), reduce;
//   stage 2: C2[R][S] = A2[R][R] @ C1^T, reduce; out[R][S] row-major.
// (A1, A2) = (T2, T1) forward, (T1i, T2i or T2i_crt) inverse.  The two
// forward transforms differ only in the input's address: a digit row
// [rows, N] is shared by every prime, a residue row is x[row, l].
//
// What bounds them on this card (H100 SXM, main path m = 8192, N1 = N2 = 64;
// int32 in and out once each; the int8 count is 9 byte products per
// multiply-add at 1,979 TOP/s; memory at 3.35 TB/s):
//   fsi_ct_fwd [256, 12, 4096]: 100.7 MB, 30.0 us memory vs 14.7 us int8:
//     bound by bytes;
//   fsi_ct_fwd_digits [768, 4096] -> [768, 8, 4096]: 113.2 MB, 33.8 us
//     vs 29.3 us: bytes;
//   fsi_ct_inv [192, 12, 4096]: 75.5 MB, 22.5 us vs 11.0 us: bytes;
//   fsi_ct_inv [128, 8, 4096]: 33.6 MB, 10.0 us vs 4.9 us: bytes.
//
// The design:
// * Stages on the int8 tensor cores.  Table entries (< 2^23) and operands
//   (residues < 2^23, digits < 2^24) are split into three unsigned byte
//   planes; each stage is the 9 plane products
//   mma.sync.m16n8k32.row.col.s32.u8.u8.s32, accumulated in s32 per
//   diagonal d = a + b (d = 0..4).  A diagonal sums at most 3 plane
//   products of K terms below 255^2: 3 * K * 255^2 < 2^31 for K <= 11,008,
//   so it is exact for every K the kernels take (K <= 128: the shared
//   memory caps m at 2^15).  The diagonals stand for
//   v = sum_d D_d 2^(8d) < K * 2^23 * 2^24 <= 2^60.
// * No 64-bit %.  v mod q is computed from the diagonals in 32 bits with
//   Shoup's reciprocals, precomputed per prime on the host (ops/ntt_ct_cuda.py
//   kernel_tables): for w < q and w' = floor(w 2^32 / q), any a < 2^32
//   gives a*w - umulhi(a, w')*q in [0, 2q).  So
//     s = D_0 + sum_{d=1..4} shoup(D_d, 2^(8d) mod q)  < 2^31 + 8q < 2^32,
//     v mod q = csub(shoup(s, 1)),
//   four 32-bit multiply triples and one conditional subtraction.  The
//   twiddle multiply is one more Shoup product with a per-entry w' table.
// * Tables in shared memory, reused across a tile of rows.  One block per
//   (prime, tile of rows); the grid is one wave of the card, so a block
//   loads its prime's A1 and A2 byte planes (15 KB each at 64 x 64) and the
//   twiddle with its reciprocals (36 KB) once and runs every row of its
//   tile.  The L primes of a tile are adjacent in launch order, so a digit
//   row is read from device memory once and from L2 by the other primes'
//   blocks.  A residue row (ct_fwd, ct_inv) is read by one block only.
//   Either way a (row, prime) moves 16 KB in and 16 KB out, a quarter of
//   the tables' 66 KB, so tiling by prime rather than by row moves fewer
//   bytes: the prime's tables stay resident for the whole tile.  The next
//   row is fetched into registers while the current one computes.
// * Layouts unchanged: the input and output orders above.  The output is
//   stored as 16-byte vectors (a lane-pair shuffle of the mma fragments),
//   every 32-byte sector written whole.
// * Shapes below the mma tile (m = 32 is 4 x 4) are zero-padded inside
//   the kernel: the host pads the table planes with zero rows and columns,
//   so padded operand bytes multiply zeros and padded outputs are never
//   stored.  The wrapper raises where a shape exceeds shared memory.
// * m = 2^15 (N1 = N2 = 128).  The four byte-plane blocks A1, A2, B1, B2
//   take 55,296 bytes each, 221,184 of a block's 232,448; the twiddle
//   pairs (139,264 bytes) do not fit beside them.  Geo keeps the twiddle
//   in shared memory wherever the whole layout fits (every m <= 2^14) and
//   otherwise leaves it in global memory, where the stage-1 epilogue
//   reads each (w, w') pair with a 16-byte __ldg (a prime's 136 KB stays
//   in L2).  The input prefetch there takes 16
//   tiles per warp (64 registers), past the 128-register cap of two blocks
//   per SM.  The 221 KB layout leaves one block per SM anyway, so TPW = 16
//   is built with __launch_bounds__(256, 1) (up to 255 registers) and
//   keeps the register prefetch: with only 8 warps on an SM, the next
//   row's loads overlapping the current row's stages matter more, not
//   less, than at two blocks.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPlanes = 3;       // bytes of a table entry or an operand
constexpr int kConsts = 10;      // per prime: q, floor(2^32/q), c[4], c'[4]
constexpr int kSmemMax = 232448; // a block's opt-in shared memory on sm_90

__host__ __device__ constexpr int pad_to(int x, int a) { return (x + a - 1) / a * a; }

// Shared-memory geometry of one (S, R) transform.  Byte planes are stored
// row-major with K contiguous and a row stride Ks = pad32(K) + 16 bytes
// (4 mod 8 words: ldmatrix rows and the operand stores are conflict-free);
// A planes [3][pad16(M)][Ks], B planes transposed, [3][pad16(N)][Ks].
// The twiddle pairs follow A2 where the whole layout fits in kSmemMax,
// and stay in global memory otherwise (header: m = 2^15).
struct Geo {
  int S, R;
  int Kp1, Ks1, Mp1, Np1;   // stage 1: A1 [S x S] @ in [S x R]
  int Kp2, Ks2, Mp2, Np2;   // stage 2: A2 [R x R] @ C1^T [R x S]
  int tws;                  // twiddle row stride in words: (tw, tw') pairs
  bool tw_shared;           // the twiddle pairs in shared memory
  __host__ __device__ Geo(int s, int r)
      : S(s), R(r),
        Kp1(pad_to(s, 32)), Ks1(pad_to(s, 32) + 16), Mp1(pad_to(s, 16)), Np1(pad_to(r, 16)),
        Kp2(pad_to(r, 32)), Ks2(pad_to(r, 32) + 16), Mp2(pad_to(r, 16)), Np2(pad_to(s, 16)),
        tws(2 * r + 16), tw_shared(planes_bytes() + tw_bytes() <= kSmemMax) {}
  __host__ __device__ int a1_bytes() const { return kPlanes * Mp1 * Ks1; }
  __host__ __device__ int a2_bytes() const { return kPlanes * Mp2 * Ks2; }
  __host__ __device__ int tw_bytes() const { return S * tws * 4; }
  __host__ __device__ int b1_plane() const { return Np1 * Ks1; }
  __host__ __device__ int b2_plane() const { return Np2 * Ks2; }
  __host__ __device__ int planes_bytes() const {
    return a1_bytes() + a2_bytes() + kPlanes * (b1_plane() + b2_plane());
  }
  __host__ __device__ int tw_smem_bytes() const { return tw_shared ? tw_bytes() : 0; }
  __host__ __device__ int smem_bytes() const { return planes_bytes() + tw_smem_bytes(); }
};

struct PrimeConsts {
  uint32_t q, qr, c[4], cp[4];
};

// a * w mod q in [0, 2q) for w < q, wp = floor(w 2^32 / q), any a < 2^32
__device__ __forceinline__ uint32_t shoup(uint32_t a, uint32_t w, uint32_t wp, uint32_t q) {
  return a * w - __umulhi(a, wp) * q;
}

__device__ __forceinline__ uint32_t csub(uint32_t r, uint32_t q) { return r >= q ? r - q : r; }

// sum_d acc[d][i] 2^(8d) mod q, canonical (header: "No 64-bit %")
__device__ __forceinline__ uint32_t reduce_diagonals(const uint32_t (&acc)[5][4], int i,
                                                     const PrimeConsts& k) {
  uint32_t s = acc[0][i];
#pragma unroll
  for (int d = 0; d < 4; ++d) s += shoup(acc[d + 1][i], k.c[d], k.cp[d], k.q);
  return csub(shoup(s, 1u, k.qr, k.q), k.q);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const uint8_t* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

__device__ __forceinline__ void mma_u8(uint32_t (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One warp's 16 x 16 output tile (two m16n8 tiles) of A @ B over Kp:
// acc[t][d] holds diagonal d of n-tile t.  A [3][*][Ks] at rows m0..,
// Bt [3][*][Ks] at rows n0.. (both K-contiguous).
__device__ __forceinline__ void mma_tile(uint32_t (&acc)[2][5][4], const uint8_t* A,
                                         int a_plane, const uint8_t* Bt, int b_plane,
                                         int Ks, int Kp, int m0, int n0, int lane) {
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int d = 0; d < 5; ++d)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[t][d][i] = 0;
  // ldmatrix x4 row addresses: A fragments a0..a3 are (rows 0-7 | 8-15) x
  // (k 0-15 | 16-31); B fragments (b0, b1) of n-tile 0, then of n-tile 1
  const int mat = lane >> 3, r = lane & 7;
  const uint8_t* pa = A + (m0 + r + (mat & 1) * 8) * Ks + (mat >> 1) * 16;
  const uint8_t* pb = Bt + (n0 + r + (mat >> 1) * 8) * Ks + (mat & 1) * 16;
  for (int k0 = 0; k0 < Kp; k0 += 32) {
    uint32_t a[kPlanes][4], b[kPlanes][4];
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) {
      ldsm_x4(a[p], pa + p * a_plane + k0);
      ldsm_x4(b[p], pb + p * b_plane + k0);
    }
#pragma unroll
    for (int pa_ = 0; pa_ < kPlanes; ++pa_)
#pragma unroll
      for (int pb_ = 0; pb_ < kPlanes; ++pb_)
#pragma unroll
        for (int t = 0; t < 2; ++t)
          mma_u8(acc[t][pa_ + pb_], a[pa_], b[pb_][2 * t], b[pb_][2 * t + 1]);
  }
}

__device__ __forceinline__ void copy16(void* dst, const void* src, int bytes, int tid) {
  const uint4* s = static_cast<const uint4*>(src);
  uint4* d = static_cast<uint4*>(dst);
  for (int i = tid; i < bytes / 16; i += kThreads) d[i] = __ldg(s + i);
}

// One block per (prime blockIdx.x, tile of rows blockIdx.y).  x is the
// row [S][R]: digits [rows, N] shared by every prime (DIGITS) or
// residues/evaluations [rows, L, N]; out [rows, L, N] as [R][S].  TPW:
// input tiles of 8 columns x 16 rows per warp (a compile-time count, so
// the prefetched row stays in registers).  Two blocks per SM up to 8
// tiles; one at 16 (m = 2^15, whose layout leaves one block per SM).
template <bool DIGITS, int TPW>
__global__ void __launch_bounds__(kThreads, TPW > 8 ? 1 : 2)
ct_mma_kernel(const int32_t* __restrict__ x, const uint8_t* __restrict__ a1g,
              const uint8_t* __restrict__ a2g, const uint32_t* __restrict__ twg,
              const uint32_t* __restrict__ kcg, int32_t* __restrict__ out,
              long long rows, int rows_per_tile, int L, int S, int R) {
  extern __shared__ __align__(16) uint8_t mma_smem[];
  const Geo G(S, R);
  uint8_t* a1 = mma_smem;
  uint8_t* a2 = a1 + G.a1_bytes();
  uint32_t* tw = reinterpret_cast<uint32_t*>(a2 + G.a2_bytes());
  uint8_t* b1 = reinterpret_cast<uint8_t*>(tw) + G.tw_smem_bytes();
  uint8_t* b2 = b1 + kPlanes * G.b1_plane();
  const int l = blockIdx.x;
  const int N = S * R;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long row_begin = static_cast<long long>(blockIdx.y) * rows_per_tile;
  const long long row_end = min(rows, row_begin + rows_per_tile);

  // the prime's tables, once per block (the first barrier below orders them)
  copy16(a1, a1g + static_cast<size_t>(l) * G.a1_bytes(), G.a1_bytes(), tid);
  copy16(a2, a2g + static_cast<size_t>(l) * G.a2_bytes(), G.a2_bytes(), tid);
  const uint32_t* twl = twg + static_cast<size_t>(l) * (G.tw_bytes() / 4);
  if (G.tw_shared) copy16(tw, twl, G.tw_bytes(), tid);
  PrimeConsts k;
  k.q = __ldg(kcg + l * kConsts);
  k.qr = __ldg(kcg + l * kConsts + 1);
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    k.c[d] = __ldg(kcg + l * kConsts + 2 + d);
    k.cp[d] = __ldg(kcg + l * kConsts + 6 + d);
  }

  // Input tiles: a warp takes 8 columns n x 4 groups of 4 rows k, so its
  // loads are whole 32-byte sectors and its plane stores hit 32 banks.
  const int R8 = (R + 7) / 8, in_tiles = R8 * ((S + 15) / 16);
  const int nl = lane & 7, kl = lane >> 3;
  uint32_t pre[TPW][4];
  auto fetch = [&](long long row) {
    const int32_t* in = DIGITS ? x + row * N : x + (row * L + l) * N;
#pragma unroll
    for (int s = 0; s < TPW; ++s) {
      const int tile = warp + kWarps * s;
      const int n = (tile % R8) * 8 + nl, kg = (tile / R8) * 4 + kl;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kk = 4 * kg + j;
        pre[s][j] = (tile < in_tiles && n < R && kk < S)
                        ? static_cast<uint32_t>(__ldg(in + kk * R + n)) : 0u;
      }
    }
  };
  auto split = [&]() {   // the fetched row as byte planes B1[p][n][k]
#pragma unroll
    for (int s = 0; s < TPW; ++s) {
      const int tile = warp + kWarps * s;
      if (tile < in_tiles) {
        const int n = (tile % R8) * 8 + nl, kg = (tile / R8) * 4 + kl;
        uint8_t* dst = b1 + n * G.Ks1 + 4 * kg;
#pragma unroll
        for (int p = 0; p < kPlanes; ++p) {
          const uint32_t sel = p | ((p + 4) << 4);
          const uint32_t lo = __byte_perm(pre[s][0], pre[s][1], sel);
          const uint32_t hi = __byte_perm(pre[s][2], pre[s][3], sel);
          *reinterpret_cast<uint32_t*>(dst + p * G.b1_plane()) = __byte_perm(lo, hi, 0x5410);
        }
      }
    }
  };

  const int g = lane >> 2, tq = lane & 3;
  if (row_begin < row_end) fetch(row_begin);
  for (long long row = row_begin; row < row_end; ++row) {
    split();
    __syncthreads();   // B1 written; B2 free (the last row's stage 2 is done)
    if (row + 1 < row_end) fetch(row + 1);

    // stage 1: C1 = A1 @ in, reduce, twiddle, byte planes into B2[p][m][n]
    const int nu1 = G.Np1 / 16;
    for (int u = warp; u < (G.Mp1 / 16) * nu1; u += kWarps) {
      const int m0 = (u / nu1) * 16, n0 = (u % nu1) * 16;
      uint32_t acc[2][5][4];
      mma_tile(acc, a1, G.Mp1 * G.Ks1, b1, G.b1_plane(), G.Ks1, G.Kp1, m0, n0, lane);
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + g + 8 * h, n = n0 + 8 * t + 2 * tq;
          uint32_t y0 = reduce_diagonals(acc[t], 2 * h, k);
          uint32_t y1 = reduce_diagonals(acc[t], 2 * h + 1, k);
          if (m < S && n < R) {        // R is even: n + 1 < R as well
            const int o = m * G.tws + 2 * n;
            const uint4 w = G.tw_shared ? *reinterpret_cast<const uint4*>(tw + o)
                                        : __ldg(reinterpret_cast<const uint4*>(twl + o));
            y0 = csub(shoup(y0, w.x, w.y, k.q), k.q);
            y1 = csub(shoup(y1, w.z, w.w, k.q), k.q);
            uint8_t* dst = b2 + m * G.Ks2 + n;
#pragma unroll
            for (int p = 0; p < kPlanes; ++p)
              *reinterpret_cast<uint16_t*>(dst + p * G.b2_plane()) =
                  static_cast<uint16_t>(__byte_perm(y0, y1, p | ((p + 4) << 4)));
          }
        }
    }
    __syncthreads();   // B2 written; B1 free

    // stage 2: C2 = A2 @ C1^T, reduce, out[m][n] (m < R, n < S)
    int32_t* orow = out + (row * L + l) * N;
    const int nu2 = G.Np2 / 16;
    for (int u = warp; u < (G.Mp2 / 16) * nu2; u += kWarps) {
      const int m0 = (u / nu2) * 16, n0 = (u % nu2) * 16;
      uint32_t acc[2][5][4];
      mma_tile(acc, a2, G.Mp2 * G.Ks2, b2, G.b2_plane(), G.Ks2, G.Kp2, m0, n0, lane);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const uint32_t v0 = reduce_diagonals(acc[t], 0, k), v1 = reduce_diagonals(acc[t], 1, k);
        const uint32_t v2 = reduce_diagonals(acc[t], 2, k), v3 = reduce_diagonals(acc[t], 3, k);
        // lane pairs trade halves: the even lane gets 4 consecutive columns
        // of row g, the odd lane 4 of row g + 8
        const bool odd = tq & 1;
        const uint32_t r0 = __shfl_xor_sync(0xffffffffu, odd ? v0 : v2, 1);
        const uint32_t r1 = __shfl_xor_sync(0xffffffffu, odd ? v1 : v3, 1);
        const uint4 o = odd ? make_uint4(r0, r1, v2, v3) : make_uint4(v0, v1, r0, r1);
        const int m = m0 + g + (odd ? 8 : 0);
        const int n = n0 + 8 * t + 2 * tq - (odd ? 2 : 0);
        if (m < R) {
          int32_t* dst = orow + m * S + n;
          if (S % 4 == 0) {
            if (n < S) *reinterpret_cast<uint4*>(dst) = o;
          } else {                     // S = 2 (m <= 16): element stores
            const uint32_t ov[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (n + j < S) dst[j] = static_cast<int32_t>(ov[j]);
          }
        }
      }
    }
  }
}

// One wave of blocks: each of the L primes gets ceil(slots / L) tiles of
// rows, where slots = SMs x resident blocks per SM.
template <bool DIGITS, int TPW>
cudaError_t launch_mma_tpw(const int32_t* x, const uint8_t* a1, const uint8_t* a2,
                           const uint32_t* tw, const uint32_t* kc, int32_t* out,
                           long long rows, int L, int S, int R, cudaStream_t stream) {
  auto kernel = ct_mma_kernel<DIGITS, TPW>;
  const int smem = Geo(S, R).smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long slots = static_cast<long long>(sms) * per_sm;
  const long long tiles = (slots + L - 1) / L;
  const long long per_tile = (rows + tiles - 1) / tiles;
  const long long ntiles = (rows + per_tile - 1) / per_tile;
  dim3 grid(static_cast<unsigned>(L), static_cast<unsigned>(ntiles));
  kernel<<<grid, kThreads, smem, stream>>>(x, a1, a2, tw, kc, out, rows,
                                           static_cast<int>(per_tile), L, S, R);
  return cudaGetLastError();
}

template <bool DIGITS>
cudaError_t launch_mma(const void* x, const void* a1, const void* a2, const void* tw,
                       const void* kc, void* out, long long rows, int L, int S, int R,
                       void* stream) {
  if (rows < 0 || rows > 0x7fffffffLL || L < 1 || L > 65535 || S < 2 || R < 2 ||
      S > 1024 || R > 1024)
    return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const int in_tiles = ((R + 7) / 8) * ((S + 15) / 16);
  const int tpw = (in_tiles + kWarps - 1) / kWarps;
  const auto args = [&](auto launcher) {
    return launcher(static_cast<const int32_t*>(x), static_cast<const uint8_t*>(a1),
                    static_cast<const uint8_t*>(a2), static_cast<const uint32_t*>(tw),
                    static_cast<const uint32_t*>(kc), static_cast<int32_t*>(out), rows, L, S,
                    R, static_cast<cudaStream_t>(stream));
  };
  if (tpw <= 1) return args(launch_mma_tpw<DIGITS, 1>);
  if (tpw <= 2) return args(launch_mma_tpw<DIGITS, 2>);
  if (tpw <= 4) return args(launch_mma_tpw<DIGITS, 4>);
  if (tpw <= 8) return args(launch_mma_tpw<DIGITS, 8>);
  if (tpw <= 16) return args(launch_mma_tpw<DIGITS, 16>);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x [rows, L, N] residues in [0, q); out [rows, L, N] evaluations.
// a1 / a2: the byte planes of t2 / t1, tw: the transposed twiddle with its
// reciprocals, kc: the per-prime constants (ops/ntt_ct_cuda.py
// kernel_tables).
int fsi_ct_fwd(const void* x, const void* a1, const void* a2, const void* tw,
               const void* kc, void* out, long long rows, int L, int N1, int N2,
               void* stream) {
  return launch_mma<false>(x, a1, a2, tw, kc, out, rows, L, N2, N1, stream);
}

// x [rows, N] digits below 2^24 shared by every prime; out [rows, L, N].
// The tables of fsi_ct_fwd.
int fsi_ct_fwd_digits(const void* x, const void* a1, const void* a2, const void* tw,
                      const void* kc, void* out, long long rows, int L, int N1,
                      int N2, void* stream) {
  return launch_mma<true>(x, a1, a2, tw, kc, out, rows, L, N2, N1, stream);
}

// e [rows, L, N] evaluations; out [rows, L, N] coefficients in [0, q).
// a1 / a2: the byte planes of t1i / t2i (or t2i_crt), tw: twi with its
// reciprocals, kc: the per-prime constants.
int fsi_ct_inv(const void* e, const void* a1, const void* a2, const void* tw,
               const void* kc, void* out, long long rows, int L, int N1, int N2,
               void* stream) {
  return launch_mma<false>(e, a1, a2, tw, kc, out, rows, L, N1, N2, stream);
}

// Dynamic shared memory of the layout chosen for fsi_ct_fwd and
// fsi_ct_fwd_digits (S = N2, R = N1) and for fsi_ct_inv (S = N1, R = N2),
// and the current device's per-block limit.
long long fsi_ct_mma_smem(int S, int R) { return Geo(S, R).smem_bytes(); }

int fsi_smem_optin() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess)
    return -1;
  return bytes;
}

}  // extern "C"
