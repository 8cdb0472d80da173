// Two-level Cooley-Tukey NTT kernels for both residue lanes (primes
// q < 2^23, q >= 2^14), written for Hopper (sm_90a).  They compute the
// N-point transform (N = m/2 = N1 * N2) of every ring m = 2^a * q^b whose
// split has N1, N2 >= 2 and fits in shared memory: every power of two up
// to m = 2^15, and mixed-radix splits such as 128 x 80 (m = 20480) and
// 81 x 81 (m = 13122).  The wrappers (ops/ntt_ct_cuda.py) check the split
// before launching; on a mixed-radix ring the kernel also does the
// phim <-> N pad, drop, insert and fold in its loads and stores (below,
// "the phim <-> N steps"), so a transform reads and writes phim-wide rows
// in one launch.
//
// Replaces the three Pallas TPU kernels of fhe_si_tpu/ops/ntt_ct_pallas.py
// with one tensor-core kernel, ct_mma_kernel<DIGITS, TPW, SCHED, PHIM>
// (SCHED its schedule, below):
//   fsi_ct_fwd        <- _fwd_res_kernel    (:148)  DIGITS false, S = N2
//   fsi_ct_fwd_digits <- _fwd_digits_kernel (:137)  DIGITS true,  S = N2
//   fsi_ct_inv        <- _inv_kernel        (:158)  DIGITS false, S = N1
//
// What they compute (the index maps of fhe_si_tpu_torch/ops/ntt_ct.py
// ct_*_n):
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
// At m = 2^15 (N1 = N2 = 128) the int8 count, 2 * 9 * N * (N1 + N2) per
// (row, prime), is what bounds them: the 36,928 (row, prime) transforms
// of the wide mul+relin at 64 pairs take 1.41 ms of int8 operations
// against 0.99 ms of int32 bytes.
//
// The design:
// * Stages on the int8 tensor cores.  Table entries (< 2^23) and operands
//   (residues < 2^23, digits < 2^24) are split into three unsigned byte
//   planes; each stage is the 9 plane products
//   mma.sync.m16n8k32.row.col.s32.u8.u8.s32, accumulated in s32 per
//   diagonal d = a + b (d = 0..4).  A diagonal sums at most 3 plane
//   products of K terms below 255^2: 3 * K * 255^2 < 2^31 for K <= 11,008,
//   so it is exact for every K the kernels take (K <= 1024, launch_mma's
//   guard).  The diagonals stand for
//   v = sum_d D_d 2^(8d) < K * 2^23 * 2^24 <= 2^57.
// * No 64-bit %.  v mod q is computed from the diagonals in 32 bits with
//   Shoup's reciprocals, precomputed per prime on the host (ops/ntt_ct_cuda.py
//   kernel_tables): for w < q and w' = floor(w 2^32 / q), any a < 2^32
//   gives a*w - umulhi(a, w')*q in [0, 2q).  So
//     s = D_0 + sum_{d=1..4} shoup(D_d, 2^(8d) mod q)  < 2^31 + 8q < 2^32,
//     v mod q = csub(shoup(s, 1)),
//   four 32-bit multiply triples and one conditional subtraction.  The
//   twiddle multiply is one more Shoup product with a per-entry w' table.
// * Tables in shared memory, reused across a tile of rows.  One block per
//   (prime, tile of rows); the grid is one wave of the card, or a few
//   whole ones (sync_tiles), so a block loads its prime's A1 and A2 byte
//   planes (15 KB each at 64 x 64) and the twiddle with its reciprocals
//   (36 KB) once and runs every row of its tile.  The L primes of a tile
//   are adjacent in launch order, so a digit row is read from device memory once and from L2 by the other primes'
//   blocks.  A residue row (ct_fwd, ct_inv) is read by one block only.
//   Either way a (row, prime) moves 16 KB in and 16 KB out, a quarter of
//   the tables' 66 KB, so tiling by prime rather than by row moves fewer
//   bytes: the prime's tables stay resident for the whole tile.  The next
//   row is fetched into registers while the current one computes.
// * Layouts unchanged: the input and output orders above.  The output is
//   stored as 16-byte vectors (a lane-pair shuffle of the mma fragments),
//   every 32-byte sector written whole.
// * Shapes below the mma tile (m = 32 is 4 x 4), and sides that are not
//   multiples of it (m = 20480 is 128 x 80, m = 54 is 9 x 3), are
//   zero-padded inside the kernel: the host pads the table planes with
//   zero rows and columns, so padded operand bytes multiply zeros and
//   padded outputs are never stored.  The wrapper raises where a shape
//   exceeds shared memory or a side is 1 (m = 2q: N2 = 1).
// * Odd R (m = 40 is 5 x 4 forward, m = 13122 is 81 x 81).  The stage-1
//   epilogue handles output columns in pairs (n, n + 1), n even.  At
//   n = R - 1 the column n + 1 = R is a B1 row that fetch() zeroes (the
//   input tile of 8 columns reaches pad8(R) > R), its twiddle pair is the
//   row's zero padding, and it lands in B2's K padding at column R, which
//   the zero columns R.. of A2 cancel.  The twiddle row stride Geo::tws is
//   2R + 16 rounded up to a multiple of 4 words, so every 16-byte twiddle
//   load, and each prime's twiddle base, is aligned whatever R is
//   (ops/ntt_ct_cuda.py tw_stride makes the host rows the same).
// * S not a multiple of 4 (S = 2 at m <= 16, S = 6 at m = 96 forward,
//   S = 9 at m = 54 inverse): an output row [R][S] is not a multiple of
//   16 bytes, so stage 2 stores element by element.
// * m = 2^15 (N1 = N2 = 128) on this schedule (fsi_ct_sync; the
//   transforms there run the rowsplit schedule, below).  The four
//   byte-plane blocks A1, A2, B1, B2
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
//
// ---- three schedules of ct_mma_kernel ----
// launch_mma picks the schedule from the split (S, R), which the input's
// shape fixes (fsi_ct_schedule; ops/ntt_ct_cuda.py kernel_schedule
// mirrors the rule):
// * sync: everything above, for every split neither wgmma schedule takes
//   (m <= 4096, mixed radix, odd R, S not a multiple of 4), and for
//   every launch with the phim <-> N steps.
// * pingpong: both sides multiples of 64, at most 8192 entries a row, and
//   the two-row layout inside kSmemMax (m = 8192: 64 x 64; m = 2^14:
//   64 x 128 and 128 x 64).  What held the sync schedule at m = 8192 was
//   neither pipe: without its mma.sync a row took 5% less time, without
//   its reductions 21% less; each row ran split, products and epilogue in
//   series behind block-wide barriers, and the 16 warps of an SM stalled.
//   Here one block of two consumer warpgroups runs on each SM; each
//   warpgroup owns alternate rows of the block's tile and its own B1/B2
//   planes, and runs a stage's m64 x n64 tile as 2 K-steps x 9 plane
//   products of asynchronous wgmma.mma_async.m64n64k32.s32.u8.u8 (both
//   operands K-major in shared memory, the int8 rate only wgmma reaches,
//   no ldmatrix), one commit group.  While one warpgroup waits for its
//   products the other's Shoup epilogue issues on the integer pipes;
//   nothing orders the two (a named-barrier hand-off after issue made a
//   row no faster, one after the products landed 5-7% slower), and no
//   block-wide barrier follows the tables' load.  ptxas serializes every wgmma of a
//   kernel (C7520) if any branch in the row loop depends on the thread, so
//   the loops around them have compile-time counts, the warpgroup index is
//   broadcast from lane 0, and the one predicated store is in the asm.  The
//   planes are stored in core matrices (8 rows x 16 bytes, no swizzle):
//   the tables re-laid as they are loaded, B1 by the split, B2 by the
//   stage-1 epilogue.  The arithmetic is the sync schedule's five s32
//   diagonals and Shoup reductions; the stage-1 twiddle's Shoup product
//   also reduces the folded diagonals, and every stage's output is
//   canonical, so the outputs are bit-identical.
// * rowsplit: sides multiples of 64, S * R a power of two above 8192
//   (phim = N), a split the ping-pong does not take, and one row's planes
//   in core matrices inside kSmemMax: m = 2^15, 128 x 128, whose two
//   rows' planes (294,912 bytes) do not fit the ping-pong.  One row at a
//   time on a block, as the sync schedule, with its A1, A2, B1 and B2
//   byte planes laid as the ping-pong lays them (196,608 bytes; the
//   twiddle pairs stay in global memory) and the grid of sync_tiles.
//   Each stage is split between the two warpgroups by 64-row halves of
//   M; a warpgroup runs its half as m64 x n64 tiles of 4 K-steps x 9
//   plane products of asynchronous wgmma, one commit group a tile, and
//   reduces a landed tile while the other warpgroup's products run.
//   Block-wide barriers stand only where the data needs them: B1 written
//   before stage 1; all of B2 written before stage 2 (whose K spans both
//   halves); B2 free before the next row's stage 1.  The next row is
//   fetched in two halves of 32 registers: the first under stage 1,
//   split into B1 once stage 2's first products are issued (stage 2 does
//   not read B1); the second under stage 2.  The arithmetic is the
//   ping-pong's (fold_diagonals and the twiddle's Shoup product in stage
//   1, reduce_diagonals in stage 2), so the outputs are bit-identical,
//   and the loops around the wgmmas have compile-time counts and no
//   branch on the thread.  Measured on the wide cell's shapes (H100
//   SXM): a warpgroup that issues its next tile's products before it
//   reduces the current tile (m64 x n32, two accumulator sets) spilled
//   220-344 bytes and took 129-156 ns a (row, prime) against 109-126 ns
//   here: the other warpgroup's products already fill the tensor cores,
//   and n64 tiles read each A byte plane from shared memory half as often.
//   The products alone take about 50-56 ns a (row, prime); the epilogues,
//   twiddle loads and the row's fetch the rest.
//
// ---- the phim <-> N steps ----
// A ring m = 2^a * q^b with q odd has phim = N (q - 1)/q < N; its
// transforms take and give phim-wide rows (ops/ntt_ct.py module header:
// s = N/q, u0 = (q - 1)/2).  The sync schedule does the four index maps
// there in its fetch and store, chosen at compile time (PHIM; the launch
// passes phim and q only where phim < N, and every m = 2^k instantiation
// is the code without them).  The rows already sit whole in registers
// and shared memory, so no N-wide row crosses device memory:
// * kPhimFwd (fsi_ct_fwd, fsi_ct_fwd_digits).  Pad: the fetch reads
//   coefficient c = kk R + n of a row of stride phim, and 0 at c >= phim
//   (at m = 20480, 80 x 128, the rows kk >= 64), so stage 1's K stops at
//   the last row that can be nonzero (64 of 96 there).  Drop: stage 2
//   stores evaluation u = n + S m only where u mod q != u0, at its index
//   u - ceil((u - u0)/q) of the phim-wide output row, one word at a time
//   (a group of 4 columns straddles an excluded u or a 16-byte boundary).
// * kPhimInv (fsi_ct_inv).  Insert: the fetch reads evaluation u = n + R kk
//   at that compacted index, and 0 where u mod q = u0.  Fold: stage 2
//   first runs the tiles that hold the tail c = n + S m >= phim and keeps
//   its s words in shared memory (Geo::fold, 8 KB at m = 20480); after a
//   barrier it runs the tiles that hold the head c < phim, adds to each
//   the tail word of c mod s, times (-1)^(floor(c/s) + 1) (as mod_add:
//   + q - t on the even blocks, + t on the odd, one csub), and stores
//   only c < phim, in 16-byte vectors where S and phim are multiples of 4.
//   A tile that holds both runs in both passes (none at 128 x 80, whose
//   tail is the rows m >= 64).  The next row's stage 2 rewrites the tail
//   only after the two barriers of its split and stage 1.  The CRT
//   premultiplier of t2i_crt stays in stage 2's table: the fold is linear.
// N is below 2^16 for every split whose planes fit a block, so the
// divisions by q and s are one __umulhi each by ceil(2^32 / d) (divide).
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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
// and stay in global memory otherwise (header: m = 2^15).  The fold's
// tail (header: "the phim <-> N steps") follows B2.
struct Geo {
  int S, R;
  int Kp1, Ks1, Mp1, Np1;   // stage 1: A1 [S x S] @ in [S x R]
  int Kp2, Ks2, Mp2, Np2;   // stage 2: A2 [R x R] @ C1^T [R x S]
  int tws;                  // twiddle row stride in words, a multiple of 4: (tw, tw') pairs
  int fold;                 // bytes of the fold's tail: s words, 16-byte rounded; 0 unfolded
  bool tw_shared;           // the twiddle pairs in shared memory
  __host__ __device__ Geo(int s, int r, int fold_words = 0)
      : S(s), R(r),
        Kp1(pad_to(s, 32)), Ks1(pad_to(s, 32) + 16), Mp1(pad_to(s, 16)), Np1(pad_to(r, 16)),
        Kp2(pad_to(r, 32)), Ks2(pad_to(r, 32) + 16), Mp2(pad_to(r, 16)), Np2(pad_to(s, 16)),
        tws(pad_to(2 * r + 16, 4)), fold(pad_to(4 * fold_words, 16)),
        tw_shared(planes_bytes() + fold + tw_bytes() <= kSmemMax) {}
  __host__ __device__ int a1_bytes() const { return kPlanes * Mp1 * Ks1; }
  __host__ __device__ int a2_bytes() const { return kPlanes * Mp2 * Ks2; }
  __host__ __device__ int tw_bytes() const { return S * tws * 4; }
  __host__ __device__ int b1_plane() const { return Np1 * Ks1; }
  __host__ __device__ int b2_plane() const { return Np2 * Ks2; }
  __host__ __device__ int planes_bytes() const {
    return a1_bytes() + a2_bytes() + kPlanes * (b1_plane() + b2_plane());
  }
  __host__ __device__ int tw_smem_bytes() const { return tw_shared ? tw_bytes() : 0; }
  __host__ __device__ int smem_bytes() const { return planes_bytes() + fold + tw_smem_bytes(); }
};

// Which phim <-> N steps a sync-schedule launch does (header)
enum : int { kPhimNone = 0, kPhimFwd = 1, kPhimInv = 2 };

// The ring's phim <-> N geometry, passed by value to every launch (unread
// where PHIM is kPhimNone)
struct PhimMap {
  int P, q, u0, s;    // phim, the odd prime, the excluded residue (q - 1)/2, N/q
  uint32_t qm, sm;    // ceil(2^32 / q), ceil(2^32 / s)
};

// floor(a / d) for a, d < 2^16, dm = ceil(2^32 / d): with e = dm d - 2^32
// < d, a e < 2^32 keeps the quotient exact
__device__ __forceinline__ int divide(int a, uint32_t dm) {
  return static_cast<int>(__umulhi(static_cast<uint32_t>(a), dm));
}

// Evaluation u's index in a phim-wide row, -1 where u mod q = u0
__device__ __forceinline__ int compact(const PhimMap& ph, int u) {
  const int qd = divide(u, ph.qm), r = u - qd * ph.q;
  return r == ph.u0 ? -1 : qd * (ph.q - 1) + r - (r > ph.u0 ? 1 : 0);
}

struct PrimeConsts {
  uint32_t q, qr, c[4], cp[4];
};

// a * w mod q in [0, 2q) for w < q, wp = floor(w 2^32 / q), any a < 2^32
__device__ __forceinline__ uint32_t shoup(uint32_t a, uint32_t w, uint32_t wp, uint32_t q) {
  return a * w - __umulhi(a, wp) * q;
}

__device__ __forceinline__ uint32_t csub(uint32_t r, uint32_t q) { return r >= q ? r - q : r; }

// s = D_0 + sum_{d=1..4} shoup(D_d, 2^(8d) mod q) < 2^31 + 8q, congruent
// to sum_d acc[d][i] 2^(8d) (header: "No 64-bit %"); the four shoups'
// quotients are summed first and multiplied by q once, which leaves s as
// it is mod 2^32
template <int N>
__device__ __forceinline__ uint32_t fold_diagonals(const uint32_t (&acc)[5][N], int i,
                                                   const PrimeConsts& k) {
  uint32_t s = acc[0][i], hi = 0;
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    s += acc[d + 1][i] * k.c[d];
    hi += __umulhi(acc[d + 1][i], k.cp[d]);
  }
  return s - hi * k.q;
}

// sum_d acc[d][i] 2^(8d) mod q, canonical
template <int N>
__device__ __forceinline__ uint32_t reduce_diagonals(const uint32_t (&acc)[5][N], int i,
                                                     const PrimeConsts& k) {
  return csub(shoup(fold_diagonals(acc, i, k), 1u, k.qr, k.q), k.q);
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

__device__ __forceinline__ PrimeConsts load_consts(const uint32_t* kcg, int l) {
  PrimeConsts k;
  k.q = __ldg(kcg + l * kConsts);
  k.qr = __ldg(kcg + l * kConsts + 1);
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    k.c[d] = __ldg(kcg + l * kConsts + 2 + d);
    k.cp[d] = __ldg(kcg + l * kConsts + 6 + d);
  }
  return k;
}

// Stage 2's tile u of a warp on the sync schedule, for the phim <-> N
// stores: C2 = A2 @ C1^T reduced, and per n-tile t the lane's four
// outputs v[t][0..3] at row m[t], columns n[t] .. n[t] + 3 (the lane-pair
// trade of sync_rows' own store).
__device__ __forceinline__ void stage2_tile(uint32_t (&v)[2][4], int (&m)[2], int (&n)[2],
                                            const uint8_t* a2, const uint8_t* b2, const Geo& G,
                                            const PrimeConsts& k, int u, int lane) {
  const int nu2 = G.Np2 / 16;
  const int m0 = (u / nu2) * 16, n0 = (u % nu2) * 16;
  const int g = lane >> 2, tq = lane & 3;
  const bool odd = tq & 1;
  uint32_t acc[2][5][4];
  mma_tile(acc, a2, G.Mp2 * G.Ks2, b2, G.b2_plane(), G.Ks2, G.Kp2, m0, n0, lane);
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const uint32_t v0 = reduce_diagonals(acc[t], 0, k), v1 = reduce_diagonals(acc[t], 1, k);
    const uint32_t v2 = reduce_diagonals(acc[t], 2, k), v3 = reduce_diagonals(acc[t], 3, k);
    const uint32_t r0 = __shfl_xor_sync(0xffffffffu, odd ? v0 : v2, 1);
    const uint32_t r1 = __shfl_xor_sync(0xffffffffu, odd ? v1 : v3, 1);
    v[t][0] = odd ? r0 : v0;
    v[t][1] = odd ? r1 : v1;
    v[t][2] = odd ? v2 : r0;
    v[t][3] = odd ? v3 : r1;
    m[t] = m0 + g + (odd ? 8 : 0);
    n[t] = n0 + 8 * t + 2 * tq - (odd ? 2 : 0);
  }
}

// The sync schedule.  One block per (prime blockIdx.x, tile of rows
// blockIdx.y).  x is the row [S][R]: digits [rows, N] shared by every
// prime (DIGITS) or residues/evaluations [rows, L, N]; out [rows, L, N]
// as [R][S]; with PHIM (header: "the phim <-> N steps") the rows of x and
// out are phim wide.  TPW: input tiles of 8 columns x 16 rows per warp (a
// compile-time count, so the prefetched row stays in registers).  Two
// blocks per SM up to 8 tiles; one at 16 (m = 2^15, whose layout leaves
// one block per SM).
template <bool DIGITS, int TPW, int PHIM>
__device__ __forceinline__ void sync_rows(uint8_t* mma_smem, const int32_t* __restrict__ x,
                                          const uint8_t* __restrict__ a1g,
                                          const uint8_t* __restrict__ a2g,
                                          const uint32_t* __restrict__ twg,
                                          const uint32_t* __restrict__ kcg,
                                          int32_t* __restrict__ out, long long rows,
                                          int rows_per_tile, int L, int S, int R,
                                          const PhimMap ph) {
  const Geo G(S, R, PHIM == kPhimInv ? ph.s : 0);
  uint8_t* a1 = mma_smem;
  uint8_t* a2 = a1 + G.a1_bytes();
  uint32_t* tw = reinterpret_cast<uint32_t*>(a2 + G.a2_bytes());
  uint8_t* b1 = reinterpret_cast<uint8_t*>(tw) + G.tw_smem_bytes();
  uint8_t* b2 = b1 + kPlanes * G.b1_plane();
  uint32_t* tail = reinterpret_cast<uint32_t*>(b2 + kPlanes * G.b2_plane());   // kPhimInv
  const int l = blockIdx.x;
  const int N = S * R;
  const int W = PHIM == kPhimNone ? N : ph.P;   // words of an input or output row
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long row_begin = static_cast<long long>(blockIdx.y) * rows_per_tile;
  const long long row_end = min(rows, row_begin + rows_per_tile);

  // the prime's tables, once per block (the first barrier below orders them)
  copy16(a1, a1g + static_cast<size_t>(l) * G.a1_bytes(), G.a1_bytes(), tid);
  copy16(a2, a2g + static_cast<size_t>(l) * G.a2_bytes(), G.a2_bytes(), tid);
  const uint32_t* twl = twg + static_cast<size_t>(l) * (G.tw_bytes() / 4);
  if (G.tw_shared) copy16(tw, twl, G.tw_bytes(), tid);
  const PrimeConsts k = load_consts(kcg, l);

  // Input tiles: a warp takes 8 columns n x 4 groups of 4 rows k, so its
  // loads are whole 32-byte sectors and its plane stores hit 32 banks.
  const int R8 = (R + 7) / 8, in_tiles = R8 * ((S + 15) / 16);
  const int nl = lane & 7, kl = lane >> 3;
  uint32_t pre[TPW][4];
  auto fetch = [&](long long row) {
    const int32_t* in = DIGITS ? x + row * W : x + (row * L + l) * W;
#pragma unroll
    for (int s = 0; s < TPW; ++s) {
      const int tile = warp + kWarps * s;
      const int n = (tile % R8) * 8 + nl, kg = (tile / R8) * 4 + kl;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kk = 4 * kg + j;
        if constexpr (PHIM == kPhimNone) {
          pre[s][j] = (tile < in_tiles && n < R && kk < S)
                          ? static_cast<uint32_t>(__ldg(in + kk * R + n)) : 0u;
        } else {
          // pad: 0 at c >= phim; insert: 0 at the excluded u
          const int i = kk * R + n;
          const int at = PHIM == kPhimFwd ? (i < ph.P ? i : -1) : compact(ph, i);
          pre[s][j] = (tile < in_tiles && n < R && kk < S && at >= 0)
                          ? static_cast<uint32_t>(__ldg(in + at)) : 0u;
        }
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
  // pad: the rows kk >= ceil(phim / R) are zero, so stage 1's K ends there
  const int kp1 = PHIM == kPhimFwd ? pad_to(min(S, (ph.P + R - 1) / R), 32) : G.Kp1;
  // fold: stage 2's tiles [u_tail, tiles2) hold the tail c >= phim, the
  // tiles [0, u_head) the head (both bounds rise with u)
  const int nu2f = G.Np2 / 16, tiles2 = (G.Mp2 / 16) * nu2f;
  int u_tail = tiles2, u_head = tiles2;
  if constexpr (PHIM == kPhimInv) {
    for (int u = tiles2 - 1; u >= 0; --u) {
      const int m0 = (u / nu2f) * 16, n0 = (u % nu2f) * 16;
      if ((min(m0 + 16, R) - 1) * S + min(n0 + 16, S) - 1 >= ph.P) u_tail = u;
      if (m0 * S + n0 >= ph.P) u_head = u;
    }
  }

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
      mma_tile(acc, a1, G.Mp1 * G.Ks1, b1, G.b1_plane(), G.Ks1, kp1, m0, n0, lane);
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + g + 8 * h, n = n0 + 8 * t + 2 * tq;
          uint32_t y0 = reduce_diagonals(acc[t], 2 * h, k);
          uint32_t y1 = reduce_diagonals(acc[t], 2 * h + 1, k);
          if (m < S && n < R) {        // n + 1 = R (odd R): zero input, zero pair
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
    int32_t* orow = out + (row * L + l) * W;
    if constexpr (PHIM == kPhimNone) {
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
            } else {                     // S % 4 != 0: element stores
              const uint32_t ov[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
              for (int j = 0; j < 4; ++j)
                if (n + j < S) dst[j] = static_cast<int32_t>(ov[j]);
            }
          }
        }
      }
    } else if constexpr (PHIM == kPhimFwd) {
      // drop: evaluation u = n + S m at its compacted index, none at u0
      for (int u = warp; u < tiles2; u += kWarps) {
        uint32_t v[2][4];
        int m[2], n[2];
        stage2_tile(v, m, n, a2, b2, G, k, u, lane);
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int at = compact(ph, m[t] * S + n[t] + j);
            if (m[t] < R && n[t] + j < S && at >= 0) orow[at] = static_cast<int32_t>(v[t][j]);
          }
      }
    } else {
      // fold, first pass: the tail c = n + S m >= phim into shared memory
      for (int u = u_tail + warp; u < tiles2; u += kWarps) {
        uint32_t v[2][4];
        int m[2], n[2];
        stage2_tile(v, m, n, a2, b2, G, k, u, lane);
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = m[t] * S + n[t] + j;
            if (m[t] < R && n[t] + j < S && c >= ph.P) tail[c - ph.P] = v[t][j];
          }
      }
      __syncthreads();   // the tail staged
      // second pass: head c plus the tail word of c mod s, signed by block
      const bool vec = S % 4 == 0 && ph.P % 4 == 0;
      for (int u = warp; u < u_head; u += kWarps) {
        uint32_t v[2][4];
        int m[2], n[2];
        stage2_tile(v, m, n, a2, b2, G, k, u, lane);
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int c = m[t] * S + n[t];
          if (m[t] < R && n[t] < S && c < ph.P) {
            int i = divide(c, ph.sm), r = c - i * ph.s;   // c = i s + r
            uint32_t f[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {   // r stays below s, past phim too
              const uint32_t w = tail[r];
              f[j] = csub(v[t][j] + ((i & 1) ? w : k.q - w), k.q);
              if (++r == ph.s) {
                r = 0;
                ++i;
              }
            }
            if (vec) {   // c and the row base multiples of 4, c + 3 < phim
              *reinterpret_cast<uint4*>(orow + c) = make_uint4(f[0], f[1], f[2], f[3]);
            } else {
#pragma unroll
              for (int j = 0; j < 4; ++j)
                if (n[t] + j < S && c + j < ph.P) orow[c + j] = static_cast<int32_t>(f[j]);
            }
          }
        }
      }
    }
  }
}

// ---- the ping-pong schedule (header: "two schedules") ----
constexpr int kTile = 64;        // a warpgroup's m64 x n64 wgmma tile; the sides' multiple

// Shared memory of one (S, R) transform on the ping-pong schedule: the
// prime's A1 [3][S][S] and A2 [3][R][R], the twiddle pairs where they fit
// (Geo's rule and row stride), then each warpgroup's B1 [3][R][S] and
// B2 [3][S][R]; every plane in core matrices (core_off).
struct PGeo {
  int S, R;
  int tws;
  bool tw_shared;
  __host__ __device__ constexpr PGeo(int s, int r)
      : S(s), R(r), tws(pad_to(2 * r + 16, 4)),
        tw_shared(planes_bytes() + tw_bytes() <= kSmemMax) {}
  __host__ __device__ constexpr int a1_bytes() const { return kPlanes * S * S; }
  __host__ __device__ constexpr int a2_bytes() const { return kPlanes * R * R; }
  __host__ __device__ constexpr int b_plane() const { return S * R; }   // B1 and B2 alike
  __host__ __device__ constexpr int wg_bytes() const { return 2 * kPlanes * b_plane(); }
  __host__ __device__ constexpr int planes_bytes() const {
    return a1_bytes() + a2_bytes() + 2 * wg_bytes();
  }
  __host__ __device__ constexpr int tw_bytes() const { return S * tws * 4; }
  __host__ __device__ constexpr int tw_smem_bytes() const { return tw_shared ? tw_bytes() : 0; }
  __host__ __device__ constexpr int smem_bytes() const { return planes_bytes() + tw_smem_bytes(); }
};

// The split rule (fsi_ct_schedule): sides multiples of 64, a warpgroup's
// prefetched row at most 16 input tiles a warp (S * R <= 8192), and the
// planes of two rows inside kSmemMax.
__host__ __device__ constexpr bool pingpong_takes(int S, int R) {
  return S % kTile == 0 && R % kTile == 0 && S * R <= 8192 &&
         PGeo(S, R).planes_bytes() <= kSmemMax;
}

// Byte (r, k) of a K-major operand [rows][K] in core matrices: 8 rows x
// 16 bytes contiguous, the next 16 bytes of K 128 bytes on (the
// descriptor's leading offset), the next 8 rows 8 K bytes on (its stride
// offset).
__device__ __forceinline__ int core_off(int r, int k, int K) {
  return (r >> 3) * (8 * K) + (k >> 4) * 128 + (r & 7) * 16 + (k & 15);
}

// wgmma shared-memory descriptor of the core-matrix layout at p (no swizzle)
__device__ __forceinline__ uint64_t smem_desc(const uint8_t* p, int K) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) | (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>((8 * K) >> 4) << 32);
}

// d (+)= A[64 x 32] B[32 x 64] over u8, s32; acc = 0 starts the sum
__device__ __forceinline__ void wgmma_u8(uint32_t (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.u8.u8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// the accumulators are read only after the wait that precedes this
__device__ __forceinline__ void fence_acc(uint32_t (&acc)[5][32]) {
#pragma unroll
  for (int d = 0; d < 5; ++d)
#pragma unroll
    for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(acc[d][i])::"memory");
}
// generic-proxy stores to shared memory made visible to wgmma
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
// A global store under a predicate inside the asm: a branch that the
// compiler takes as divergent anywhere in the row loop makes ptxas
// serialize every wgmma (C7520).
__device__ __forceinline__ void st_global_if(bool p, int32_t* dst, const uint4& v) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.b32 q, %0, 0;\n"
      "@q st.global.v4.b32 [%1], {%2, %3, %4, %5};\n}\n" ::"r"(static_cast<int>(p)),
      "l"(dst), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
      : "memory");
}

// One stage C = A [M][K] @ B [N][K]^T of a warpgroup, both operands
// K-major in core matrices: m64 x n64 tiles of K / 32 steps x 9 plane
// products into the five diagonals, one commit group each;
// epi(acc, m0, n0) reduces a landed tile, whose first row is m0 and
// first column n0.
template <int M, int N, int K, typename Epi>
__device__ __forceinline__ void pingpong_stage(const uint8_t* A, const uint8_t* B, Epi&& epi) {
  const uint64_t da = smem_desc(A, K), db = smem_desc(B, K);
#pragma unroll
  for (int m0 = 0; m0 < M; m0 += kTile)
#pragma unroll
    for (int n0 = 0; n0 < N; n0 += kTile) {
      uint32_t acc[5][32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < K / 32; ++kk)
#pragma unroll
        for (int pa = 0; pa < kPlanes; ++pa)
#pragma unroll
          for (int pb = 0; pb < kPlanes; ++pb) {
            // 16-byte units: plane, tile rows (8 rows = 8 K bytes), k step (256 bytes)
            const uint64_t a = da + ((pa * M * K + m0 * K + kk * 256) >> 4);
            const uint64_t b = db + ((pb * N * K + n0 * K + kk * 256) >> 4);
            const bool starts = kk == 0 && (pa == 0 || pb == kPlanes - 1);
            wgmma_u8(acc[pa + pb], a, b, starts ? 0 : 1);
          }
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(acc);
      epi(acc, m0, n0);
    }
}

// The ping-pong schedule (header) of a row [S][R].  One block per (prime
// blockIdx.x, tile of rows blockIdx.y), one block an SM; warpgroup wg
// takes rows row_begin + wg, + 2, ... of the tile.  Every loop around a
// wgmma has a compile-time count and nothing around one branches on the
// thread (ptxas would serialize them): a warpgroup without a row of its
// own in the tile's last pair fetches and transforms the tile's last row
// again and stores nothing.
template <bool DIGITS, int S, int R>
__device__ __forceinline__ void pingpong_rows(uint8_t* mma_smem, const int32_t* __restrict__ x,
                                              const uint8_t* __restrict__ a1g,
                                              const uint8_t* __restrict__ a2g,
                                              const uint32_t* __restrict__ twg,
                                              const uint32_t* __restrict__ kcg,
                                              int32_t* __restrict__ out, long long rows,
                                              int rows_per_tile, int L) {
  constexpr PGeo G(S, R);
  constexpr int N = S * R, R8 = R / 8;
  constexpr int TPW = N / 512;   // input tiles of 8 columns x 16 rows a warp
  constexpr int Ks1 = pad_to(S, 32) + 16, Ks2 = pad_to(R, 32) + 16;   // the host planes' rows
  constexpr int kPlane = G.b_plane(), kTws = G.tws;
  constexpr bool kTwShared = G.tw_shared;
  uint8_t* a1 = mma_smem;
  uint8_t* a2 = a1 + G.a1_bytes();
  uint32_t* tw = reinterpret_cast<uint32_t*>(a2 + G.a2_bytes());
  const int l = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31;
  // warpgroup and its warp, broadcast so that the compiler sees them warp-uniform
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int warp = __shfl_sync(0xffffffffu, (tid >> 5) & 3, 0);
  uint8_t* b1 = reinterpret_cast<uint8_t*>(tw) + G.tw_smem_bytes() + wg * G.wg_bytes();
  uint8_t* b2 = b1 + kPlanes * kPlane;
  const long long row_begin = static_cast<long long>(blockIdx.y) * rows_per_tile;
  const long long row_end = min(rows, row_begin + rows_per_tile);

  // the prime's tables, once per block, the planes re-laid in core matrices
  const auto load_planes = [&](uint8_t* dst, const uint8_t* src, auto m_, auto ks_) {
    constexpr int M = decltype(m_)::value, Ks = decltype(ks_)::value, chunks = M / 16;
    for (int i = tid; i < kPlanes * M * chunks; i += kThreads) {
      const int c = i % chunks, r = (i / chunks) % M, p = i / (chunks * M);
      *reinterpret_cast<uint4*>(dst + p * M * M + core_off(r, 16 * c, M)) =
          __ldg(reinterpret_cast<const uint4*>(src + (p * M + r) * Ks + 16 * c));
    }
  };
  load_planes(a1, a1g + static_cast<size_t>(l) * kPlanes * S * Ks1,
              std::integral_constant<int, S>(), std::integral_constant<int, Ks1>());
  load_planes(a2, a2g + static_cast<size_t>(l) * kPlanes * R * Ks2,
              std::integral_constant<int, R>(), std::integral_constant<int, Ks2>());
  const uint32_t* twl = twg + static_cast<size_t>(l) * (G.tw_bytes() / 4);
  if constexpr (kTwShared) copy16(tw, twl, G.tw_bytes(), tid);
  const PrimeConsts k = load_consts(kcg, l);
  fence_async_smem();
  __syncthreads();

  // input tiles as the sync schedule's, over a warpgroup's 4 warps
  const int nl = lane & 7, kl = lane >> 3;
  uint32_t pre[TPW][4];
  const auto fetch = [&](long long row) {
    const int32_t* in = DIGITS ? x + row * N : x + (row * L + l) * N;
#pragma unroll
    for (int s = 0; s < TPW; ++s) {
      const int tile = warp + 4 * s;
      const int n = (tile % R8) * 8 + nl, kg = (tile / R8) * 4 + kl;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        pre[s][j] = static_cast<uint32_t>(__ldg(in + (4 * kg + j) * R + n));
    }
  };
  const auto split = [&]() {   // the fetched row as byte planes B1[p][n][k]
#pragma unroll
    for (int s = 0; s < TPW; ++s) {
      const int tile = warp + 4 * s;
      const int n = (tile % R8) * 8 + nl, kg = (tile / R8) * 4 + kl;
      uint8_t* dst = b1 + core_off(n, 4 * kg, S);
#pragma unroll
      for (int p = 0; p < kPlanes; ++p) {
        const uint32_t sel = p | ((p + 4) << 4);
        const uint32_t lo = __byte_perm(pre[s][0], pre[s][1], sel);
        const uint32_t hi = __byte_perm(pre[s][2], pre[s][3], sel);
        *reinterpret_cast<uint32_t*>(dst + p * kPlane) = __byte_perm(lo, hi, 0x5410);
      }
    }
  };

  // Both warpgroups run one count of pairs of rows, so that no loop
  // around a wgmma depends on the thread.  Nothing orders the two: while
  // one waits for its products the other's reduction issues, and they
  // fall out of step by themselves.
  const int pairs = static_cast<int>((row_end - row_begin + 1) / 2);

  const int g = lane >> 2, tq = lane & 3;
  long long row = row_begin + wg;
  fetch(min(row, row_end - 1));
  for (int it = 0; it < pairs; ++it, row += 2) {
    const bool active = row < row_end;   // the same for a whole warpgroup
    split();
    fence_async_smem();
    bar_sync(1 + wg, 128);   // B1 written; B2 free (the last row's stage 2 has waited)
    fetch(min(row + 2, row_end - 1));

    // stage 1: C1 = A1 @ in, reduce, twiddle, byte planes into B2[p][m][n]
    pingpong_stage<S, R, S>(
        a1, b1,
        [&](const uint32_t(&acc)[5][32], int m0, int n0) {
#pragma unroll
          for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int m = m0 + 16 * warp + g + 8 * h, n = n0 + 8 * j + 2 * tq;
              const uint32_t s0 = fold_diagonals(acc, 4 * j + 2 * h, k);
              const uint32_t s1 = fold_diagonals(acc, 4 * j + 2 * h + 1, k);
              const int o = m * kTws + 2 * n;
              uint4 w;
              if constexpr (kTwShared)
                w = *reinterpret_cast<const uint4*>(tw + o);
              else
                w = __ldg(reinterpret_cast<const uint4*>(twl + o));
              // the twiddle's Shoup product reduces the folded sums too
              const uint32_t y0 = csub(shoup(s0, w.x, w.y, k.q), k.q);
              const uint32_t y1 = csub(shoup(s1, w.z, w.w, k.q), k.q);
              uint8_t* dst = b2 + core_off(m, n, R);
#pragma unroll
              for (int p = 0; p < kPlanes; ++p)
                *reinterpret_cast<uint16_t*>(dst + p * kPlane) =
                    static_cast<uint16_t>(__byte_perm(y0, y1, p | ((p + 4) << 4)));
            }
        });
    fence_async_smem();
    bar_sync(1 + wg, 128);   // B2 written; B1 free

    // stage 2: C2 = A2 @ C1^T, reduce, out[m][n] (m < R, n < S)
    int32_t* orow = out + (row * L + l) * N;
    pingpong_stage<R, S, R>(
        a2, b2,
        [&](const uint32_t(&acc)[5][32], int m0, int n0) {
#pragma unroll
          for (int j = 0; j < kTile / 8; ++j) {
            const uint32_t v0 = reduce_diagonals(acc, 4 * j, k);
            const uint32_t v1 = reduce_diagonals(acc, 4 * j + 1, k);
            const uint32_t v2 = reduce_diagonals(acc, 4 * j + 2, k);
            const uint32_t v3 = reduce_diagonals(acc, 4 * j + 3, k);
            // lane pairs trade halves, as the sync schedule's stage 2
            const bool odd = tq & 1;
            const uint32_t r0 = __shfl_xor_sync(0xffffffffu, odd ? v0 : v2, 1);
            const uint32_t r1 = __shfl_xor_sync(0xffffffffu, odd ? v1 : v3, 1);
            const uint4 o = odd ? make_uint4(r0, r1, v2, v3) : make_uint4(v0, v1, r0, r1);
            const int m = m0 + 16 * warp + g + (odd ? 8 : 0);
            const int n = n0 + 8 * j + 2 * tq - (odd ? 2 : 0);
            st_global_if(active, orow + m * S + n, o);
          }
        });
  }
}

// ---- the rowsplit schedule (header: "three schedules") ----

// Shared memory of one row [S][R] on the rowsplit schedule: the prime's
// A1 [3][S][S] and A2 [3][R][R], the row's B1 [3][R][S] and B2 [3][S][R],
// every plane in core matrices; the twiddle pairs stay in global memory.
__host__ __device__ constexpr int rowsplit_bytes(int S, int R) {
  return kPlanes * (S * S + R * R) + 2 * kPlanes * S * R;
}

// The split rule (fsi_ct_schedule): sides multiples of 64, S * R a power
// of two above 8192 (phim = N: no phim <-> N step), a split the ping-pong
// does not take, and one row's planes inside kSmemMax.  Only 128 x 128
// (m = 2^15) meets it: 64 x 256 needs 307,200 bytes.
__host__ __device__ constexpr bool rowsplit_takes(int S, int R) {
  return S % kTile == 0 && R % kTile == 0 && S * R > 8192 && (S * R & (S * R - 1)) == 0 &&
         !pingpong_takes(S, R) && rowsplit_bytes(S, R) <= kSmemMax;
}
static_assert(rowsplit_takes(128, 128) && !rowsplit_takes(64, 256) && !rowsplit_takes(256, 64) &&
                  !rowsplit_takes(64, 128) && !rowsplit_takes(192, 64),
              "the rowsplit schedule is built for 128 x 128 alone");

// A prime's table planes [3][M][Ks] (the host's rows) into shared memory
// as [3][M][M] in core matrices
template <int M, int Ks>
__device__ __forceinline__ void load_core_planes(uint8_t* dst, const uint8_t* src, int tid) {
  constexpr int chunks = M / 16;
  for (int i = tid; i < kPlanes * M * chunks; i += kThreads) {
    const int c = i % chunks, r = (i / chunks) % M, p = i / (chunks * M);
    *reinterpret_cast<uint4*>(dst + p * M * M + core_off(r, 16 * c, M)) =
        __ldg(reinterpret_cast<const uint4*>(src + (p * M + r) * Ks + 16 * c));
  }
}

// One stage C = A [M][K] @ B [N][K]^T on the rowsplit schedule: the
// warpgroup's 64 rows of M from row m0, both operands K-major in core
// matrices, as N / 64 tiles of m64 x n64, K / 32 steps x 9 plane products
// each into the five diagonals, one commit group a tile; epi(acc, n0)
// reduces a landed tile whose first column is n0, while the other
// warpgroup's products run.  hook() runs once the first tile's products
// are issued.
template <int M, int N, int K, typename Epi, typename Hook>
__device__ __forceinline__ void rowsplit_stage(const uint8_t* A, const uint8_t* B, int m0,
                                               Epi&& epi, Hook&& hook) {
  static_assert(N % kTile == 0 && K % 32 == 0, "whole n64 tiles, whole K steps");
  // 16-byte units: plane, tile rows (8 rows = 8 K bytes), k step (256 bytes)
  const uint64_t da = smem_desc(A, K) + ((m0 * K) >> 4), db = smem_desc(B, K);
#pragma unroll
  for (int n0 = 0; n0 < N; n0 += kTile) {
    uint32_t acc[5][32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < K / 32; ++kk)
#pragma unroll
      for (int pa = 0; pa < kPlanes; ++pa)
#pragma unroll
        for (int pb = 0; pb < kPlanes; ++pb) {
          const uint64_t a = da + ((pa * M * K + kk * 256) >> 4);
          const uint64_t b = db + ((pb * N * K + n0 * K + kk * 256) >> 4);
          const bool starts = kk == 0 && (pa == 0 || pb == kPlanes - 1);
          wgmma_u8(acc[pa + pb], a, b, starts ? 0 : 1);
        }
    wgmma_commit();
    if (n0 == 0) hook();   // a compile-time test: the loop is unrolled
    wgmma_wait_all();
    fence_acc(acc);
    epi(acc, n0);
  }
}

// The rowsplit schedule (header) of a row [S][R].  One block per (prime
// blockIdx.x, tile of rows blockIdx.y), one block an SM; both warpgroups
// work on each row of the tile, warpgroup wg on the rows 64 wg .. of each
// stage's M.  The row loop's count is the block's; no loop around a
// wgmma branches on the thread, and the last row fetches itself again
// into B1, which nothing reads after it.
template <bool DIGITS, int S, int R>
__device__ __forceinline__ void rowsplit_rows(uint8_t* mma_smem, const int32_t* __restrict__ x,
                                              const uint8_t* __restrict__ a1g,
                                              const uint8_t* __restrict__ a2g,
                                              const uint32_t* __restrict__ twg,
                                              const uint32_t* __restrict__ kcg,
                                              int32_t* __restrict__ out, long long rows,
                                              int rows_per_tile, int L) {
  static_assert(rowsplit_takes(S, R), "a split of the rowsplit rule");
  constexpr int N = S * R, R8 = R / 8;
  constexpr int kHalf = N / 128 / kWarps / 2;   // input tiles a warp in each half of a row
  constexpr int Ks1 = pad_to(S, 32) + 16, Ks2 = pad_to(R, 32) + 16;   // the host planes' rows
  constexpr int kPlane = S * R, kTws = pad_to(2 * R + 16, 4);
  uint8_t* a1 = mma_smem;
  uint8_t* a2 = a1 + kPlanes * S * S;
  uint8_t* b1 = a2 + kPlanes * R * R;
  uint8_t* b2 = b1 + kPlanes * kPlane;
  const int l = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31;
  // warp and warpgroup, broadcast so that the compiler sees them warp-uniform
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int wg = warp >> 2, wq = warp & 3;
  const long long row_begin = static_cast<long long>(blockIdx.y) * rows_per_tile;
  const long long row_end = min(rows, row_begin + rows_per_tile);

  // the prime's tables, once per block, the planes re-laid in core matrices
  load_core_planes<S, Ks1>(a1, a1g + static_cast<size_t>(l) * kPlanes * S * Ks1, tid);
  load_core_planes<R, Ks2>(a2, a2g + static_cast<size_t>(l) * kPlanes * R * Ks2, tid);
  const uint32_t* twl = twg + static_cast<size_t>(l) * S * kTws;
  const PrimeConsts k = load_consts(kcg, l);

  // input tiles as the sync schedule's, over the block's 8 warps, in two
  // halves of kHalf tiles a warp (the rows k < S/2, then the rest)
  const int nl = lane & 7, kl = lane >> 3;
  uint32_t pre[kHalf][4];
  const auto fetch = [&](long long row, int half) {
    const int32_t* in = DIGITS ? x + row * N : x + (row * L + l) * N;
#pragma unroll
    for (int s = 0; s < kHalf; ++s) {
      const int tile = warp + kWarps * (s + kHalf * half);
      const int n = (tile % R8) * 8 + nl, kg = (tile / R8) * 4 + kl;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        pre[s][j] = static_cast<uint32_t>(__ldg(in + (4 * kg + j) * R + n));
    }
  };
  const auto split = [&](int half) {   // the fetched half as byte planes B1[p][n][k]
#pragma unroll
    for (int s = 0; s < kHalf; ++s) {
      const int tile = warp + kWarps * (s + kHalf * half);
      const int n = (tile % R8) * 8 + nl, kg = (tile / R8) * 4 + kl;
      uint8_t* dst = b1 + core_off(n, 4 * kg, S);
#pragma unroll
      for (int p = 0; p < kPlanes; ++p) {
        const uint32_t sel = p | ((p + 4) << 4);
        const uint32_t lo = __byte_perm(pre[s][0], pre[s][1], sel);
        const uint32_t hi = __byte_perm(pre[s][2], pre[s][3], sel);
        *reinterpret_cast<uint32_t*>(dst + p * kPlane) = __byte_perm(lo, hi, 0x5410);
      }
    }
  };

  const int g = lane >> 2, tq = lane & 3;
  const int m_wg = kTile * wg;   // the warpgroup's first row of each stage's M
  fetch(row_begin, 0);
  split(0);
  fetch(row_begin, 1);
  split(1);
  fence_async_smem();
  __syncthreads();   // the tables and the first row's B1
  for (long long row = row_begin; row < row_end; ++row) {
    const long long next = min(row + 1, row_end - 1);
    fetch(next, 0);

    // stage 1: C1 = A1 @ in, the warpgroup's rows of S, reduced by the
    // twiddle's Shoup product, byte planes into B2[p][m][n]
    rowsplit_stage<S, R, S>(
        a1, b1, m_wg,
        [&](const uint32_t(&acc)[5][32], int n0) {
#pragma unroll
          for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int m = m_wg + 16 * wq + g + 8 * h, n = n0 + 8 * j + 2 * tq;
              const uint32_t s0 = fold_diagonals(acc, 4 * j + 2 * h, k);
              const uint32_t s1 = fold_diagonals(acc, 4 * j + 2 * h + 1, k);
              const uint4 w = __ldg(reinterpret_cast<const uint4*>(twl + m * kTws + 2 * n));
              const uint32_t y0 = csub(shoup(s0, w.x, w.y, k.q), k.q);
              const uint32_t y1 = csub(shoup(s1, w.z, w.w, k.q), k.q);
              uint8_t* dst = b2 + core_off(m, n, R);
#pragma unroll
              for (int p = 0; p < kPlanes; ++p)
                *reinterpret_cast<uint16_t*>(dst + p * kPlane) =
                    static_cast<uint16_t>(__byte_perm(y0, y1, p | ((p + 4) << 4)));
            }
        },
        [] {});
    fence_async_smem();
    __syncthreads();   // all of B2 written; B1 free

    // stage 2: C2 = A2 @ C1^T, the warpgroup's rows of R, reduced, out[m][n];
    // the next row's first half goes into B1 under its first products
    int32_t* orow = out + (row * L + l) * N;
    rowsplit_stage<R, S, R>(
        a2, b2, m_wg,
        [&](const uint32_t(&acc)[5][32], int n0) {
#pragma unroll
          for (int j = 0; j < kTile / 8; ++j) {
            const uint32_t v0 = reduce_diagonals(acc, 4 * j, k);
            const uint32_t v1 = reduce_diagonals(acc, 4 * j + 1, k);
            const uint32_t v2 = reduce_diagonals(acc, 4 * j + 2, k);
            const uint32_t v3 = reduce_diagonals(acc, 4 * j + 3, k);
            // lane pairs trade halves, as the sync schedule's stage 2
            const bool odd = tq & 1;
            const uint32_t r0 = __shfl_xor_sync(0xffffffffu, odd ? v0 : v2, 1);
            const uint32_t r1 = __shfl_xor_sync(0xffffffffu, odd ? v1 : v3, 1);
            const uint4 o = odd ? make_uint4(r0, r1, v2, v3) : make_uint4(v0, v1, r0, r1);
            const int m = m_wg + 16 * wq + g + (odd ? 8 : 0);
            const int n = n0 + 8 * j + 2 * tq - (odd ? 2 : 0);
            *reinterpret_cast<uint4*>(orow + m * S + n) = o;
          }
        },
        [&] {
          split(0);
          fetch(next, 1);
        });
    split(1);
    fence_async_smem();
    __syncthreads();   // B1 holds the next row; B2 free (both warpgroups' stage 2 has waited)
  }
}

// The schedules (header): SCHED of ct_mma_kernel, and fsi_ct_schedule's codes
enum : int { kSync = 0, kPingpong = 1, kRowsplit = 2 };

template <bool DIGITS, int TPW, int SCHED, int PHIM>
__global__ void __launch_bounds__(kThreads, SCHED != kSync || TPW > 8 ? 1 : 2)
ct_mma_kernel(const int32_t* __restrict__ x, const uint8_t* __restrict__ a1g,
              const uint8_t* __restrict__ a2g, const uint32_t* __restrict__ twg,
              const uint32_t* __restrict__ kcg, int32_t* __restrict__ out,
              long long rows, int rows_per_tile, int L, int S, int R, PhimMap ph) {
  static_assert(SCHED == kSync || PHIM == kPhimNone, "the wgmma schedules take m = 2^k only");
  extern __shared__ __align__(128) uint8_t mma_smem[];
  if constexpr (SCHED == kRowsplit) {
    rowsplit_rows<DIGITS, 128, 128>(mma_smem, x, a1g, a2g, twg, kcg, out, rows, rows_per_tile, L);
  } else if constexpr (SCHED == kPingpong) {
    if constexpr (TPW == 8)
      pingpong_rows<DIGITS, 64, 64>(mma_smem, x, a1g, a2g, twg, kcg, out, rows, rows_per_tile, L);
    else if (S == 64)
      pingpong_rows<DIGITS, 64, 128>(mma_smem, x, a1g, a2g, twg, kcg, out, rows, rows_per_tile, L);
    else
      pingpong_rows<DIGITS, 128, 64>(mma_smem, x, a1g, a2g, twg, kcg, out, rows, rows_per_tile, L);
  } else
    sync_rows<DIGITS, TPW, PHIM>(mma_smem, x, a1g, a2g, twg, kcg, out, rows, rows_per_tile, L, S,
                                 R, ph);
}

// The row tiles each of the L primes gets on the sync schedule, where
// slots = SMs x resident blocks per SM (ops/ntt_ct_cuda.py sync_tiles
// mirrors it).  A grid of L t blocks runs in ceil(L t / slots) waves of
// ceil(rows / t) rows a block, plus about one row's time a block for its
// table load and first fetch, which nothing hides: the smallest t of
// least waves x (rows a block + 1).  It never costs more than
// ceil(slots / L) tiles a prime, which where one block fits an SM
// (m = 2^15, m = 20480) runs a short second wave while nearly every SM
// idles.  Without the + 1 it would take many waves of 2- or 3-row tiles.
__host__ long long sync_tiles(long long rows, long long L, long long slots) {
  long long best = 1, least = -1;
  for (long long t = 1; t <= rows && t <= slots; ++t) {
    const long long cost = ((L * t + slots - 1) / slots) * ((rows + t - 1) / t + 1);
    if (least < 0 || cost < least) {
      least = cost;
      best = t;
    }
  }
  return best;
}

// A launch's grid: L primes x ntiles tiles of per_tile rows, on slots
// resident blocks
struct MmaGrid {
  long long slots, per_tile, ntiles;
};

// The sync and rowsplit schedules take sync_tiles; the ping-pong
// floor(slots / L), whose one block an SM would otherwise leave a second,
// short wave.  With grid_only, the grid is written there and nothing is
// launched.
template <bool DIGITS, int TPW, int SCHED, int PHIM>
cudaError_t launch_mma_tpw(const int32_t* x, const uint8_t* a1, const uint8_t* a2,
                           const uint32_t* tw, const uint32_t* kc, int32_t* out,
                           long long rows, int L, int S, int R, const PhimMap& ph,
                           cudaStream_t stream, MmaGrid* grid_only) {
  auto kernel = ct_mma_kernel<DIGITS, TPW, SCHED, PHIM>;
  const int smem = SCHED == kPingpong   ? PGeo(S, R).smem_bytes()
                   : SCHED == kRowsplit ? rowsplit_bytes(S, R)
                                        : Geo(S, R, PHIM == kPhimInv ? ph.s : 0).smem_bytes();
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
  const long long tiles =
      SCHED == kPingpong ? (slots >= L ? slots / L : 1) : sync_tiles(rows, L, slots);
  const long long per_tile = (rows + tiles - 1) / tiles;
  const long long ntiles = (rows + per_tile - 1) / per_tile;
  if (grid_only) {
    *grid_only = MmaGrid{slots, per_tile, ntiles};
    return cudaSuccess;
  }
  dim3 grid(static_cast<unsigned>(L), static_cast<unsigned>(ntiles));
  kernel<<<grid, kThreads, smem, stream>>>(x, a1, a2, tw, kc, out, rows,
                                           static_cast<int>(per_tile), L, S, R, ph);
  return cudaGetLastError();
}

// PHIM: the phim <-> N steps of the launch (kPhimNone on m = 2^k, and on
// the two wgmma schedules, which take only m = 8192, 2^14 and 2^15);
// allow_wgmma false keeps the sync schedule on every split (fsi_ct_sync)
template <bool DIGITS, int PHIM = kPhimNone>
cudaError_t launch_mma(const void* x, const void* a1, const void* a2, const void* tw,
                       const void* kc, void* out, long long rows, int L, int S, int R,
                       void* stream, bool allow_wgmma = true, PhimMap ph = PhimMap{},
                       MmaGrid* grid_only = nullptr) {
  if (rows < 0 || rows > 0x7fffffffLL || L < 1 || L > 65535 || S < 2 || R < 2 ||
      S > 1024 || R > 1024)
    return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const auto args = [&](auto launcher) {
    return launcher(static_cast<const int32_t*>(x), static_cast<const uint8_t*>(a1),
                    static_cast<const uint8_t*>(a2), static_cast<const uint32_t*>(tw),
                    static_cast<const uint32_t*>(kc), static_cast<int32_t*>(out), rows, L, S,
                    R, ph, static_cast<cudaStream_t>(stream), grid_only);
  };
  if constexpr (PHIM == kPhimNone) {
    if (allow_wgmma && pingpong_takes(S, R))
      return S * R <= 4096 ? args(launch_mma_tpw<DIGITS, 8, kPingpong, kPhimNone>)
                           : args(launch_mma_tpw<DIGITS, 16, kPingpong, kPhimNone>);
    if (allow_wgmma && rowsplit_takes(S, R))   // 128 x 128 (static_assert above)
      return args(launch_mma_tpw<DIGITS, 16, kRowsplit, kPhimNone>);
  }
  const int in_tiles = ((R + 7) / 8) * ((S + 15) / 16);
  const int tpw = (in_tiles + kWarps - 1) / kWarps;
  if (tpw <= 1) return args(launch_mma_tpw<DIGITS, 1, kSync, PHIM>);
  if (tpw <= 2) return args(launch_mma_tpw<DIGITS, 2, kSync, PHIM>);
  if (tpw <= 4) return args(launch_mma_tpw<DIGITS, 4, kSync, PHIM>);
  if (tpw <= 8) return args(launch_mma_tpw<DIGITS, 8, kSync, PHIM>);
  if (tpw <= 16) return args(launch_mma_tpw<DIGITS, 16, kSync, PHIM>);
  return cudaErrorInvalidValue;
}

// A transform of rows phim words wide on the N-point split S x R: the
// kernel without the phim <-> N steps where phim = N (m = 2^k), else with
// them (kFwd: pad and drop; otherwise insert and fold), for phim =
// N (q - 1)/q, q odd, N/q >= 2 and N < 2^16 (the quotients of divide);
// any other (phim, q) is refused.
template <bool DIGITS, int kFwd>
cudaError_t launch_phim(const void* x, const void* a1, const void* a2, const void* tw,
                        const void* kc, void* out, long long rows, int L, int S, int R,
                        int phim, int q, void* stream, MmaGrid* grid_only = nullptr) {
  const int N = S * R;
  if (phim == N)
    return launch_mma<DIGITS>(x, a1, a2, tw, kc, out, rows, L, S, R, stream, true, PhimMap{},
                              grid_only);
  if (q < 3 || q % 2 == 0 || N >= 65536 || N % q != 0 || N / q < 2 || phim != N - N / q)
    return cudaErrorInvalidValue;
  const int s = N / q;
  const PhimMap ph{phim, q, (q - 1) / 2, s, 0xffffffffu / q + 1, 0xffffffffu / s + 1};
  return launch_mma<DIGITS, kFwd ? kPhimFwd : kPhimInv>(x, a1, a2, tw, kc, out, rows, L, S, R,
                                                        stream, false, ph, grid_only);
}

// The grid of a launch of fsi_ct_fwd (kind 0), fsi_ct_fwd_digits (1) or
// fsi_ct_inv (2) with these arguments, launching nothing
cudaError_t launch_grid(int kind, long long rows, int L, int N1, int N2, int phim, int q_odd,
                        MmaGrid* g) {
  const void* none = nullptr;
  if (kind == 0)
    return launch_phim<false, 1>(none, none, none, none, none, nullptr, rows, L, N2, N1, phim,
                                 q_odd, nullptr, g);
  if (kind == 1)
    return launch_phim<true, 1>(none, none, none, none, none, nullptr, rows, L, N2, N1, phim,
                                q_odd, nullptr, g);
  if (kind == 2)
    return launch_phim<false, 0>(none, none, none, none, none, nullptr, rows, L, N1, N2, phim,
                                 q_odd, nullptr, g);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x [rows, L, phim] residues in [0, q); out [rows, L, phim] evaluations
// (phim = N on m = 2^k; q_odd, the odd prime of a mixed-radix m, read only
// where phim < N).  a1 / a2: the byte planes of t2 / t1, tw: the
// transposed twiddle with its reciprocals, kc: the per-prime constants
// (ops/ntt_ct_cuda.py kernel_tables).
int fsi_ct_fwd(const void* x, const void* a1, const void* a2, const void* tw,
               const void* kc, void* out, long long rows, int L, int N1, int N2, int phim,
               int q_odd, void* stream) {
  return launch_phim<false, 1>(x, a1, a2, tw, kc, out, rows, L, N2, N1, phim, q_odd, stream);
}

// x [rows, phim] digits below 2^24 shared by every prime; out
// [rows, L, phim].  The tables of fsi_ct_fwd.
int fsi_ct_fwd_digits(const void* x, const void* a1, const void* a2, const void* tw,
                      const void* kc, void* out, long long rows, int L, int N1,
                      int N2, int phim, int q_odd, void* stream) {
  return launch_phim<true, 1>(x, a1, a2, tw, kc, out, rows, L, N2, N1, phim, q_odd, stream);
}

// e [rows, L, phim] evaluations; out [rows, L, phim] coefficients in
// [0, q), reduced mod Phi_m.  a1 / a2: the byte planes of t1i / t2i (or
// t2i_crt), tw: twi with its reciprocals, kc: the per-prime constants.
int fsi_ct_inv(const void* e, const void* a1, const void* a2, const void* tw,
               const void* kc, void* out, long long rows, int L, int N1, int N2, int phim,
               int q_odd, void* stream) {
  return launch_phim<false, 0>(e, a1, a2, tw, kc, out, rows, L, N1, N2, phim, q_odd, stream);
}

// The schedule that launch_mma chooses for a row [S][R] (fsi_ct_fwd and
// fsi_ct_fwd_digits: S = N2, R = N1; fsi_ct_inv: S = N1, R = N2):
// 1 ping-pong, 2 rowsplit, 0 sync.  No mixed-radix split is one a wgmma
// schedule takes (sides that are multiples of 64 and N <= 8192 make N a
// power of two; the rowsplit rule asks for one).
int fsi_ct_schedule(int S, int R) {
  return pingpong_takes(S, R) ? kPingpong : rowsplit_takes(S, R) ? kRowsplit : kSync;
}

// Dynamic shared memory of the chosen schedule's layout, with the fold's
// tail of fold_words words (fsi_ct_inv on a mixed-radix ring: s = N/q;
// 0 otherwise), and the current device's per-block limit.
long long fsi_ct_mma_smem(int S, int R, int fold_words) {
  if (fold_words == 0 && pingpong_takes(S, R)) return PGeo(S, R).smem_bytes();
  if (fold_words == 0 && rowsplit_takes(S, R)) return rowsplit_bytes(S, R);
  return Geo(S, R, fold_words).smem_bytes();
}

// The sync schedule on any split it takes, for the tests that hold the
// wgmma schedules equal to it: the forward transforms' (digits 1: fsi_ct_fwd_digits)
// or the inverse's tables and row [S][R], N wide.
int fsi_ct_sync(int digits, const void* x, const void* a1, const void* a2, const void* tw,
                const void* kc, void* out, long long rows, int L, int S, int R, void* stream) {
  return digits ? launch_mma<true>(x, a1, a2, tw, kc, out, rows, L, S, R, stream, false)
                : launch_mma<false>(x, a1, a2, tw, kc, out, rows, L, S, R, stream, false);
}

// The grid that fsi_ct_fwd (kind 0), fsi_ct_fwd_digits (1) or fsi_ct_inv
// (2) launches with these arguments on the current device: fsi_ct_tiles
// the row tiles each prime gets (sync_tiles on the sync schedule),
// fsi_ct_slots the resident blocks of the card (SMs x blocks per SM) that
// the choice reads; a CUDA error as its negative.
long long fsi_ct_tiles(int kind, long long rows, int L, int N1, int N2, int phim, int q_odd) {
  MmaGrid g{0, 0, 0};
  const cudaError_t err = launch_grid(kind, rows, L, N1, N2, phim, q_odd, &g);
  return err == cudaSuccess ? g.ntiles : -static_cast<long long>(err);
}

long long fsi_ct_slots(int kind, int N1, int N2, int phim, int q_odd) {
  MmaGrid g{0, 0, 0};
  const cudaError_t err = launch_grid(kind, 1, 1, N1, N2, phim, q_odd, &g);
  return err == cudaSuccess ? g.slots : -static_cast<long long>(err);
}

int fsi_smem_optin() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess)
    return -1;
  return bytes;
}

}  // extern "C"
