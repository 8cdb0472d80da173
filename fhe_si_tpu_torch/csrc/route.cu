// The matmul route's boundary kernels on a split N x 1, written for Hopper
// (sm_90a): everything of a route transform but its one FP64 GEMM, in one
// pass on each side of it.  Wrapper: ops/route_cuda.py; the transforms that
// run them: ops/ntt_ct_matmul.py.
//
// Not Pallas kernels in the JAX package: there the Cooley-Tukey splits that
// its Pallas kernels do not take run as XLA stage products
// (fhe_si_tpu/ops/ntt_ct.py:327-380 ct_fwd, ct_fwd_digits, ct_inv: pad, the
// stage-1 product, the twiddle, the stage-2 product, drop; insert, two
// products around the inverse twiddle, fold), each a modmatmul that XLA
// fuses with its conversions.  Run eagerly in the port, the same steps were
// 3-6 int32 <-> int64 <-> float64 passes a step and a GEMV for the 1 x 1
// stage, 13.1 ms of a 39.7 ms mul+relin at p = 8147 (batch 64, logQ 188) on
// one H100.
//
//   route_enter_kernel<kFwd>     <- _pad_to_N, the stage-1 product, the twiddle
//                                   and modmatmul's float64 operand, ntt_ct.py:
//                                   332-333, 320-322
//   route_enter_kernel<kDigits>  <- the same for prime-independent digits
//                                   (digit_cross_groups), :350-355, 320-322
//   route_enter_kernel<kInv>     <- _insert_excluded and the operand, :370-375
//   route_leave_kernel<kFwd>     <- the reduction mod q after stage 2 and
//                                   _drop_excluded, :322-324
//   route_leave_kernel<kInv>     <- the reduction after the inverse DFT, the
//                                   inverse twiddle, the stage-2 product (t2i or
//                                   t2i_crt) and _fold_mod_phim, :375-380
//
// ---- The split N x 1 ----
// N = m / 2 is an odd prime, the ring's odd part q_odd = N, phim = N - 1 and
// the excluded evaluation is u0 = (N - 1) / 2.  Stage 1 is a 1 x 1 table per
// prime, one residue t2_l, so it folds into the twiddle on the host
// (ops/route_cuda.py folded_table): tw'[l, c] = tw[l, c] t2_l mod q_l, and
// twi'[l, c] = twi[l, c] t2i_l (or t2i_crt_l) mod q_l.  A transform is then
// enter, the N x N GEMM of the t1 (forward) or t1i (inverse) operand over
// the [L, N, R] view of enter's output, and leave:
//   enter kFwd:     x [R, L, phim] residues      -> y [R, L, N] float64,
//                   y[r, l, c] = x[r, l, c] tw'[l, c] mod q_l, 0 at c = phim
//   enter kDigits:  x [R, phim] digits < 2^24    -> y [R, L, N] float64,
//                   y[r, l, c] = x[r, c] tw'[l, c] mod q_l, 0 at c = phim
//   enter kInv:     x [R, L, phim] evaluations   -> y [R, L, N] float64,
//                   y[r, l, u] = x[r, l, u - (u > u0)], 0 at u = u0
//   leave kFwd:     z [L, N, R] (the GEMM's)     -> out [R, L, phim] int32,
//                   out[r, l, j] = z[l, j + (j >= u0), r] mod q_l
//   leave kInv:     z [L, N, R]                  -> out [R, L, phim] int32,
//                   w_c = (z[l, c, r] mod q_l) twi'[l, c] mod q_l, and
//                   out[r, l, c] = w_c - w_{N-1} (c even), w_c + w_{N-1}
//                   (c odd), mod q_l: X^phim = -sum_i (-X)^i mod Phi_m
// The [L, N, R] view of y is the float64 operand modmatmul's permute made
// (ops/ntt.py), so the GEMM is the same cuBLAS call as on the plain route.
//
// ---- Exactness ----
// * Tables: tw'[l, c] and its Shoup quotient floor(tw' 2^32 / q_l), [2, L, N]
//   int32 (the quotient as the bits of a uint32).  x tw' mod q for x < 2^32
//   and tw' < q < 2^31: qhat = umulhi(x, quotient) is floor(x tw' / q) or one
//   less, so x tw' - qhat q, computed mod 2^32, lies in [0, 2q) and one
//   conditional subtraction makes it canonical.  Residues and digits below
//   2^24 both qualify.
// * The GEMM's outputs are exact integers below 2^53 (ntt.needs_split holds
//   the route to N (q_max - 1)^2 < 2^53; p = 8147: 4073 (2^20 - 1)^2 < 2^52).
//   v mod q in float64: t = floor(v fl(1/q)) is within one of floor(v / q)
//   (the product's relative error is at most 2^-52, so its absolute error is
//   below 2^53 / q 2^-52 <= 1), r = fma(-t, q, v) is the exact integer v - t q
//   in [-q, 2q) (one rounding of an exact small integer), and one correction
//   each way makes it canonical.
//
// ---- What bounds it on the H100, and the design ----
// Bytes.  The route cell (m = 8146, batch 64, L = 23, Lk = 13, 8 digits)
// moves, per transform, 4 B in and 8 B out per (row, prime, coefficient)
// through enter and 8 B in and 4 B out through leave (the digits' input once
// for all primes): 2.8 GB a mul+relin, 0.84 ms at 3.35 TB/s, against some
// ten integer or FP64 operations an element.
// * enter: a block per row of y, R L of them.  The input and output rows
//   are both contiguous: a warp reads 128 bytes and writes 256 bytes in
//   order; no shared memory.  The digits' L blocks of one row r are
//   neighbours in the grid, so the digit row comes from device memory once
//   and from L2 for the other primes.  (A block per digit row that looped
//   over the primes ran at about half the bytes bound on the route cell:
//   its stores waited on the loop's table loads, one prime at a time.)
// * leave: the GEMM's [L, N, R] is R-major and the output phim-major, so a
//   block transposes a tile of kTileC coefficients by kTileR rows of one prime
//   through shared memory: a warp reads 32 consecutive rows of one
//   coefficient (256 bytes), reduces, twiddles and folds them, and a warp
//   writes 32 consecutive coefficients of one row (128 bytes).  The tile's
//   row stride is kTileR + 1 words, so neither side conflicts on banks.  The
//   inverse's fold reads its rows' coefficient N - 1 once a block, into
//   tail[].
// On one H100 (700 W) at the route cell's shapes: enter at 51-64% and leave
// at 51-76% of the bytes bound, the eight launches 1.24-1.29 ms a mul+relin
// against the GEMMs' 26 ms.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTileC = 64;             // leave: coefficients of a tile
constexpr int kTileR = 32;             // leave: rows of a tile (a warp)
constexpr int kMaxPrimes = 64;         // as crt.cu kMaxRows
enum { kFwd = 0, kDigits = 1, kInv = 2 };

// x w mod q for x < 2^32, w < q < 2^31, ws = floor(w 2^32 / q) (Shoup)
__device__ __forceinline__ uint32_t mul_shoup(uint32_t x, uint32_t w, uint32_t ws,
                                              uint32_t q) {
  const uint32_t r = x * w - __umulhi(x, ws) * q;
  return r >= q ? r - q : r;
}

// v mod q for an integer v in [0, 2^53) held exactly in a double
__device__ __forceinline__ uint32_t reduce_f64(double v, double qd, double qinv) {
  const double t = floor(v * qinv);
  double r = fma(-t, qd, v);
  r = r < 0.0 ? r + qd : r;
  r = r >= qd ? r - qd : r;
  return static_cast<uint32_t>(r);
}

// x [R, L, N - 1] (kFwd, kInv) or [R, N - 1] (kDigits) -> y [R, L, N]
// (header).  tw: [2, L, N] (kFwd, kDigits; unread by kInv).  Grid: one block
// per row r L + l of y.
template <int kMode>
__global__ void __launch_bounds__(kThreads)
    route_enter_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ tw,
                       const int32_t* __restrict__ q, double* __restrict__ y, int L, int N) {
  const int phim = N - 1;
  const long long b = blockIdx.x;
  const int l = static_cast<int>(b % L);
  // the digits' row r serves its L blocks, which run together: one read
  // from device memory, the others from L2
  const int32_t* xr = x + (kMode == kDigits ? b / L : b) * phim;
  double* yr = y + b * N;
  if (kMode == kInv) {
    const int u0 = phim / 2;
    for (int u = threadIdx.x; u < N; u += kThreads)
      yr[u] = u == u0 ? 0.0 : static_cast<double>(__ldg(xr + u - (u > u0)));
    return;
  }
  const uint32_t ql = static_cast<uint32_t>(q[l]);
  const int32_t* w = tw + static_cast<long long>(l) * N;
  const long long plane = static_cast<long long>(L) * N;   // tw's quotient plane
  for (int c = threadIdx.x; c < N; c += kThreads) {
    const uint32_t v = c < phim ? static_cast<uint32_t>(__ldg(xr + c)) : 0u;
    yr[c] = static_cast<double>(mul_shoup(v, static_cast<uint32_t>(__ldg(w + c)),
                                          static_cast<uint32_t>(__ldg(w + plane + c)), ql));
  }
}

// z [L, N, R] float64 -> out [R, L, N - 1] int32 (header).  tw: [2, L, N]
// (kInv; unread by kFwd).  Grid: (coefficient tiles, row tiles, L).
template <int kMode>
__global__ void __launch_bounds__(kThreads)
    route_leave_kernel(const double* __restrict__ z, const int32_t* __restrict__ tw,
                       const int32_t* __restrict__ q, int32_t* __restrict__ out, int R, int L,
                       int N) {
  __shared__ uint32_t tile[kTileC][kTileR + 1];
  __shared__ uint32_t tail[kTileR];
  const int phim = N - 1, u0 = phim / 2;
  const int l = blockIdx.z;
  const int c0 = blockIdx.x * kTileC, r0 = blockIdx.y * kTileR;
  const uint32_t ql = static_cast<uint32_t>(q[l]);
  const double qd = static_cast<double>(ql), qinv = 1.0 / qd;
  const double* zl = z + static_cast<long long>(l) * N * R;
  const long long plane = static_cast<long long>(L) * N;
  const int32_t* w = kMode == kInv ? tw + static_cast<long long>(l) * N : nullptr;
  // loads: lane = row, warp = coefficient
  const int lr = threadIdx.x % kTileR, lc = threadIdx.x / kTileR;
  const int r = r0 + lr;
  if (kMode == kInv) {
    if (lc == 0 && r < R)
      tail[lr] = mul_shoup(reduce_f64(zl[static_cast<long long>(phim) * R + r], qd, qinv),
                           static_cast<uint32_t>(__ldg(w + phim)),
                           static_cast<uint32_t>(__ldg(w + plane + phim)), ql);
    __syncthreads();
  }
  if (r < R) {
    for (int cc = lc; cc < kTileC; cc += kThreads / kTileR) {
      const int c = c0 + cc;
      if (c >= phim) break;
      const int u = kMode == kFwd ? c + (c >= u0) : c;
      uint32_t v = reduce_f64(zl[static_cast<long long>(u) * R + r], qd, qinv);
      if (kMode == kInv) {
        v = mul_shoup(v, static_cast<uint32_t>(__ldg(w + c)),
                      static_cast<uint32_t>(__ldg(w + plane + c)), ql);
        const uint32_t t = tail[lr];
        v = (c & 1) ? (v + t >= ql ? v + t - ql : v + t) : (v >= t ? v - t : v + ql - t);
      }
      tile[cc][lr] = v;
    }
  }
  __syncthreads();
  // stores: lane = coefficient, warp = row
  const int sc = threadIdx.x % kTileC, sr = threadIdx.x / kTileC;
  const int c = c0 + sc;
  if (c >= phim) return;
  for (int rr = sr; rr < kTileR && r0 + rr < R; rr += kThreads / kTileC)
    out[(static_cast<long long>(r0 + rr) * L + l) * phim + c] = static_cast<int32_t>(tile[sc][rr]);
}

bool bad_shape(int R, int L, int N) {
  return R < 0 || L < 1 || L > kMaxPrimes || N < 3 || N % 2 == 0 ||
         static_cast<long long>(R) * L >= (1ll << 31);
}

}  // namespace

extern "C" {

// x [R, L, N - 1] int32 (mode 0: residues, 2: evaluations) or [R, N - 1]
// (mode 1: digits below 2^24), tw [2, L, N] int32 (modes 0, 1; may be null
// for 2), q [L] int32 primes in [2, 2^23), all contiguous -> y [R, L, N]
// float64 (header).  N odd, at least 3; L <= 64; R L < 2^31.
int fsi_route_enter(const void* x, const void* tw, const void* q, void* y, int R, int L, int N,
                    int mode, void* stream) {
  if (bad_shape(R, L, N) || mode < kFwd || mode > kInv || (mode != kInv && tw == nullptr))
    return cudaErrorInvalidValue;
  if (R == 0) return cudaSuccess;
  const auto* xs = static_cast<const int32_t*>(x);
  const auto* ts = static_cast<const int32_t*>(tw);
  const auto* qs = static_cast<const int32_t*>(q);
  auto* ys = static_cast<double*>(y);
  const auto s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>(R * L);
  if (mode == kFwd)
    route_enter_kernel<kFwd><<<blocks, kThreads, 0, s>>>(xs, ts, qs, ys, L, N);
  else if (mode == kDigits)
    route_enter_kernel<kDigits><<<blocks, kThreads, 0, s>>>(xs, ts, qs, ys, L, N);
  else
    route_enter_kernel<kInv><<<blocks, kThreads, 0, s>>>(xs, ts, qs, ys, L, N);
  return cudaGetLastError();
}

// z [L, N, R] float64 of exact integers below 2^53, tw [2, L, N] int32
// (mode 1 = kInv's folded inverse twiddle; may be null for mode 0), q [L]
// int32 primes in [2, 2^23), all contiguous -> out [R, L, N - 1] int32
// (header: mode 0 the forward's drop, 1 the inverse's twiddle and fold).
int fsi_route_leave(const void* z, const void* tw, const void* q, void* out, int R, int L, int N,
                    int mode, void* stream) {
  if (bad_shape(R, L, N) || (mode != 0 && mode != 1) || (mode == 1 && tw == nullptr) ||
      (R + kTileR - 1) / kTileR > 65535)
    return cudaErrorInvalidValue;
  if (R == 0) return cudaSuccess;
  const dim3 grid((N - 1 + kTileC - 1) / kTileC, (R + kTileR - 1) / kTileR, L);
  const auto* zs = static_cast<const double*>(z);
  const auto* ts = static_cast<const int32_t*>(tw);
  const auto* qs = static_cast<const int32_t*>(q);
  auto* os = static_cast<int32_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (mode == 0)
    route_leave_kernel<kFwd><<<grid, kThreads, 0, s>>>(zs, ts, qs, os, R, L, N);
  else
    route_leave_kernel<kInv><<<grid, kThreads, 0, s>>>(zs, ts, qs, os, R, L, N);
  return cudaGetLastError();
}

}  // extern "C"
