// Two-level Cooley-Tukey NTT kernels for both residue lanes (primes
// q < 2^20 narrow, q < 2^23 wide; power-of-two m), written for Hopper
// (sm_90a).
//
// Replaces the three Pallas TPU kernels of fhe_si_tpu/ops/ntt_ct_pallas.py:
//   fsi_ct_fwd        <- _fwd_res_kernel     (forward NTT of residues)
//   fsi_ct_fwd_digits <- _fwd_digits_kernel  (forward NTT of keyswitch digits)
//   fsi_ct_inv        <- _inv_kernel         (inverse NTT)
//
// What they compute (the index maps of fhe_si_tpu_torch/ops/ntt_ct.py):
//   forward:  y[c1,j2] = (sum_c2 T2[j2,c2] x[c1 + N1*c2]) mod q
//             y[c1,j2] = y[c1,j2] * tw[c1,j2] mod q
//             X[j1,j2] = (sum_c1 T1[j1,c1] y[c1,j2]) mod q,  out[j2 + N2*j1]
//   inverse:  z[c1,j2] = (sum_j1 T1i[c1,j1] X[j1,j2]) mod q * twi[c1,j2] mod q
//             x[c1,c2] = (sum_j2 T2i[c2,j2] z[c1,j2]) mod q,  out[c1 + N1*c2]
// Every stage output is the canonical residue, so the kernels are
// bit-identical to the TPU kernels' int8-plane Karatsuba + Barrett-Horner.
//
// Exactness: each stage accumulates in unsigned 64-bit and reduces once,
// so it is exact while K products of a table entry (below q) and an
// operand stay below 2^64.  The wrappers in ops/ntt_ct_cuda.py hold
// q < 2^23 and digits below 2^24 (digit_bits <= 24); under those:
//   residue stages: K * 2^23 * 2^23 = K * 2^46 < 2^64 for K < 2^18
//     (narrow lane: K * 2^40, below 2^53 at K <= 2^13);
//   digit stage:    K * 2^24 * 2^23 = K * 2^47 < 2^64 for K < 2^17
//     (2^60 at K = N2 = 2^13; m = 8192 has K = 64);
//   twiddle:        one product below 2^46.
// A digit below 2^31 (any nonnegative int32) is exact only while
// K * 2^31 * q < 2^64, so the wrapper's 24-bit cap is what keeps the
// digit stage exact on the wide lane.
//
// What bounds it on this card, and the design: one block per (row, prime);
// the row (N int32) and the stage-1 intermediate (N int32) live in shared
// memory, 32 KiB at N = 64 x 64, so several blocks fit on each SM.  Each
// thread owns output elements; the table entry of its inner loop is the
// same address across a warp (a broadcast from L1) and the activation
// reads are consecutive in shared memory.  The stages do N*(N1+N2) 64-bit
// multiply-adds per (row, prime) plus 3N 64-bit remainders: the kernels are
// bound by integer instruction issue on the CUDA cores, not by memory.
// Int8 tensor-core stages (mma/wgmma), TMA and a persistent grid are the
// way past that bound.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// Forward transform of one (row, prime).  DIGITS: the input row is shared
// by every prime (x [rows, N]); otherwise x is [rows, L, N].
template <bool DIGITS>
__global__ void __launch_bounds__(kThreads)
ct_fwd_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ t2,
              const int32_t* __restrict__ t1, const int32_t* __restrict__ tw,
              const int32_t* __restrict__ q, int32_t* __restrict__ out,
              int L, int N1, int N2) {
  extern __shared__ uint32_t smem[];
  const int N = N1 * N2;
  uint32_t* xs = smem;        // [c2][c1]
  uint32_t* ys = smem + N;    // [c1][j2]
  const int l = blockIdx.y;
  const size_t row = blockIdx.x;
  const uint64_t ql = static_cast<uint32_t>(q[l]);
  const int32_t* xrow = DIGITS ? x + row * N : x + (row * L + l) * N;
  for (int i = threadIdx.x; i < N; i += blockDim.x)
    xs[i] = static_cast<uint32_t>(xrow[i]);
  __syncthreads();

  const int32_t* T2 = t2 + static_cast<size_t>(l) * N2 * N2;
  const int32_t* T1 = t1 + static_cast<size_t>(l) * N1 * N1;
  const int32_t* TW = tw + static_cast<size_t>(l) * N;
  // stage 1 over c2, then the twiddle; neighbouring threads take
  // neighbouring c1 (consecutive shared-memory reads)
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const int c1 = i % N1, j2 = i / N1;
    const int32_t* trow = T2 + j2 * N2;
    // each term < 2^46 for residues, < 2^47 for 24-bit digits (q < 2^23);
    // N2 <= 2^13 terms stay below 2^60
    uint64_t acc = 0;
    for (int c2 = 0; c2 < N2; ++c2)
      acc += static_cast<uint64_t>(static_cast<uint32_t>(trow[c2])) * xs[c2 * N1 + c1];
    const uint64_t y = acc % ql;   // y * tw < 2^46
    ys[c1 * N2 + j2] = static_cast<uint32_t>(
        y * static_cast<uint32_t>(TW[c1 * N2 + j2]) % ql);
  }
  __syncthreads();

  // stage 2 over c1; output index i = j2 + N2*j1 (coalesced store)
  int32_t* orow = out + (row * L + l) * N;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const int j2 = i % N2, j1 = i / N2;
    const int32_t* trow = T1 + j1 * N1;
    uint64_t acc = 0;                // < 2^46 * N1 <= 2^59
    for (int c1 = 0; c1 < N1; ++c1)
      acc += static_cast<uint64_t>(static_cast<uint32_t>(trow[c1])) * ys[c1 * N2 + j2];
    orow[i] = static_cast<int32_t>(acc % ql);
  }
}

// Inverse transform of one (row, prime): e [rows, L, N] -> out [rows, L, N].
__global__ void __launch_bounds__(kThreads)
ct_inv_kernel(const int32_t* __restrict__ e, const int32_t* __restrict__ t1i,
              const int32_t* __restrict__ t2i, const int32_t* __restrict__ twi,
              const int32_t* __restrict__ q, int32_t* __restrict__ out,
              int L, int N1, int N2) {
  extern __shared__ uint32_t smem[];
  const int N = N1 * N2;
  uint32_t* es = smem;        // [j1][j2]
  uint32_t* zs = smem + N;    // [j2][c1]
  const int l = blockIdx.y;
  const size_t row = blockIdx.x;
  const uint64_t ql = static_cast<uint32_t>(q[l]);
  const int32_t* erow = e + (row * L + l) * N;
  for (int i = threadIdx.x; i < N; i += blockDim.x)
    es[i] = static_cast<uint32_t>(erow[i]);
  __syncthreads();

  const int32_t* T1 = t1i + static_cast<size_t>(l) * N1 * N1;
  const int32_t* T2 = t2i + static_cast<size_t>(l) * N2 * N2;
  const int32_t* TW = twi + static_cast<size_t>(l) * N;
  // stage over j1, then the twiddle; neighbouring threads take neighbouring j2
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const int j2 = i % N2, c1 = i / N2;
    const int32_t* trow = T1 + c1 * N1;
    uint64_t acc = 0;                // < 2^46 * N1 <= 2^59
    for (int j1 = 0; j1 < N1; ++j1)
      acc += static_cast<uint64_t>(static_cast<uint32_t>(trow[j1])) * es[j1 * N2 + j2];
    const uint64_t z = acc % ql;   // z * twi < 2^46
    zs[j2 * N1 + c1] = static_cast<uint32_t>(
        z * static_cast<uint32_t>(TW[c1 * N2 + j2]) % ql);
  }
  __syncthreads();

  // stage over j2; output index i = c1 + N1*c2 (coalesced store)
  int32_t* orow = out + (row * L + l) * N;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const int c1 = i % N1, c2 = i / N1;
    const int32_t* trow = T2 + c2 * N2;
    uint64_t acc = 0;                // < 2^46 * N2 <= 2^59
    for (int j2 = 0; j2 < N2; ++j2)
      acc += static_cast<uint64_t>(static_cast<uint32_t>(trow[j2])) * zs[j2 * N1 + c1];
    orow[i] = static_cast<int32_t>(acc % ql);
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, long long rows, int L, int N1, int N2,
                   cudaStream_t stream, const int32_t* a, const int32_t* b,
                   const int32_t* c, const int32_t* d, const int32_t* q,
                   int32_t* out) {
  if (rows < 0 || rows > 0x7fffffffLL || L < 1 || L > 65535 || N1 < 1 || N2 < 1)
    return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const size_t smem = 2 * static_cast<size_t>(N1) * N2 * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  dim3 grid(static_cast<unsigned>(rows), static_cast<unsigned>(L));
  kernel<<<grid, kThreads, smem, stream>>>(a, b, c, d, q, out, L, N1, N2);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [rows, L, N] residues in [0, q); out [rows, L, N] evaluations.
int fsi_ct_fwd(const void* x, const void* t2, const void* t1, const void* tw,
               const void* q, void* out, long long rows, int L, int N1, int N2,
               void* stream) {
  return launch(ct_fwd_kernel<false>, rows, L, N1, N2,
                static_cast<cudaStream_t>(stream),
                static_cast<const int32_t*>(x), static_cast<const int32_t*>(t2),
                static_cast<const int32_t*>(t1), static_cast<const int32_t*>(tw),
                static_cast<const int32_t*>(q), static_cast<int32_t*>(out));
}

// x [rows, N] nonnegative digits shared by every prime; out [rows, L, N].
int fsi_ct_fwd_digits(const void* x, const void* t2, const void* t1, const void* tw,
                      const void* q, void* out, long long rows, int L, int N1,
                      int N2, void* stream) {
  return launch(ct_fwd_kernel<true>, rows, L, N1, N2,
                static_cast<cudaStream_t>(stream),
                static_cast<const int32_t*>(x), static_cast<const int32_t*>(t2),
                static_cast<const int32_t*>(t1), static_cast<const int32_t*>(tw),
                static_cast<const int32_t*>(q), static_cast<int32_t*>(out));
}

// e [rows, L, N] evaluations; out [rows, L, N] coefficients in [0, q).
int fsi_ct_inv(const void* e, const void* t1i, const void* t2i, const void* twi,
               const void* q, void* out, long long rows, int L, int N1, int N2,
               void* stream) {
  return launch(ct_inv_kernel, rows, L, N1, N2, static_cast<cudaStream_t>(stream),
                static_cast<const int32_t*>(e), static_cast<const int32_t*>(t1i),
                static_cast<const int32_t*>(t2i), static_cast<const int32_t*>(twi),
                static_cast<const int32_t*>(q), static_cast<int32_t*>(out));
}

}  // extern "C"
