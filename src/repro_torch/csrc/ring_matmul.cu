// Ring64 matmul by public int32 weights, mod 2^64, for sm_90a.
//
// Replaces the Pallas TPU kernel ring_matmul_pallas
// (src/repro/kernels/ring_matmul.py:88).  The TPU kernel splits the
// shares into 8 balanced int8 digit planes and the weights into 5 and
// runs the 8x5 plane products on the MXU, because a TPU has no 64-bit
// integer path; its int32 plane accumulators bound K per call.  Here each
// thread multiplies the 64-bit shares by the sign-extended weights in
// uint64_t arithmetic, so wrapping mod 2^64 is native, the result is
// bit-equal to the digit-plane contraction, and K needs no chunking.
//
// Bound: the card has no 64-bit integer multiplier.  One 64x32-bit
// multiply-add compiles to a few 32-bit IMADs, so the int32 IMAD rate
// bounds the kernel (operations, not bytes, at the main path's shapes;
// see chip_smoke.py for the count used).  The int8 digit-plane design
// on tensor cores (wgmma s8) is later work.
//
// Design: 64x64 output tiles per 256-thread block, each thread holding a
// 4x4 register tile of uint64 accumulators; K advances in slices of 16
// staged through shared memory (x as uint64, w as int32).  Ragged M, K, N
// edges are masked with zeros.
//
// Layouts: x (M, K) int64, w (K, N) int32, out (M, N) int64, row-major.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 16;
constexpr int TM = 4, TN = 4;                 // per-thread register tile
constexpr int kThreads = (BM / TM) * (BN / TN);

__global__ void __launch_bounds__(kThreads)
ring_matmul_kernel(const uint64_t* __restrict__ x,
                   const int32_t* __restrict__ w,
                   uint64_t* __restrict__ out,
                   int64_t M, int64_t K, int64_t N) {
  __shared__ uint64_t xs[BK][BM + 1];
  __shared__ int32_t ws[BK][BN];
  const int tx = threadIdx.x % (BN / TN);     // column group
  const int ty = threadIdx.x / (BN / TN);     // row group
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * BM;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * BN;

  uint64_t acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  for (int64_t k0 = 0; k0 < K; k0 += BK) {
    for (int t = threadIdx.x; t < BM * BK; t += kThreads) {
      const int r = t / BK, kk = t % BK;
      const int64_t gr = row0 + r, gk = k0 + kk;
      xs[kk][r] = (gr < M && gk < K) ? x[gr * K + gk] : 0ull;
    }
    for (int t = threadIdx.x; t < BK * BN; t += kThreads) {
      const int kk = t / BN, cc = t % BN;
      const int64_t gk = k0 + kk, gc = col0 + cc;
      ws[kk][cc] = (gk < K && gc < N) ? w[gk * N + gc] : 0;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      uint64_t xv[TM], wv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) xv[i] = xs[kk][ty + i * (BM / TM)];
#pragma unroll
      for (int j = 0; j < TN; ++j)
        wv[j] = static_cast<uint64_t>(static_cast<int64_t>(ws[kk][tx + j * (BN / TN)]));
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += xv[i] * wv[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t gr = row0 + ty + i * (BM / TM);
    if (gr >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int64_t gc = col0 + tx + j * (BN / TN);
      if (gc < N) out[gr * N + gc] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" int hb_ring_matmul(const void* x, const void* w, void* out,
                              int64_t m, int64_t k, int64_t n, void* stream) {
  const dim3 grid(static_cast<unsigned int>((n + BN - 1) / BN),
                  static_cast<unsigned int>((m + BM - 1) / BM));
  ring_matmul_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(x), static_cast<const int32_t*>(w),
      static_cast<uint64_t*>(out), m, k, n);
  return static_cast<int>(cudaGetLastError());
}
