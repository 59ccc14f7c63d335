// Batched Ring64 x Ring64 matmul, mod 2^64, on the 8-bit tensor cores of
// sm_90a: out[b] = x[b] @ y[b] for int64 x [B, M, K] and y [B, K, N].
//
// Replaces no Pallas kernel: the reference computes this product
// (ring_linalg.matmul_ring, src/repro/core/ring_linalg.py:72-124) as a jnp
// einsum of 8 x 8 balanced digit planes, which XLA maps onto the TPU's
// matrix unit.  PyTorch has no int64 matmul on CUDA, so the port needs its
// own kernel.  It computes the triple's C = A @ B and the Beaver combine
// E @ B_p + A_p @ F + [p = 0] E @ F, which core/gmw.py takes as one product
// with K doubled: two launches per secret x secret matmul and stream.
//
// Arithmetic.  Both operands are full 64-bit ring values, so both give
// their 8 raw bytes as unsigned digits: x = sum_i u_i 2^(8i), y = sum_j
// v_j 2^(8j) with u_i, v_j in [0, 255].  For each shift s = i + j < 8 the
// s + 1 plane products u_i @ v_j go through
// mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 into one int32
// accumulator per shift (36 plane products in all; 2^64 divides every
// term with i + j >= 8), and out = sum_s acc_s << 8s mod 2^64.
//
// Fold.  A shift's sum is non-negative and grows by at most
// (s + 1) * 255^2 <= 520200 per k, so 4096 of K (2 130 739 200) stay
// below 2^31 for every shift: each block contracts at most kFoldSteps K
// steps into its int32 accumulators, then adds sum_s acc_s << 8s into one
// 64-bit sum per output and starts them again.  No accumulator ever wraps,
// so the result does not rest on how the tensor cores treat an overflow.
// kernels/ref.py ring_matmul_ss_digits repeats this arithmetic in plain
// torch and raises where a shift's sum would leave int32.
//
// Bound on the card: max(bytes / 3.35 TB/s, 36 * 2 * B*M*K*N / 1979 TOP/s),
// bytes = 8 (BMK + BKN + BMN) (each input read once, the output written
// once).
//
// Design, kept simple (the main path's products are small: 16 heads x 2
// parties of 8 x 64 @ 64 x 8 and 8 x 8 @ 8 x 64 per stream):
// 1. Every batch cell in one launch: a 1-D grid over (cell, row tile,
//    column tile), so the many small matrices of one product fill the card
//    together.
// 2. A block of 4 warps owns a 32 x 32 output tile, each warp 16 x 16 (one
//    m16 tile, two n8 tiles: 8 shifts x 2 x 4 = 64 int32 accumulators a
//    thread).  Per K step of 32 the block reads its x and y tiles straight
//    from device memory (zero past the ragged edges), splits them into
//    byte planes with a 4 x 4 byte transpose (prmt) and stores the planes
//    fragment-ready in shared memory: x's rows and y's columns with 32
//    bytes of K each, at a row stride of 48 bytes so that a warp's
//    fragment loads hit 32 distinct banks.  Then each warp loads y's 8
//    B fragments once and x's A fragment plane by plane, and issues its
//    36 x 2 MMAs.  No copy runs ahead of the MMAs, and K is not split
//    over blocks: staging tiles with cp.async or TMA, and split-K for long
//    K, are left undone.
//
// Layouts: x (B, M, K), y (B, K, N), out (B, M, N), int64, row-major.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 32, BN = 32, BK = 32;   // block tile, K per step
constexpr int kThreads = 128;              // 4 warps: 2 (rows) x 2 (columns)
constexpr int kWarpM = 16, kWarpN = 16, kNT = kWarpN / 8;
constexpr int kRowWords = 12;              // 32 bytes of K + 16 of padding
constexpr int kPlaneWords = BM * kRowWords;  // BM == BN: one size for both
constexpr int kFoldSteps = 4096 / BK;      // most K steps between folds

// out[j] = byte j of in[0], in[1], in[2], in[3] (a 4 x 4 byte transpose)
__device__ __forceinline__ void transpose4(const uint32_t in[4], uint32_t out[4]) {
  const uint32_t t01 = __byte_perm(in[0], in[1], 0x5140);
  const uint32_t t23 = __byte_perm(in[2], in[3], 0x5140);
  const uint32_t u01 = __byte_perm(in[0], in[1], 0x7362);
  const uint32_t u23 = __byte_perm(in[2], in[3], 0x7362);
  out[0] = __byte_perm(t01, t23, 0x5410);
  out[1] = __byte_perm(t01, t23, 0x7632);
  out[2] = __byte_perm(u01, u23, 0x5410);
  out[3] = __byte_perm(u01, u23, 0x7632);
}

// Split 4 consecutive-k values into their 8 byte planes and store word
// `kq` (k 4kq..4kq+3) of row `r` of each plane.
__device__ __forceinline__ void store_planes(const uint64_t v[4], uint32_t* planes,
                                             int r, int kq) {
  const uint32_t lo[4] = {static_cast<uint32_t>(v[0]), static_cast<uint32_t>(v[1]),
                          static_cast<uint32_t>(v[2]), static_cast<uint32_t>(v[3])};
  const uint32_t hi[4] = {static_cast<uint32_t>(v[0] >> 32), static_cast<uint32_t>(v[1] >> 32),
                          static_cast<uint32_t>(v[2] >> 32), static_cast<uint32_t>(v[3] >> 32)};
  uint32_t p[8];
  transpose4(lo, p);
  transpose4(hi, p + 4);
#pragma unroll
  for (int i = 0; i < 8; ++i) planes[i * kPlaneWords + r * kRowWords + kq] = p[i];
}

__device__ __forceinline__ void mma_u8u8(int32_t c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(kThreads)
ring_matmul_ss_kernel(const uint64_t* __restrict__ x, const uint64_t* __restrict__ y,
                      uint64_t* __restrict__ out, int64_t M, int64_t K, int64_t N,
                      int64_t m_tiles, int64_t n_tiles) {
  __shared__ __align__(16) uint32_t xp[8 * kPlaneWords];   // [plane][row][word]
  __shared__ __align__(16) uint32_t yp[8 * kPlaneWords];   // [plane][column][word]

  const int64_t tile = blockIdx.x;
  const int64_t cell = tile / (m_tiles * n_tiles);
  const int64_t row0 = (tile / n_tiles) % m_tiles * BM;
  const int64_t col0 = tile % n_tiles * BN;
  const uint64_t* xb = x + cell * M * K;
  const uint64_t* yb = y + cell * K * N;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 2, wn = warp % 2;
  const int g = lane / 4, t = lane % 4;

  int32_t acc[8][kNT][4];
  uint64_t sum[kNT][4];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      sum[nt][r] = 0;
#pragma unroll
      for (int s = 0; s < 8; ++s) acc[s][nt][r] = 0;
    }

  const int64_t steps = (K + BK - 1) / BK;
  for (int64_t kt = 0; kt < steps; ++kt) {
    const int64_t k0 = kt * BK;
    __syncthreads();                       // the last step's planes are read
    // x: thread (row, word of 4 k's); y: thread (column, word of 4 k's)
    for (int idx = threadIdx.x; idx < BM * (BK / 4); idx += kThreads) {
      const int r = idx / (BK / 4), kq = idx % (BK / 4);
      const int64_t gr = row0 + r;
      uint64_t v[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int64_t gk = k0 + 4 * kq + c;
        v[c] = gr < M && gk < K ? xb[gr * K + gk] : 0;
      }
      store_planes(v, xp, r, kq);
    }
    for (int idx = threadIdx.x; idx < BN * (BK / 4); idx += kThreads) {
      const int n = idx % BN, kq = idx / BN;
      const int64_t gc = col0 + n;
      uint64_t v[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int64_t gk = k0 + 4 * kq + c;
        v[c] = gc < N && gk < K ? yb[gk * N + gc] : 0;
      }
      store_planes(v, yp, n, kq);
    }
    __syncthreads();

    uint32_t b[8][kNT][2];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const uint32_t* col = yp + j * kPlaneWords + (wn * kWarpN + nt * 8 + g) * kRowWords;
        b[j][nt][0] = col[t];
        b[j][nt][1] = col[t + 4];
      }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint32_t* rows = xp + i * kPlaneWords + (wm * kWarpM + g) * kRowWords;
      const uint32_t a[4] = {rows[t], rows[8 * kRowWords + t], rows[t + 4],
                             rows[8 * kRowWords + t + 4]};
#pragma unroll
      for (int j = 0; j + i < 8; ++j)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) mma_u8u8(acc[i + j][nt], a, b[j][nt]);
    }

    if ((kt + 1) % kFoldSteps == 0 || kt + 1 == steps) {
      // fold the shift sums into 64 bits: sum += sum_s acc_s << 8s
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          uint64_t v = 0;
#pragma unroll
          for (int s = 0; s < 8; ++s) {
            v += static_cast<uint64_t>(static_cast<uint32_t>(acc[s][nt][r])) << (8 * s);
            acc[s][nt][r] = 0;
          }
          sum[nt][r] += v;
        }
    }
  }

  uint64_t* ob = out + cell * M * N;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int64_t gr = row0 + wm * kWarpM + g + 8 * (r / 2);
      const int64_t gc = col0 + wn * kWarpN + nt * 8 + 2 * t + r % 2;
      if (gr < M && gc < N) ob[gr * N + gc] = sum[nt][r];
    }
}

}  // namespace

// b, m, n, k >= 1; b * ceil(m / 32) * ceil(n / 32) < 2^31 (the wrapper checks).
extern "C" int hb_ring_matmul_ss(const void* x, const void* y, void* out, int64_t b,
                                 int64_t m, int64_t k, int64_t n, void* stream) {
  const int64_t m_tiles = (m + BM - 1) / BM, n_tiles = (n + BN - 1) / BN;
  ring_matmul_ss_kernel<<<static_cast<unsigned int>(b * m_tiles * n_tiles), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(x), static_cast<const uint64_t*>(y),
      static_cast<uint64_t*>(out), m, k, n, m_tiles, n_tiles);
  return static_cast<int>(cudaGetLastError());
}
