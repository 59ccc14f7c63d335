// Ring64 matmul by public int32 weights, mod 2^64, on the int8 tensor
// cores of sm_90a.
//
// Replaces the Pallas TPU kernel ring_matmul_pallas
// (src/repro/kernels/ring_matmul.py:88) and computes what it computes: a
// digit-plane contraction whose plane products run on the matrix unit.
//
// Arithmetic.  x's digits are its 8 raw bytes u_i in [0, 255] (byte i of
// the int64 is digit i, so x needs no transform); w's are the reference's
// 5 balanced digits e_j (core/ring.py balanced_digits_i32): e_0..e_3 in
// [-128, 127] are the bytes of (w + 0x80808080) mod 2^32, each minus 128,
// and e_4 = [w >= 0x7F7F7F80] in {0, 1}.  For each shift s = i + j < 8 the
// 30 plane products u_i @ e_j go through
// mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 into one int32
// accumulator per shift, and out = sum_s (int64) acc_s << 8s, which wraps
// mod 2^64 by itself.  Accumulator bound: one k adds at most
// 4 * 255 * 128 + 255 = 130815 in magnitude to a shift's sum, so an int32
// accumulator holds K <= 16416; no block contracts more than 16384 of K
// (kFoldSteps), and the launch splits larger K over blocks whose 64-bit
// partials add in the ring.  kernels/ref.py ring_matmul_digits repeats
// this arithmetic in plain torch and raises where a partial leaves int32.
//
// Bound on the card: max(bytes / 3.35 TB/s, 26 * 2 * M*K*N / 1979 TOP/s),
// bytes = 8 MK + 4 KN + 8 MN (each input read once, the output written
// once).  26 is the fewest int8 plane products any byte-digit scheme needs:
// x has 8 byte digits and w at least 4 (bytes 0-2 as u8, byte 3 as s8;
// mma.sync takes u8 x u8 and u8 x s8), and only i + j < 8 counts, so
// 8 + 7 + 6 + 5.  This kernel issues 30 (w's 5 balanced digits): every
// digit of w then fits s8, one MMA type serves all, and a shift's int32
// sum holds 16416 of K, where the 4 raw bytes' (3 * 255 * 255 + 255 * 128
// per k) hold 9430.  At the main path's K >= 576 shapes the two bounds are
// within 1.7x of each other.
//
// Design, by what bounds it:
// 1. Tensor cores: each warp owns a 32 x 16 output tile (2 x 2 m16n8
//    tiles x 8 shifts = 128 int32 accumulators per thread).  Per K step of
//    32 it loads w's 5 digit fragments once (20 registers), then for each
//    of x's 8 byte planes its two A fragments, and issues the 30 x 4 MMAs
//    (a 16 x 32 warp tile would hold 40 registers of w fragments).
// 2. Filling 132 SMs: blocks hold 32 rows (one warp tile) and 64 columns;
//    where the output tiles give fewer blocks than the card holds at once
//    (occupancy x SMs), K is split over grid.z.  Split-K partials are added
//    with 64-bit atomicAdd (red.global.add.u64) into an output the launch
//    zeroes first with cudaMemsetAsync on the same stream; integer addition
//    mod 2^64 is associative, so the result is exact and the same on every
//    run.  Without a split the epilogue stores and nothing is zeroed.
// 3. Memory: x and w tiles are staged raw (x as the int64s themselves, so
//    it is read from device memory once per output column tile) with
//    cp.async in a 3-stage ring; after a stage lands, the block rewrites it
//    once into fragment-ordered digit planes (a byte transpose with prmt
//    for x, two integer ops and a transpose for w), so every fragment is
//    one conflict-free 16- or 8-byte shared load.  The planes are double
//    buffered: step k + 1's rewrite runs beside step k's MMAs, with one
//    barrier per step.
//
// Layouts: x (M, K) int64, w (K, N) int32, out (M, N) int64, row-major.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BN = 64;                 // block columns: 4 warps of 16
constexpr int BK = 32;                 // K per stage: one m16n8k32 step
constexpr int kStages = 3;
constexpr int kWarpM = 32, kMT = kWarpM / 16;  // warp rows, m16 tiles
constexpr int kWarpN = 16, kNT = kWarpN / 8;   // warp columns, n8 tiles
constexpr int kWarpsN = BN / kWarpN;
constexpr int kBlockNT = BN / 8;
constexpr int BM = kWarpM;              // block rows: one warp tile
constexpr int kBlockMT = BM / 16;
constexpr int kThreads = 32 * kWarpsN;
constexpr int kXRaw = BM * BK * 8;      // uint64 [BM][BK]
constexpr int kWRaw = BK * BN * 4;      // int32 [BK][BN]
constexpr int kStage = kXRaw + kWRaw;
constexpr int kXPlanes = 8 * BM * BK;   // u8 planes, fragment order
constexpr int kWPlanes = 5 * BK * BN;   // s8 planes, fragment order
constexpr int kSmem = kStages * kStage + 2 * (kXPlanes + kWPlanes);
constexpr int kFoldSteps = 16384 / BK;  // most K steps one block contracts
constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 16, 8 or 4 bytes; a source size of 0 fills zeros (ragged edges)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 8 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

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

__device__ __forceinline__ void mma_u8s8(int32_t c[4], const uint4& a,
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b[0]), "r"(b[1]));
}

// Copy the raw x [BM][BK] and w [BK][BN] tiles of one K step into a stage.
__device__ __forceinline__ void load_stage(
    char* stage, const uint64_t* __restrict__ x, const int32_t* __restrict__ w,
    int64_t M, int64_t K, int64_t N, int64_t row0, int64_t col0, int64_t k0,
    bool x_vec, bool w_vec) {
  uint64_t* xr = reinterpret_cast<uint64_t*>(stage);
  int32_t* wr = reinterpret_cast<int32_t*>(stage + kXRaw);
  if (x_vec) {                      // K even, x 16-byte aligned: pairs of k
    for (int t = threadIdx.x; t < BM * BK / 2; t += kThreads) {
      const int r = t / (BK / 2), c = (t % (BK / 2)) * 2;
      const int64_t gr = row0 + r, gk = k0 + c;
      const bool ok = gr < M && gk < K;
      cp_async16(xr + r * BK + c, ok ? x + gr * K + gk : x, ok);
    }
  } else {
    for (int t = threadIdx.x; t < BM * BK; t += kThreads) {
      const int r = t / BK, c = t % BK;
      const int64_t gr = row0 + r, gk = k0 + c;
      const bool ok = gr < M && gk < K;
      cp_async8(xr + r * BK + c, ok ? x + gr * K + gk : x, ok);
    }
  }
  if (w_vec) {                      // N % 4 == 0, w 16-byte aligned
    for (int t = threadIdx.x; t < BK * BN / 4; t += kThreads) {
      const int r = t / (BN / 4), c = (t % (BN / 4)) * 4;
      const int64_t gk = k0 + r, gc = col0 + c;
      const bool ok = gk < K && gc < N;
      cp_async16(wr + r * BN + c, ok ? w + gk * N + gc : w, ok);
    }
  } else {
    for (int t = threadIdx.x; t < BK * BN; t += kThreads) {
      const int r = t / BN, c = t % BN;
      const int64_t gk = k0 + r, gc = col0 + c;
      const bool ok = gk < K && gc < N;
      cp_async4(wr + r * BN + c, ok ? w + gk * N + gc : w, ok);
    }
  }
}

// Rewrite one landed stage into fragment-ordered digit planes.
//   xp: plane i, m16 tile mt, lane (g, t): the A fragment's 4 words
//       (row g, k 4t..4t+3), (row g+8, same k), (row g, k 16+4t..), (row g+8, ..)
//   wp: digit j, n8 tile nt, lane (g, t): the B fragment's 2 words
//       (column g, k 4t..4t+3), (column g, k 16+4t..), at slot lane ^ 2nt
//       (so that the stores below spread over the banks)
__device__ __forceinline__ void make_digits(const char* stage, uint32_t* xp,
                                            uint32_t* wp) {
  const uint64_t* xr = reinterpret_cast<const uint64_t*>(stage);
  const int32_t* wr = reinterpret_cast<const int32_t*>(stage + kXRaw);
  for (int t = threadIdx.x; t < BM * (BK / 4); t += kThreads) {
    const int r = t / (BK / 4), kq = t % (BK / 4);    // row, 4 k's
    const uint4* src = reinterpret_cast<const uint4*>(xr + r * BK + kq * 4);
    const uint4 a = src[0], b = src[1];
    const uint32_t lo[4] = {a.x, a.z, b.x, b.z}, hi[4] = {a.y, a.w, b.y, b.w};
    uint32_t p[8];
    transpose4(lo, p);
    transpose4(hi, p + 4);
    const int mt = r / 16, rr = r % 16;
    const int lane = (rr % 8) * 4 + kq % 4, reg = rr / 8 + 2 * (kq / 4);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      xp[((i * kBlockMT + mt) * 32 + lane) * 4 + reg] = p[i];
  }
  for (int t = threadIdx.x; t < (BK / 4) * (BN / 4); t += kThreads) {
    const int kq = t / (BN / 4), nq = t % (BN / 4);   // 4 k's x 4 columns
    uint32_t v[4][4], top[4] = {0, 0, 0, 0};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int4 q = *reinterpret_cast<const int4*>(wr + (kq * 4 + c) * BN + nq * 4);
      const int32_t vals[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        // bytes of (w + 0x80808080) mod 2^32, each minus 128, as s8
        v[d][c] = (static_cast<uint32_t>(vals[d]) + 0x80808080u) ^ 0x80808080u;
        top[d] |= static_cast<uint32_t>(vals[d] >= 0x7F7F7F80) << (8 * c);
      }
    }
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      uint32_t dig[4];
      transpose4(v[d], dig);
      const int n = nq * 4 + d, nt = n / 8;
      const int lane = (n % 8) * 4 + kq % 4, reg = kq / 4;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wp[((j * kBlockNT + nt) * 32 + (lane ^ 2 * nt)) * 2 + reg] = dig[j];
      wp[((4 * kBlockNT + nt) * 32 + (lane ^ 2 * nt)) * 2 + reg] = top[d];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
ring_matmul_kernel(const uint64_t* __restrict__ x, const int32_t* __restrict__ w,
                   uint64_t* __restrict__ out, int64_t M, int64_t K, int64_t N,
                   int steps_per_split, bool x_vec, bool w_vec, bool atomic) {
  extern __shared__ __align__(16) char smem[];
  char* stages = smem;
  constexpr int kXBuf = kXPlanes / 4, kWBuf = kWPlanes / 4;
  uint32_t* xp = reinterpret_cast<uint32_t*>(smem + kStages * kStage);
  uint32_t* wp = xp + 2 * kXBuf;

  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int64_t col0 = static_cast<int64_t>(blockIdx.y) * BN;
  const int64_t step0 = static_cast<int64_t>(blockIdx.z) * steps_per_split;
  const int64_t left = (K + BK - 1) / BK - step0;
  const int n_steps = static_cast<int>(left < steps_per_split ? left : steps_per_split);
  const int wn = threadIdx.x / 32, lane = threadIdx.x % 32;   // warp: columns

  int32_t acc[8][kMT][kNT][4];
#pragma unroll
  for (int s = 0; s < 8; ++s)
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[s][mi][nt][r] = 0;

  // K step kt: raw tiles in stage kt % kStages, digit planes in buffer kt % 2.
  // One barrier per step: while a warp runs step kt's MMAs, the others may
  // already rewrite step kt + 1's raw tiles into the other plane buffer.
#pragma unroll
  for (int s = 0; s < kStages; ++s) {
    if (s < n_steps)
      load_stage(stages + s * kStage, x, w, M, K, N, row0, col0,
                 (step0 + s) * BK, x_vec, w_vec);
    cp_async_commit();
  }
  cp_async_wait<kStages - 1>();
  __syncthreads();
  make_digits(stages, xp, wp);
  cp_async_wait<kStages - 2>();
  __syncthreads();
  for (int kt = 0; kt < n_steps; ++kt) {
    const int next = kt + kStages;         // into the stage step kt emptied
    if (next < n_steps)
      load_stage(stages + (kt % kStages) * kStage, x, w, M, K, N,
                 row0, col0, (step0 + next) * BK, x_vec, w_vec);
    cp_async_commit();
    const int buf = kt % 2;
    if (kt + 1 < n_steps)
      make_digits(stages + ((kt + 1) % kStages) * kStage,
                  xp + (1 - buf) * kXBuf, wp + (1 - buf) * kWBuf);
    const uint32_t* xb = xp + buf * kXBuf;
    const uint32_t* wb = wp + buf * kWBuf;

    uint32_t b[5][kNT][2];
#pragma unroll
    for (int j = 0; j < 5; ++j)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int bt = wn * kNT + nt;
        const uint2 q = *reinterpret_cast<const uint2*>(
            wb + ((j * kBlockNT + bt) * 32 + (lane ^ 2 * bt)) * 2);
        b[j][nt][0] = q.x;
        b[j][nt][1] = q.y;
      }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      uint4 a[kMT];
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi)
        a[mi] = *reinterpret_cast<const uint4*>(
            xb + ((i * kBlockMT + mi) * 32 + lane) * 4);
#pragma unroll
      for (int j = 0; j < 5; ++j) {
        if (i + j >= 8) continue;        // 2^64 divides 2^(8(i+j))
#pragma unroll
        for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt)
            mma_u8s8(acc[i + j][mi][nt], a[mi], b[j][nt]);
      }
    }
    cp_async_wait<kStages - 2>();          // step kt + 2's tiles landed
    __syncthreads();
  }

  // fold the shift sums into 64 bits: out = sum_s (int64) acc_s << 8s
  const int g = lane / 4, tg = lane % 4;
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int64_t gr = row0 + mi * 16 + g + 8 * (r / 2);
      const int64_t gc = col0 + wn * kWarpN + nt * 8 + tg * 2 + r % 2;
      uint64_t v = 0;
#pragma unroll
      for (int s = 0; s < 8; ++s)
        v += static_cast<uint64_t>(static_cast<int64_t>(acc[s][mi][nt][r])) << (8 * s);
      if (gr < M && gc < N) {
        if (atomic)
          atomicAdd(reinterpret_cast<unsigned long long*>(out + gr * N + gc),
                    static_cast<unsigned long long>(v));
        else
          out[gr * N + gc] = v;
      }
    }
}

int launch(const void* x, const void* w, void* out, int64_t m, int64_t k,
           int64_t n, cudaStream_t stream) {
  static int blocks_per_sm[kMaxDevices] = {};   // 0: not configured yet
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (blocks_per_sm[dev] == 0) {
    err = cudaFuncSetAttribute(ring_matmul_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    int occ = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, ring_matmul_kernel, kThreads, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    blocks_per_sm[dev] = occ > 0 ? occ : 1;
  }
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);

  const int64_t m_tiles = (m + BM - 1) / BM, n_tiles = (n + BN - 1) / BN;
  const int64_t steps = (k + BK - 1) / BK;
  // split K until one wave of blocks fills the card, and at least so far
  // that no block contracts more than the int32 accumulators hold
  const int64_t room = static_cast<int64_t>(sms) * blocks_per_sm[dev] / (m_tiles * n_tiles);
  int64_t split = room < 1 ? 1 : (room < steps ? room : steps);
  int64_t chunk = (steps + split - 1) / split;
  if (chunk > kFoldSteps) chunk = kFoldSteps;
  split = (steps + chunk - 1) / chunk;
  const bool atomic = split > 1;
  if (atomic) {
    err = cudaMemsetAsync(out, 0, static_cast<size_t>(m * n) * sizeof(uint64_t), stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const bool x_vec = k % 2 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool w_vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const dim3 grid(static_cast<unsigned int>(m_tiles), static_cast<unsigned int>(n_tiles),
                  static_cast<unsigned int>(split));
  ring_matmul_kernel<<<grid, kThreads, kSmem, stream>>>(
      static_cast<const uint64_t*>(x), static_cast<const int32_t*>(w),
      static_cast<uint64_t*>(out), m, k, n, static_cast<int>(chunk), x_vec, w_vec,
      atomic);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// m, k, n >= 1; ceil(m / 32) < 2^31, ceil(n / 64) <= 65535 (the wrapper checks).
extern "C" int hb_ring_matmul(const void* x, const void* w, void* out,
                              int64_t m, int64_t k, int64_t n, void* stream) {
  return launch(x, w, out, m, k, n, static_cast<cudaStream_t>(stream));
}
