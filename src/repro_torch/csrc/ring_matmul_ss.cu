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
// s + 1 plane products u_i @ v_j go through the int8 tensor cores (u8 x u8
// -> s32: wgmma m64n32k32 in the large form, mma.sync m16n8k32 in the
// small one) into one int32 accumulator per shift (36 plane products in
// all; 2^64 divides every term with i + j >= 8), and out = sum_s acc_s <<
// 8s mod 2^64.
//
// Split-K.  A shift's sum is non-negative and grows by at most
// (s + 1) * 255^2 <= 520200 per k, so 4096 of K (2 130 739 200) stay below
// 2^31 for every shift.  No accumulator sums more than kMaxSteps K steps
// (4096 of K): a longer K is cut into work units of at most that much,
// and K is also cut where the output tiles give fewer units than the card
// holds at once.  Each unit adds its 64-bit partial sum_s acc_s << 8s into
// the output with red.global.add.u64, into an output the launch zeroes
// first with cudaMemsetAsync on the same stream; addition mod 2^64 is
// associative, so the result is exact and the same on every run.  Without
// a split the epilogue stores and nothing is zeroed.  No accumulator ever
// wraps, so the result does not rest on how the tensor cores treat an
// overflow.  kernels/ref.py ring_matmul_ss_digits repeats this arithmetic
// in plain torch and raises where a shift's sum would leave int32.
//
// Bound on the card: max(bytes / 3.35 TB/s, 36 * 2 * B*M*K*N / 1979 TOP/s),
// bytes = 8 (BMK + BKN + BMN) (each input read once, the output written
// once).
//
// Two forms, chosen by the wrapper (kernels/ops.py) from the shape:
//
// 1. Large (M >= 64: attention at hundreds of tokens, long K).  Blocks of
//    two warpgroups own 64 x 64 output tiles (so x is read once where
//    N <= 64); warpgroup w computes columns 32w..32w+31 as one m64n32 tile
//    per shift (8 x 16 = 128 int32 accumulators a thread).  The grid is
//    persistent (at most the blocks the card holds at once) and each block
//    walks its work units, (cell, row tile, column tile, K chunk), as one
//    stream of K steps:
//    - raw int64 tiles of x [64][32] and y [32][64] land with 16-byte
//      cp.async (8-byte where K or N is odd) in a ring of kStages = 4
//      stages, loaded kStages steps ahead, across unit boundaries, so the
//      next unit's first tiles are in flight during this one's last steps
//      (192 KB of shared memory with the planes: one block an SM);
//    - once a stage lands the block rewrites it once into byte planes with
//      a 4 x 4 byte transpose (prmt): the second warpgroup x's, into the
//      A fragments' register order (one conflict-free 16-byte load a lane
//      and plane; x's stage has its 16-byte chunks XOR-swizzled so that
//      the rewrite's loads hit distinct banks), the first y's,
//      into wgmma's K-major B layout without swizzle (each 8 columns x 16
//      bytes of K a 128-byte core matrix; descriptor strides 1024 bytes
//      between the halves of K, 128 between groups of 8 columns);
//    - the planes are double-buffered, with one barrier per step: a step
//      issues its 36 wgmmas (A from registers, B from shared memory) and
//      waits for them, then loads step q + kStages and rewrites step q + 1;
//    - after a unit's last step the warps fold their sums and store (or
//      add) them.
// 2. Small (M < 64: the LM's 8-row products).  One warp per 16 x 8 output
//    tile and K chunk, 4 warps per block, so a block packs up to 4 batch
//    cells and no warp computes only padding.  Where N > M the warp
//    computes the transposed product out^T = y^T @ x^T, so the 16 rows of
//    the m16 tile come from the longer side (the LM's 8 x 8 @ 8 x 64 fills
//    them).  There is no shared memory: each thread loads the int64s its
//    A and B fragments need straight into registers (16-byte loads along
//    K where the operand is K-contiguous), transposes them into byte
//    planes there, and issues the next step's loads before this step's 36
//    mma.sync.
//
// wgmma or mma.sync for the large form.  The census: with 8 shift
// accumulators a warpgroup's m64nN tile holds N/2 int32 a thread for each
// shift, 4N registers, so N = 32 (as mma.sync's 32 x 16 warp tile, 128
// registers); this form needs 254 registers and spills none.  The times
// (one H100, in turns with an mma.sync version of the same pipeline, in
// which each of the 8 warps issues 144 mma.sync a step): less at every
// large shape.  Issuing the wgmmas and waiting at once measured faster
// than letting them run under the next step's loads and rewrite, and
// faster than the two warpgroups in opposite order (which spilled).  What
// holds the form back is that a step's products and its loads and
// rewrite still take turns (PERF.md §6).
//
// Layouts: x (B, M, K), y (B, K, N), out (B, M, N), int64, row-major.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BK = 32;                   // K per step: one k32 MMA
constexpr int kMaxSteps = 4096 / BK;     // most K steps one accumulator sums
constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 16 or 8 bytes; a source size of 0 fills zeros (ragged edges)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 8 : 0));
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

// p[i] = byte i of v[0..3], 4 consecutive k's: one word of each byte plane
__device__ __forceinline__ void byte_planes(const uint64_t v[4], uint32_t p[8]) {
  const uint32_t lo[4] = {static_cast<uint32_t>(v[0]), static_cast<uint32_t>(v[1]),
                          static_cast<uint32_t>(v[2]), static_cast<uint32_t>(v[3])};
  const uint32_t hi[4] = {static_cast<uint32_t>(v[0] >> 32), static_cast<uint32_t>(v[1] >> 32),
                          static_cast<uint32_t>(v[2] >> 32), static_cast<uint32_t>(v[3] >> 32)};
  transpose4(lo, p);
  transpose4(hi, p + 4);
}

// (not volatile, so that the compiler may schedule other work among them)
__device__ __forceinline__ void mma_u8u8(int32_t c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// sum_s acc[s] << 8s mod 2^64 (each acc[s] a non-negative int32 sum)
__device__ __forceinline__ uint64_t fold(const int32_t (&acc)[8]) {
  uint64_t v = 0;
#pragma unroll
  for (int s = 0; s < 8; ++s)
    v += static_cast<uint64_t>(static_cast<uint32_t>(acc[s])) << (8 * s);
  return v;
}

__device__ __forceinline__ void put(uint64_t* p, uint64_t v, bool atomic) {
  if (atomic)
    atomicAdd(reinterpret_cast<unsigned long long*>(p), static_cast<unsigned long long>(v));
  else
    *p = v;
}

// A work unit: (cell, row tile, column tile, K chunk), the chunk fastest.
struct Unit {
  int64_t cell, row0, col0, step0;
  int steps;
};

__device__ __forceinline__ Unit decode(int64_t u, int64_t split, int64_t r_tiles,
                                       int64_t c_tiles, int rows, int cols, int chunk,
                                       int64_t steps) {
  Unit w;
  const int64_t s = u % split;
  u /= split;
  w.col0 = u % c_tiles * cols;
  u /= c_tiles;
  w.row0 = u % r_tiles * rows;
  w.cell = u / r_tiles;
  w.step0 = s * chunk;
  const int64_t left = steps - w.step0;
  w.steps = static_cast<int>(left < chunk ? left : chunk);
  return w;
}

// ---------------------------------------------------------------- large form

namespace large {

constexpr int BM = 64, BN = 64;          // block tile
constexpr int kWGN = 32;                 // a warpgroup's columns: m64n32
constexpr int kThreads = 128 * (BN / kWGN);   // 2 warpgroups
constexpr int kBlockMT = BM / 16;
constexpr int kStages = 4;
constexpr int kXRaw = BM * BK * 8;       // uint64 [BM][BK], 16-byte chunks swizzled
constexpr int kYRaw = BK * BN * 8;       // uint64 [BK][BN]
constexpr int kStage = kXRaw + kYRaw;
constexpr int kXPlanes = 8 * BM * BK;    // u8 planes: A fragments
constexpr int kYPlanes = 8 * BN * BK;    // u8 planes: wgmma's K-major B
constexpr int kYPlane = BN * BK;         // bytes of one y plane
constexpr int kSmem = kStages * kStage + 2 * (kXPlanes + kYPlanes);

struct Shape {
  int64_t M, K, N, steps, split, m_tiles, n_tiles, units;
  int chunk;
  bool x_vec, y_vec, o_vec, atomic;
};

// x's row r holds 16 chunks of 2 k's; chunk c sits at c ^ (r % 2), so
// that the rewrite's 8-thread phases (rows r and r + 1, chunks 2t + e for
// t = 0..3) fall on 8 distinct 16-byte bank groups.
__device__ __forceinline__ int swz(int r, int c) { return c ^ (r & 1); }

// Copy one K step's raw x [BM][BK] and y [BK][BN] tiles into a stage.
__device__ __forceinline__ void load_stage(char* stage, const uint64_t* __restrict__ x,
                                           const uint64_t* __restrict__ y,
                                           const Shape& sh, const Unit& w, int step) {
  uint64_t* xr = reinterpret_cast<uint64_t*>(stage);
  uint64_t* yr = reinterpret_cast<uint64_t*>(stage + kXRaw);
  const int64_t k0 = (w.step0 + step) * BK;
  const uint64_t* xb = x + w.cell * sh.M * sh.K;
  const uint64_t* yb = y + w.cell * sh.K * sh.N;
  if (sh.x_vec) {                   // K even, x 16-byte aligned: pairs of k
#pragma unroll
    for (int it = 0; it < BM * BK / 2 / kThreads; ++it) {
      const int t = threadIdx.x + it * kThreads;
      const int r = t / (BK / 2), c = t % (BK / 2);
      const int64_t gr = w.row0 + r, gk = k0 + 2 * c;
      const bool ok = gr < sh.M && gk < sh.K;
      cp_async16(xr + r * BK + 2 * swz(r, c), ok ? xb + gr * sh.K + gk : x, ok);
    }
  } else {
#pragma unroll
    for (int it = 0; it < BM * BK / kThreads; ++it) {
      const int t = threadIdx.x + it * kThreads;
      const int r = t / BK, e = t % BK;
      const int64_t gr = w.row0 + r, gk = k0 + e;
      const bool ok = gr < sh.M && gk < sh.K;
      cp_async8(xr + r * BK + 2 * swz(r, e / 2) + e % 2, ok ? xb + gr * sh.K + gk : x, ok);
    }
  }
  if (sh.y_vec) {                   // N even, y 16-byte aligned: pairs of columns
#pragma unroll
    for (int it = 0; it < BK * BN / 2 / kThreads; ++it) {
      const int t = threadIdx.x + it * kThreads;
      const int r = t / (BN / 2), c = 2 * (t % (BN / 2));
      const int64_t gk = k0 + r, gc = w.col0 + c;
      const bool ok = gk < sh.K && gc < sh.N;
      cp_async16(yr + r * BN + c, ok ? yb + gk * sh.N + gc : y, ok);
    }
  } else {
#pragma unroll
    for (int it = 0; it < BK * BN / kThreads; ++it) {
      const int t = threadIdx.x + it * kThreads;
      const int r = t / BN, c = t % BN;
      const int64_t gk = k0 + r, gc = w.col0 + c;
      const bool ok = gk < sh.K && gc < sh.N;
      cp_async8(yr + r * BN + c, ok ? yb + gk * sh.N + gc : y, ok);
    }
  }
}

// Rewrite one landed stage into byte planes.
//   xp [plane i][m16 tile mt][lane (g, t)][4 words]: the A fragment's
//       (row g, k 4t..4t+3), (row g+8, same k), (row g, k 16+4t..),
//       (row g+8, k 16+4t..); one 16-byte load a lane.  A thread builds
//       one lane's fragment of one m16 tile for all 8 planes: one 16-byte
//       store a plane, 32 lanes on 512 contiguous bytes.
//   yp [plane j][k half kb][column n][16 bytes]: k 16kb..16kb+15 of column
//       n, wgmma's K-major B without swizzle: each core matrix (8 columns x
//       16 bytes of K) is 128 contiguous bytes, the next 8 columns 128
//       bytes on, the other half of K 1024 bytes on.  A thread takes one
//       column and one half of K: one 16-byte store a plane, 32 lanes on
//       512 contiguous bytes.
__device__ __forceinline__ void make_planes(const char* stage, uint32_t* xp, char* yp) {
  const uint64_t* xr = reinterpret_cast<const uint64_t*>(stage);
  const uint64_t* yr = reinterpret_cast<const uint64_t*>(stage + kXRaw);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= 4) {                       // the second warpgroup: x
    // warp: m16 tile; lane (g, t): its A fragment, rows g and g + 8 at
    // k's 4t.. and 16 + 4t.., for all 8 planes
    const int mt = warp - 4, g = lane / 4, t = lane % 4;
    uint32_t f[8][4];                    // [plane][fragment register]
#pragma unroll
    for (int reg = 0; reg < 4; ++reg) {
      const int r = mt * 16 + g + 8 * (reg % 2), c = 2 * t + 8 * (reg / 2);
      const uint64_t* row = xr + r * BK;
      const uint4 c0 = *reinterpret_cast<const uint4*>(row + 2 * swz(r, c));      // k 2c, +1
      const uint4 c1 = *reinterpret_cast<const uint4*>(row + 2 * swz(r, c + 1));  // k 2c+2, +3
      const uint32_t lo[4] = {c0.x, c0.z, c1.x, c1.z};
      const uint32_t hi[4] = {c0.y, c0.w, c1.y, c1.w};
      uint32_t p[8];
      transpose4(lo, p);
      transpose4(hi, p + 4);
#pragma unroll
      for (int i = 0; i < 8; ++i) f[i][reg] = p[i];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<uint4*>(xp + ((i * kBlockMT + mt) * 32 + lane) * 4) =
          make_uint4(f[i][0], f[i][1], f[i][2], f[i][3]);
  } else {                               // the first warpgroup: y
    const int n = threadIdx.x % BN, kb = threadIdx.x / BN;
    uint32_t w[8][4];                    // [plane][word of 4 k's]
#pragma unroll
    for (int kq = 0; kq < 4; ++kq) {
      uint64_t v[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) v[c] = yr[(16 * kb + 4 * kq + c) * BN + n];
      uint32_t p[8];
      byte_planes(v, p);
#pragma unroll
      for (int j = 0; j < 8; ++j) w[j][kq] = p[j];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<uint4*>(yp + j * kYPlane + kb * (BN * 16) + n * 16) =
          make_uint4(w[j][0], w[j][1], w[j][2], w[j][3]);
  }
  // the y planes are read by wgmma, through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma's shared-memory descriptor of a K-major B tile without swizzle:
// start, leading byte offset (between the two 16-byte halves of K) and
// stride byte offset (between 8-column core matrices), each in 16 bytes.
__device__ __forceinline__ uint64_t b_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16 |
         static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32;
}

// d[64 x 32] += a[64 x 32 bytes] (registers: this warp's m16 rows, the
// m16n8k32 A fragment) @ b[32 bytes x 32] (shared memory), u8 x u8 -> s32
__device__ __forceinline__ void wgmma_u8(int32_t (&d)[16], const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.u8.u8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// keep the compiler from moving register reads or writes across wgmma
__device__ __forceinline__ void fence_operand(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}
__device__ __forceinline__ void fence_operand(int32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

__global__ void __launch_bounds__(kThreads, 1)
ring_matmul_ss_kernel_large(const uint64_t* __restrict__ x, const uint64_t* __restrict__ y,
                            uint64_t* __restrict__ out, Shape sh) {
  extern __shared__ __align__(128) char smem[];
  constexpr int kXBuf = kXPlanes / 4;    // words
  char* stages = smem;
  uint32_t* xp = reinterpret_cast<uint32_t*>(smem + kStages * kStage);
  char* yp = smem + kStages * kStage + 2 * kXPlanes;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4, wi = warp % 4;     // warpgroup: columns; warp: m16 rows
  const int g = lane / 4, tg = lane % 4;
  auto unit = [&](int64_t u) {
    return decode(u, sh.split, sh.m_tiles, sh.n_tiles, BM, BN, sh.chunk, sh.steps);
  };
  auto unit_steps = [&](int64_t u) {
    const int64_t left = sh.steps - u % sh.split * sh.chunk;
    return static_cast<int>(left < sh.chunk ? left : sh.chunk);
  };

  int32_t acc[8][16];                    // [shift][m64n32 fragment]
#pragma unroll
  for (int s = 0; s < 8; ++s)
#pragma unroll
    for (int r = 0; r < 16; ++r) acc[s][r] = 0;

  // The block's stream of K steps over units blockIdx.x, blockIdx.x +
  // gridDim.x, ...: two cursors (unit, step in it) run ahead of the
  // products, the loads' kStages steps and the rewrite's one.  Stream step
  // q's raw tiles sit in stage q % kStages, its planes in buffer q % 2.
  int64_t lu = blockIdx.x, du = lu, mu = lu;
  Unit lw = unit(lu);
  int ls = 0, ds = 0, dn = lw.steps;
  auto next = [&](int64_t& u, int& s, int& n) {
    if (++s == n) {
      s = 0;
      u += gridDim.x;
      if (u < sh.units) n = unit_steps(u);
    }
  };
  auto next_load = [&]() {
    if (++ls == lw.steps) {
      ls = 0;
      lu += gridDim.x;
      if (lu < sh.units) lw = unit(lu);
    }
  };

#pragma unroll
  for (int st = 0; st < kStages; ++st) {
    if (lu < sh.units) {
      load_stage(stages + st * kStage, x, y, sh, lw, ls);
      next_load();
    }
    cp_async_commit();
  }
  cp_async_wait<kStages - 1>();
  __syncthreads();
  make_planes(stages, xp, yp);
  next(du, ds, dn);
  cp_async_wait<kStages - 2>();
  __syncthreads();

  int q = 0;                             // the stream's step
  for (; mu < sh.units; mu += gridDim.x) {
    const int mn = unit_steps(mu);
    for (int ms = 0; ms < mn; ++ms, ++q) {
      const int buf = q % 2;
      // step q's 36 plane products, issued at once and waited for
      uint32_t a[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const uint4 v = *reinterpret_cast<const uint4*>(
            xp + buf * kXBuf + ((i * kBlockMT + wi) * 32 + lane) * 4);
        a[i][0] = v.x;
        a[i][1] = v.y;
        a[i][2] = v.z;
        a[i][3] = v.w;
      }
      const char* yb = yp + buf * kYPlanes + wg * kWGN * 16;
#pragma unroll
      for (int s = 0; s < 8; ++s)
#pragma unroll
        for (int r = 0; r < 16; ++r) fence_operand(acc[s][r]);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j + i < 8; ++j)
          wgmma_u8(acc[i + j], a[i], b_desc(yb + j * kYPlane, BN * 16, 128));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int r = 0; r < 4; ++r) fence_operand(a[i][r]);
#pragma unroll
      for (int s = 0; s < 8; ++s)
#pragma unroll
        for (int r = 0; r < 16; ++r) fence_operand(acc[s][r]);

      // then step q + kStages's loads and step q + 1's rewrite
      if (lu < sh.units) {               // into the stage step q emptied
        load_stage(stages + (q % kStages) * kStage, x, y, sh, lw, ls);
        next_load();
      }
      cp_async_commit();
      if (du < sh.units) {
        make_planes(stages + ((q + 1) % kStages) * kStage, xp + (1 - buf) * kXBuf,
                    yp + (1 - buf) * kYPlanes);
        next(du, ds, dn);
      }
      cp_async_wait<kStages - 2>();      // stream step q + 2's tiles landed
      __syncthreads();
    }
    // the unit's epilogue
    const Unit mw = unit(mu);
    uint64_t* ob = out + mw.cell * sh.M * sh.N;
#pragma unroll
    for (int c = 0; c < kWGN / 8; ++c)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // fragment 4c + 2h + e: row 16 wi + g + 8h, column 8c + 2tg + e
        int32_t s0[8], s1[8];
#pragma unroll
        for (int s = 0; s < 8; ++s) {
          s0[s] = acc[s][4 * c + 2 * h];
          s1[s] = acc[s][4 * c + 2 * h + 1];
          acc[s][4 * c + 2 * h] = acc[s][4 * c + 2 * h + 1] = 0;
        }
        const uint64_t v0 = fold(s0), v1 = fold(s1);
        const int64_t gr = mw.row0 + 16 * wi + g + 8 * h;
        const int64_t gc = mw.col0 + wg * kWGN + 8 * c + 2 * tg;
        if (gr < sh.M && gc < sh.N) {
          uint64_t* p = ob + gr * sh.N + gc;
          if (!sh.atomic && sh.o_vec) {     // N even: gc + 1 < N, 16-byte aligned
            *reinterpret_cast<ulonglong2*>(p) = make_ulonglong2(v0, v1);
          } else {
            put(p, v0, sh.atomic);
            if (gc + 1 < sh.N) put(p + 1, v1, sh.atomic);
          }
        }
      }
  }
}

}  // namespace large

// ---------------------------------------------------------------- small form

namespace small {

constexpr int kWarps = 4, kThreads = 32 * kWarps;

struct Shape {
  int64_t M, K, N, steps, split, r_tiles, c_tiles, units;
  int chunk;
  bool x_vec, atomic;
};

// 4 consecutive k's of a K-contiguous row (zero past K or off the tile)
__device__ __forceinline__ void load_row4(uint64_t v[4], const uint64_t* row, int64_t k,
                                          int64_t K, bool ok, bool vec) {
  if (ok && vec && k + 3 < K) {
    const ulonglong2 a = __ldg(reinterpret_cast<const ulonglong2*>(row + k));
    const ulonglong2 b = __ldg(reinterpret_cast<const ulonglong2*>(row + k + 2));
    v[0] = a.x;
    v[1] = a.y;
    v[2] = b.x;
    v[3] = b.y;
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = ok && k + c < K ? __ldg(row + k + c) : 0;
  }
}

// 4 consecutive k's of a column of a [K][ld] matrix
__device__ __forceinline__ void load_col4(uint64_t v[4], const uint64_t* col, int64_t k,
                                          int64_t K, int64_t ld, bool ok) {
#pragma unroll
  for (int c = 0; c < 4; ++c) v[c] = ok && k + c < K ? __ldg(col + (k + c) * ld) : 0;
}

// One warp: the 16 x 8 tile at (row0, col0) of one cell's P @ Q over one
// K chunk, P = x and Q = y, or (kTrans) P = y^T and Q = x^T.  Thread (g, t)
// holds A's rows g and g + 8 and B's column g, at k's 4t.. and 16 + 4t..
template <bool kTrans>
__global__ void __launch_bounds__(kThreads)
ring_matmul_ss_kernel_small(const uint64_t* __restrict__ x, const uint64_t* __restrict__ y,
                            uint64_t* __restrict__ out, Shape sh) {
  const int64_t u = static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (u >= sh.units) return;
  const Unit w = decode(u, sh.split, sh.r_tiles, sh.c_tiles, 16, 8, sh.chunk, sh.steps);
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int64_t R = kTrans ? sh.N : sh.M, C = kTrans ? sh.M : sh.N;
  const uint64_t* xb = x + w.cell * sh.M * sh.K;
  const uint64_t* yb = y + w.cell * sh.K * sh.N;
  const int64_t ra = w.row0 + g, rb = ra + 8, cg = w.col0 + g;
  const bool ok_a = ra < R, ok_b = rb < R, ok_c = cg < C;
  // P's rows ra, rb and Q's column cg, at k = 0
  const uint64_t* pa = kTrans ? yb + (ok_a ? ra : 0) : xb + (ok_a ? ra : 0) * sh.K;
  const uint64_t* pb = kTrans ? yb + (ok_b ? rb : 0) : xb + (ok_b ? rb : 0) * sh.K;
  const uint64_t* qc = kTrans ? xb + (ok_c ? cg : 0) * sh.K : yb + (ok_c ? cg : 0);

  // raw[h][.]: k 4t + 16h .. + 3 of P's row ra (0..3), row rb (4..7), Q's column (8..11)
  uint64_t raw[2][12];
  auto load = [&](int64_t k0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t k = k0 + 4 * t + 16 * h;
      if (kTrans) {
        load_col4(raw[h], pa, k, sh.K, sh.N, ok_a);
        load_col4(raw[h] + 4, pb, k, sh.K, sh.N, ok_b);
        load_row4(raw[h] + 8, qc, k, sh.K, ok_c, sh.x_vec);
      } else {
        load_row4(raw[h], pa, k, sh.K, ok_a, sh.x_vec);
        load_row4(raw[h] + 4, pb, k, sh.K, ok_b, sh.x_vec);
        load_col4(raw[h] + 8, qc, k, sh.K, sh.N, ok_c);
      }
    }
  };

  int32_t acc[4][8];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int s = 0; s < 8; ++s) acc[r][s] = 0;

  load(w.step0 * BK);
  for (int st = 0; st < w.steps; ++st) {
    uint32_t a[8][4], b[8][2], p[8];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      byte_planes(raw[h], p);            // row ra: a[.][0] (h = 0), a[.][2]
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i][2 * h] = p[i];
      byte_planes(raw[h] + 4, p);        // row rb: a[.][1], a[.][3]
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i][2 * h + 1] = p[i];
      byte_planes(raw[h] + 8, p);        // column: b[.][h]
#pragma unroll
      for (int i = 0; i < 8; ++i) b[i][h] = p[i];
    }
    if (st + 1 < w.steps) load((w.step0 + st + 1) * BK);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j + i < 8; ++j) {
        int32_t c[4] = {acc[0][i + j], acc[1][i + j], acc[2][i + j], acc[3][i + j]};
        mma_u8u8(c, a[i], b[j]);
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][i + j] = c[r];
      }
  }

  // c[r]: P-row row0 + g + 8 (r / 2), Q-column col0 + 2t + r % 2
  uint64_t* ob = out + w.cell * sh.M * sh.N;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int64_t pr = w.row0 + g + 8 * (r / 2), qc2 = w.col0 + 2 * t + r % 2;
    if (pr < R && qc2 < C)
      put(ob + (kTrans ? qc2 * sh.N + pr : pr * sh.N + qc2), fold(acc[r]), sh.atomic);
  }
}

}  // namespace small

// K cut into chunks: where `tiles` units fill fewer than `room` slots, up
// to room / tiles chunks, and never more than kMaxSteps steps a chunk.
void cut_k(int64_t steps, int64_t tiles, int64_t room, int64_t& split, int& chunk) {
  const int64_t fill = room / tiles;
  int64_t s = fill < 1 ? 1 : (fill < steps ? fill : steps);
  int64_t c = (steps + s - 1) / s;
  if (c > kMaxSteps) c = kMaxSteps;
  chunk = static_cast<int>(c);
  split = (steps + c - 1) / c;
}

struct DeviceInfo {
  int sms = 0, large_blocks = 0, small_blocks = 0;
};

int device_info(DeviceInfo*& info) {
  static DeviceInfo infos[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  info = &infos[dev];
  if (info->sms) return 0;
  DeviceInfo d;
  err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(large::ring_matmul_ss_kernel_large,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, large::kSmem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &d.large_blocks, large::ring_matmul_ss_kernel_large, large::kThreads, large::kSmem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &d.small_blocks, small::ring_matmul_ss_kernel_small<false>, small::kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (d.large_blocks < 1) d.large_blocks = 1;
  if (d.small_blocks < 1) d.small_blocks = 1;
  *info = d;
  return 0;
}

int launch(const void* x, const void* y, void* out, int64_t b, int64_t m, int64_t k,
           int64_t n, int64_t form, cudaStream_t stream) {
  DeviceInfo* info = nullptr;
  int rc = device_info(info);
  if (rc) return rc;
  const int64_t steps = (k + BK - 1) / BK;
  const auto* xp = static_cast<const uint64_t*>(x);
  const auto* yp = static_cast<const uint64_t*>(y);
  auto* op = static_cast<uint64_t*>(out);
  bool atomic = false;
  auto zero = [&]() -> int {
    return static_cast<int>(cudaMemsetAsync(
        out, 0, static_cast<size_t>(b * m * n) * sizeof(uint64_t), stream));
  };
  if (form == 0) {
    large::Shape sh;
    sh.M = m, sh.K = k, sh.N = n, sh.steps = steps;
    sh.m_tiles = (m + large::BM - 1) / large::BM;
    sh.n_tiles = (n + large::BN - 1) / large::BN;
    const int64_t tiles = b * sh.m_tiles * sh.n_tiles;
    const int64_t room = static_cast<int64_t>(info->sms) * info->large_blocks;
    cut_k(steps, tiles, room, sh.split, sh.chunk);
    sh.units = tiles * sh.split;
    sh.atomic = atomic = sh.split > 1;
    sh.x_vec = k % 2 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    sh.y_vec = n % 2 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
    sh.o_vec = n % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
    if (atomic && (rc = zero())) return rc;
    const int64_t grid = sh.units < room ? sh.units : room;
    large::ring_matmul_ss_kernel_large<<<static_cast<unsigned int>(grid), large::kThreads,
                                         large::kSmem, stream>>>(xp, yp, op, sh);
  } else if (form == 1) {
    const bool trans = n > m;
    small::Shape sh;
    sh.M = m, sh.K = k, sh.N = n, sh.steps = steps;
    sh.r_tiles = ((trans ? n : m) + 15) / 16;
    sh.c_tiles = ((trans ? m : n) + 7) / 8;
    const int64_t tiles = b * sh.r_tiles * sh.c_tiles;
    const int64_t room = static_cast<int64_t>(info->sms) * info->small_blocks * small::kWarps;
    cut_k(steps, tiles, room, sh.split, sh.chunk);
    sh.units = tiles * sh.split;
    sh.atomic = atomic = sh.split > 1;
    sh.x_vec = k % 2 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    const int64_t grid = (sh.units + small::kWarps - 1) / small::kWarps;
    if (grid >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidConfiguration);
    if (atomic && (rc = zero())) return rc;
    if (trans)
      small::ring_matmul_ss_kernel_small<true><<<static_cast<unsigned int>(grid),
                                                 small::kThreads, 0, stream>>>(xp, yp, op, sh);
    else
      small::ring_matmul_ss_kernel_small<false><<<static_cast<unsigned int>(grid),
                                                  small::kThreads, 0, stream>>>(xp, yp, op, sh);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// b, m, k, n >= 1; form 0 (large) or 1 (small); the small form's blocks,
// b * ceil(max(m, n) / 16) * ceil(min(m, n) / 8) / 4, below 2^31 (the
// wrapper checks).
extern "C" int hb_ring_matmul_ss(const void* x, const void* y, void* out, int64_t b,
                                 int64_t m, int64_t k, int64_t n, int64_t form,
                                 void* stream) {
  return launch(x, y, out, b, m, k, n, form, static_cast<cudaStream_t>(stream));
}
