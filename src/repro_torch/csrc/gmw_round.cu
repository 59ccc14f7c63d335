// Fused GMW round-local compute on packed binary shares, for sm_90a.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/gmw_round.py:
//   hb_beaver_and  <- beaver_and_pallas  (:45)
//   hb_ks_mask     <- ks_mask_pallas     (:73)
//   hb_ks_combine  <- ks_combine_pallas  (:105)
//   hb_ks_level    <- ks_level_pallas    (:134)
//   hb_ks_step     <- ks_combine_pallas of one dense level fused with
//                     ks_mask_pallas of the next (:105, :73)
//
// All four are XOR/AND chains over uint32 words: a few integer operations
// per 4-byte word, far below the card's operations-per-byte balance, so
// device-memory bandwidth bounds them.  The design reads each input word
// once and writes each output word once, with neighbouring threads on
// neighbouring words (coalesced).  The Beaver selector is one word per
// party, read from a (P,) vector instead of a full broadcast array, which
// removes one input stream from beaver_and and ks_combine.  ks_level, the
// cone adder's per-level combine, updates the adder's dense g and p planes
// in place at the level's strided rows, reading the two halves of the
// level's AND output where they lie (party stride given): one pass per
// level, no gather or scatter around it.  Its bound is 20 bytes per
// (party, level row, word): g, z_g and z_p read, g and p written, all of
// them inputs or outputs the cone adder needs.
// At the main path's sizes (a few MB per call) launch latency dominates the
// bandwidth bound, so the dense adder's passes between two exchanges are
// one launch: hb_ks_step.
//
// hb_ks_step: the dense Kogge-Stone adder's work between the exchange of
// level l and that of level l+1, in one launch (ks_combine of l, then
// ks_mask of l+1).  It opens (d, e) with the peer's halves, Beaver-ANDs,
// updates g in place (g ^= z[:w]) and writes the next level's (d', e')
// straight into the next send buffer, (P, 2, 2w, W), the payload the adder
// yields.  p' = z[w:] never reaches device memory.  The next level's e'
// reads g' and p' at plane i - shift, computed by another thread, so each
// block owns all w planes of one strip of words of one party: it stages g'
// and p' of its strip in shared memory (2 w strip words), syncs, and then
// computes (d', e') from there.  Blocks split only on words, so the
// in-place g update races with nothing.  Bound: bytes, 96 per (party,
// plane of w, word): d, d_other, e, e_other, a, b, c read (56), g read
// and written (8), a', b' read (16), d', e' written (16); the three passes
// it replaces (ks_combine, torch.stack, ks_mask) moved 140.  Rows are read
// and written as 16-byte vectors where the words per plane, the pointers
// and the party strides allow it (neighbouring threads on neighbouring
// words), else as single words; the strip shrinks from 32 words to 8 until
// the grid has at least one block per SM (132) where the shape allows.
//
// Layouts (row-major, party dimension leading):
//   beaver_and  d, e, a, b, c, out: (P, per_party) words; sel: (P,)
//   ks_mask     g, p: (P, w, W); a, b: (P, 2w, W); send: (P, 2, 2w, W),
//               d then e per party (the payload of the level's exchange).
//   ks_combine  a, b, c: (P, 2w, W); g, g_out, p_out: (P, w, W); d, e,
//               d_other, e_other: rows of (2w, W) per party, party stride
//               given (halves of the send buffer and views into the
//               received round buffer).  p_out may be null: then only g'
//               is written, and only the first w rows of the inputs read.
//   ks_step     sent, send: (P, 2, 2w, W) (d then e per party); d_other,
//               e_other as ks_combine's; a, b, c, a_next, b_next:
//               (P, 2w, W); g: (P, w, W), updated in place.
//   ks_level    g, p: (P, planes, W), updated in place at rows first +
//               i * step, i < n; z: rows of (2n, W) per party, party
//               stride given (the level's AND output: z_g, then z_p).
// Each entry point launches on the given stream and returns
// cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void beaver_and_kernel(const uint32_t* __restrict__ d,
                                  const uint32_t* __restrict__ e,
                                  const uint32_t* __restrict__ a,
                                  const uint32_t* __restrict__ b,
                                  const uint32_t* __restrict__ c,
                                  const uint32_t* __restrict__ sel,
                                  uint32_t* __restrict__ out,
                                  int64_t per_party) {
  const int64_t base = static_cast<int64_t>(blockIdx.y) * per_party;
  const uint32_t s = sel[blockIdx.y];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       j < per_party; j += stride) {
    const int64_t o = base + j;
    const uint32_t dd = d[o];
    const uint32_t ee = e[o];
    out[o] = c[o] ^ (dd & b[o]) ^ (ee & a[o]) ^ (s & dd & ee);
  }
}

__global__ void ks_mask_kernel(const uint32_t* __restrict__ g,
                               const uint32_t* __restrict__ p,
                               const uint32_t* __restrict__ a,
                               const uint32_t* __restrict__ b,
                               uint32_t* __restrict__ send, int w,
                               int64_t words, int shift) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= words) return;
  const int i = blockIdx.y;               // output plane, < 2w
  const int64_t party = blockIdx.z;
  const int src = i < w ? i : i - w;      // source plane within the half
  const uint32_t* pp = p + party * w * words;
  const uint32_t* rhs = (i < w ? g : p) + party * w * words;
  const int64_t span = static_cast<int64_t>(2 * w) * words;  // d (or e) rows
  const int64_t t = party * span + static_cast<int64_t>(i) * words + j;
  uint32_t* d = send + party * 2 * span + static_cast<int64_t>(i) * words + j;
  d[0] = pp[src * words + j] ^ a[t];
  const uint32_t shifted = src >= shift ? rhs[(src - shift) * words + j] : 0u;
  d[span] = shifted ^ b[t];                // e, one span further
}

__global__ void ks_combine_kernel(const uint32_t* __restrict__ d,
                                  int64_t d_stride,
                                  const uint32_t* __restrict__ d_other,
                                  int64_t do_stride,
                                  const uint32_t* __restrict__ e,
                                  int64_t e_stride,
                                  const uint32_t* __restrict__ e_other,
                                  int64_t eo_stride,
                                  const uint32_t* __restrict__ a,
                                  const uint32_t* __restrict__ b,
                                  const uint32_t* __restrict__ c,
                                  const uint32_t* __restrict__ sel,
                                  const uint32_t* __restrict__ g,
                                  uint32_t* __restrict__ g_out,
                                  uint32_t* __restrict__ p_out,
                                  int w, int64_t words) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= words) return;
  const int i = blockIdx.y;               // output plane, < w
  const int64_t party = blockIdx.z;
  const uint32_t s = sel[party];
  const int64_t base = party * 2 * w * words;
  const int halves = p_out != nullptr ? 2 : 1;
  uint32_t z[2] = {0u, 0u};
  for (int h = 0; h < halves; ++h) {
    const int64_t row = static_cast<int64_t>(h * w + i) * words + j;
    const uint32_t dd = d[party * d_stride + row] ^ d_other[party * do_stride + row];
    const uint32_t ee = e[party * e_stride + row] ^ e_other[party * eo_stride + row];
    z[h] = c[base + row] ^ (dd & b[base + row]) ^ (ee & a[base + row]) ^
           (s & dd & ee);
  }
  const int64_t o = (party * w + i) * words + j;
  g_out[o] = g[o] ^ z[0];
  if (p_out != nullptr) p_out[o] = z[1];
}

// 4 words (uint4) or 1 (uint32_t) per access in ks_step_kernel.
__device__ __forceinline__ uint4 operator^(uint4 x, uint4 y) {
  return make_uint4(x.x ^ y.x, x.y ^ y.y, x.z ^ y.z, x.w ^ y.w);
}
__device__ __forceinline__ uint4 operator&(uint4 x, uint4 y) {
  return make_uint4(x.x & y.x, x.y & y.y, x.z & y.z, x.w & y.w);
}
template <typename T> __device__ __forceinline__ T splat(uint32_t v);
template <> __device__ __forceinline__ uint4 splat<uint4>(uint32_t v) {
  return make_uint4(v, v, v, v);
}
template <> __device__ __forceinline__ uint32_t splat<uint32_t>(uint32_t v) {
  return v;
}
template <typename T> __device__ __forceinline__ T ld(const uint32_t* p) {
  return *reinterpret_cast<const T*>(p);
}
template <typename T> __device__ __forceinline__ void st(uint32_t* p, T v) {
  *reinterpret_cast<T*>(p) = v;
}

// grid: (strips of `strip` words, party); shared: g' and p', (w, strip) each
template <typename T>
__global__ void ks_step_kernel(const uint32_t* __restrict__ sent,
                               const uint32_t* __restrict__ d_other,
                               int64_t do_stride,
                               const uint32_t* __restrict__ e_other,
                               int64_t eo_stride,
                               const uint32_t* __restrict__ a,
                               const uint32_t* __restrict__ b,
                               const uint32_t* __restrict__ c,
                               const uint32_t* __restrict__ sel,
                               uint32_t* __restrict__ g,
                               const uint32_t* __restrict__ a_next,
                               const uint32_t* __restrict__ b_next,
                               uint32_t* __restrict__ send, int w,
                               int64_t words, int strip, int shift) {
  constexpr int kVec = sizeof(T) / sizeof(uint32_t);
  extern __shared__ __align__(16) uint32_t staged[];
  uint32_t* g_s = staged;                  // g' of the strip, (w, strip)
  uint32_t* p_s = staged + w * strip;      // p' of the strip, (w, strip)
  const int64_t party = blockIdx.y;
  const int64_t j0 = static_cast<int64_t>(blockIdx.x) * strip;
  const int slots = strip / kVec;          // accesses per plane of the strip
  const int64_t half = static_cast<int64_t>(w) * words;   // w planes
  const int64_t t = party * 2 * half;      // this party's (2w, W) triple rows
  const uint32_t* d = sent + 2 * t;
  const uint32_t* e = d + 2 * half;
  const uint32_t* dx = d_other + party * do_stride;
  const uint32_t* ex = e_other + party * eo_stride;
  uint32_t* gp = g + party * half;
  const T s = splat<T>(sel[party]);
  // combine of level l: rows i (generate half) and w + i (propagate half)
  for (int k = threadIdx.x; k < w * slots; k += blockDim.x) {
    const int i = k / slots;
    const int col = (k - i * slots) * kVec;
    const int64_t lo = i * words + j0 + col;
    if (j0 + col >= words) continue;       // whole access in or out
    const int64_t hi = lo + half;
    const T dl = ld<T>(d + lo) ^ ld<T>(dx + lo);
    const T el = ld<T>(e + lo) ^ ld<T>(ex + lo);
    const T dh = ld<T>(d + hi) ^ ld<T>(dx + hi);
    const T eh = ld<T>(e + hi) ^ ld<T>(ex + hi);
    const T zg = ld<T>(c + t + lo) ^ (dl & ld<T>(b + t + lo)) ^
                 (el & ld<T>(a + t + lo)) ^ (s & dl & el);
    const T zp = ld<T>(c + t + hi) ^ (dh & ld<T>(b + t + hi)) ^
                 (eh & ld<T>(a + t + hi)) ^ (s & dh & eh);
    const T gn = ld<T>(gp + lo) ^ zg;
    st<T>(gp + lo, gn);
    st<T>(g_s + i * strip + col, gn);
    st<T>(p_s + i * strip + col, zp);
  }
  __syncthreads();
  // mask of level l+1: d' = [p', p'] ^ a', e' = [g' >> shift, p' >> shift] ^ b'
  uint32_t* dn = send + 2 * t;
  uint32_t* en = dn + 2 * half;
  for (int k = threadIdx.x; k < 2 * w * slots; k += blockDim.x) {
    const int i = k / slots;               // plane of the 2w
    const int col = (k - i * slots) * kVec;
    if (j0 + col >= words) continue;
    const int src = i < w ? i : i - w;
    const int64_t o = i * words + j0 + col;
    const T pv = ld<T>(p_s + src * strip + col);
    const T sh = src >= shift
                     ? ld<T>((i < w ? g_s : p_s) + (src - shift) * strip + col)
                     : splat<T>(0u);
    st<T>(dn + o, pv ^ ld<T>(a_next + t + o));
    st<T>(en + o, sh ^ ld<T>(b_next + t + o));
  }
}

__global__ void ks_level_kernel(uint32_t* __restrict__ g,
                                uint32_t* __restrict__ p,
                                const uint32_t* __restrict__ z,
                                int64_t z_stride, int64_t planes, int64_t first,
                                int64_t step, int64_t n, int64_t words) {
  // grid: (word blocks, level row i, party)
  const int64_t i = blockIdx.y;
  const int64_t party = blockIdx.z;
  const int64_t row = (party * planes + first + i * step) * words;
  const uint32_t* z_g = z + party * z_stride + i * words;
  const uint32_t* z_p = z_g + n * words;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       j < words; j += stride) {
    g[row + j] ^= z_g[j];
    p[row + j] = z_p[j];
  }
}

constexpr int64_t kMinBlocks = 132;     // one per SM of the H100

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

unsigned int blocks_for(int64_t n) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned int>(blocks < 65535 ? blocks : 65535);
}

}  // namespace

extern "C" int hb_beaver_and(const void* d, const void* e, const void* a,
                             const void* b, const void* c, const void* sel,
                             void* out, int64_t n_parties, int64_t per_party,
                             void* stream) {
  const dim3 grid(blocks_for(per_party), static_cast<unsigned int>(n_parties));
  beaver_and_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(d), static_cast<const uint32_t*>(e),
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<const uint32_t*>(c), static_cast<const uint32_t*>(sel),
      static_cast<uint32_t*>(out), per_party);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hb_ks_mask(const void* g, const void* p, const void* a,
                          const void* b, void* send, int64_t n_parties,
                          int64_t w, int64_t words, int64_t shift,
                          void* stream) {
  const dim3 grid(static_cast<unsigned int>((words + kThreads - 1) / kThreads),
                  static_cast<unsigned int>(2 * w),
                  static_cast<unsigned int>(n_parties));
  ks_mask_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(g), static_cast<const uint32_t*>(p),
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<uint32_t*>(send), static_cast<int>(w), words,
      static_cast<int>(shift));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hb_ks_combine(const void* d, int64_t d_stride,
                             const void* d_other, int64_t do_stride,
                             const void* e, int64_t e_stride,
                             const void* e_other, int64_t eo_stride,
                             const void* a, const void* b, const void* c,
                             const void* sel, const void* g, void* g_out,
                             void* p_out, int64_t n_parties, int64_t w,
                             int64_t words, void* stream) {
  const dim3 grid(static_cast<unsigned int>((words + kThreads - 1) / kThreads),
                  static_cast<unsigned int>(w),
                  static_cast<unsigned int>(n_parties));
  ks_combine_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(d), d_stride,
      static_cast<const uint32_t*>(d_other), do_stride,
      static_cast<const uint32_t*>(e), e_stride,
      static_cast<const uint32_t*>(e_other), eo_stride,
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<const uint32_t*>(c), static_cast<const uint32_t*>(sel),
      static_cast<const uint32_t*>(g), static_cast<uint32_t*>(g_out),
      static_cast<uint32_t*>(p_out), static_cast<int>(w), words);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hb_ks_step(const void* sent, const void* d_other,
                          int64_t do_stride, const void* e_other,
                          int64_t eo_stride, const void* a, const void* b,
                          const void* c, const void* sel, void* g,
                          const void* a_next, const void* b_next, void* send,
                          int64_t n_parties, int64_t w, int64_t words,
                          int64_t shift, void* stream) {
  int64_t strip = 32;                      // words per block and plane
  while (strip > 8 && n_parties * ((words + strip - 1) / strip) < kMinBlocks)
    strip /= 2;
  const bool vec = words % 4 == 0 && do_stride % 4 == 0 && eo_stride % 4 == 0 &&
                   aligned16(sent) && aligned16(d_other) && aligned16(e_other) &&
                   aligned16(a) && aligned16(b) && aligned16(c) && aligned16(g) &&
                   aligned16(a_next) && aligned16(b_next) && aligned16(send);
  const int64_t accesses = 2 * w * strip / (vec ? 4 : 1);   // of the mask pass
  int threads = static_cast<int>(((accesses + 31) / 32) * 32);
  threads = threads < kThreads ? threads : kThreads;
  const dim3 grid(static_cast<unsigned int>((words + strip - 1) / strip),
                  static_cast<unsigned int>(n_parties));
  const size_t smem = 2 * w * strip * sizeof(uint32_t);
  const cudaStream_t cu_stream = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto kernel) {
    kernel<<<grid, threads, smem, cu_stream>>>(
        static_cast<const uint32_t*>(sent),
        static_cast<const uint32_t*>(d_other), do_stride,
        static_cast<const uint32_t*>(e_other), eo_stride,
        static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
        static_cast<const uint32_t*>(c), static_cast<const uint32_t*>(sel),
        static_cast<uint32_t*>(g), static_cast<const uint32_t*>(a_next),
        static_cast<const uint32_t*>(b_next), static_cast<uint32_t*>(send),
        static_cast<int>(w), words, static_cast<int>(strip),
        static_cast<int>(shift));
  };
  if (vec)
    launch(ks_step_kernel<uint4>);
  else
    launch(ks_step_kernel<uint32_t>);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hb_ks_level(void* g, void* p, const void* z, int64_t z_stride,
                           int64_t n_parties, int64_t planes, int64_t first,
                           int64_t step, int64_t n, int64_t words,
                           void* stream) {
  const dim3 grid(blocks_for(words), static_cast<unsigned int>(n),
                  static_cast<unsigned int>(n_parties));
  ks_level_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(g), static_cast<uint32_t*>(p),
      static_cast<const uint32_t*>(z), z_stride, planes, first, step, n, words);
  return static_cast<int>(cudaGetLastError());
}
