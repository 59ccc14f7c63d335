// Fused GMW round-local compute on packed binary shares, for sm_90a.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/gmw_round.py:
//   hb_beaver_and  <- beaver_and_pallas  (:45)
//   hb_ks_mask     <- ks_mask_pallas     (:73)
//   hb_ks_combine  <- ks_combine_pallas  (:105)
//   hb_ks_level    <- ks_level_pallas    (:134)
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
// bandwidth bound; fusing the round's passes or capturing the round loop in
// a CUDA graph is later work.
//
// Layouts (row-major, party dimension leading):
//   beaver_and  d, e, a, b, c, out: (P, per_party) words; sel: (P,)
//   ks_mask     g, p: (P, w, W); a, b, d, e: (P, 2w, W)
//   ks_combine  d, e, a, b, c: (P, 2w, W); g, g_out, p_out: (P, w, W);
//               d_other, e_other: rows of (2w, W) per party, party stride
//               given (they are views into the received round buffer).
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
                               uint32_t* __restrict__ d,
                               uint32_t* __restrict__ e,
                               int w, int64_t words, int shift) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= words) return;
  const int i = blockIdx.y;               // output plane, < 2w
  const int64_t party = blockIdx.z;
  const int src = i < w ? i : i - w;      // source plane within the half
  const uint32_t* pp = p + party * w * words;
  const uint32_t* rhs = (i < w ? g : p) + party * w * words;
  const int64_t o = (party * 2 * w + i) * words + j;
  d[o] = pp[src * words + j] ^ a[o];
  const uint32_t shifted = src >= shift ? rhs[(src - shift) * words + j] : 0u;
  e[o] = shifted ^ b[o];
}

__global__ void ks_combine_kernel(const uint32_t* __restrict__ d,
                                  const uint32_t* __restrict__ d_other,
                                  int64_t do_stride,
                                  const uint32_t* __restrict__ e,
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
  uint32_t z[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t row = static_cast<int64_t>(h * w + i) * words + j;
    const uint32_t dd = d[base + row] ^ d_other[party * do_stride + row];
    const uint32_t ee = e[base + row] ^ e_other[party * eo_stride + row];
    z[h] = c[base + row] ^ (dd & b[base + row]) ^ (ee & a[base + row]) ^
           (s & dd & ee);
  }
  const int64_t o = (party * w + i) * words + j;
  g_out[o] = g[o] ^ z[0];
  p_out[o] = z[1];
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
                          const void* b, void* d, void* e, int64_t n_parties,
                          int64_t w, int64_t words, int64_t shift,
                          void* stream) {
  const dim3 grid(static_cast<unsigned int>((words + kThreads - 1) / kThreads),
                  static_cast<unsigned int>(2 * w),
                  static_cast<unsigned int>(n_parties));
  ks_mask_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(g), static_cast<const uint32_t*>(p),
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<uint32_t*>(d), static_cast<uint32_t*>(e),
      static_cast<int>(w), words, static_cast<int>(shift));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hb_ks_combine(const void* d, const void* d_other,
                             int64_t do_stride, const void* e,
                             const void* e_other, int64_t eo_stride,
                             const void* a, const void* b, const void* c,
                             const void* sel, const void* g, void* g_out,
                             void* p_out, int64_t n_parties, int64_t w,
                             int64_t words, void* stream) {
  const dim3 grid(static_cast<unsigned int>((words + kThreads - 1) / kThreads),
                  static_cast<unsigned int>(w),
                  static_cast<unsigned int>(n_parties));
  ks_combine_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(d), static_cast<const uint32_t*>(d_other),
      do_stride, static_cast<const uint32_t*>(e),
      static_cast<const uint32_t*>(e_other), eo_stride,
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<const uint32_t*>(c), static_cast<const uint32_t*>(sel),
      static_cast<const uint32_t*>(g), static_cast<uint32_t*>(g_out),
      static_cast<uint32_t*>(p_out), static_cast<int>(w), words);
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
