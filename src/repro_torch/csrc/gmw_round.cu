// Fused GMW round-local compute on packed binary shares, for sm_90a.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/gmw_round.py:
//   hb_beaver_and  <- beaver_and_pallas  (:45)
//   hb_ks_mask     <- ks_mask_pallas     (:73)
//   hb_ks_combine  <- ks_combine_pallas  (:105)
//   hb_ks_level    <- ks_level_pallas    (:134)
//   hb_ks_step     <- ks_combine_pallas of one dense level fused with
//                     ks_mask_pallas of the next (:105, :73)
//   hb_cone_step   <- beaver_and_pallas of one cone round fused with
//                     ks_level_pallas and the next cone level's masking
//                     (:45, :134)
//
// All of them are XOR/AND chains over uint32 words: a few integer
// operations per 4-byte word, far below the card's operations-per-byte
// balance, so device-memory bandwidth bounds them.  The design reads each
// input word once and writes each output word once, with neighbouring
// threads on neighbouring words (coalesced).  The Beaver selector is one
// word per party, read from a (P,) vector instead of a full broadcast
// array, which removes one input stream.  ks_level, the cone adder's
// per-level combine, updates the adder's dense g and p planes in place at
// the level's strided rows, reading the two halves of the level's AND
// output where they lie (party stride given).  Its bound is 20 bytes per
// (party, level row, word): g, z_g and z_p read, g and p written.
// At the main path's sizes (a few MB per call) launch latency dominates the
// bandwidth bound, so each adder's passes between two exchanges are one
// launch: hb_ks_step (dense) and hb_cone_step (cone).
//
// hb_beaver_and has two forms.  The plain one takes opened (d, e), as
// beaver_and_pallas does.  The opening one takes this party's sent (d, e)
// and the peer's halves, all four with any party stride (views of the
// send buffer and of the received round buffer), and opens them itself:
// the two XOR passes over (P, w, W) before it go.  Bound: bytes, 24 per
// (party, word) plain (d, e, a, b, c read, z written), 32 opening (the
// peer's d and e read too).  The grid is sized from the SM count (a full
// wave of 256-thread blocks at most, a grid-stride loop beyond), blocks
// shrink to 64 threads until there are 132 of them where the shape allows.
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
// hb_cone_step: the MSB-cone adder's work between two exchanges, in one
// launch.  After the exchange of round r it opens (d, e) with the peer's
// halves and Beaver-ANDs with the round's triple, then updates the adder's
// g (P, w-1, W) and p (P, w, W) planes in place: after the initial AND
// g[0:w-1] = z; after cone level l (rows first + i step, i < n) g[rows]
// ^= z[:n] and p[rows] = z[n:].  Then it writes the next non-empty cone
// level's payload straight into the next send buffer (P, 2, 2n', W):
// d' = [p[rows'], p[rows']] ^ a', e' = [g[rows' - s], p[rows' - s]] ^ b'
// (s = 2^l' its shift), the reference's lhs and rhs in their row order.
// After the last round it writes the sign plane p[w-1] ^ g[w-2] instead.
// The z planes never reach device memory, and the torch.cat, XOR and
// stack passes that built each level's payload go.  rows' - s may be a
// row this launch wrote, at the same words, so a block owns all rows of
// one strip of words of one party, as in ks_step: it stages the rows it
// updates in shared memory (at most 2 (w-1) strip words), syncs, and
// builds the next payload from there.  Blocks split on words only, so no
// block races another.  The rows the next payload reads that this launch
// does not write, and a' and b', are loaded before the AND, so that two
// device-memory latencies do not run one after the other: most launches
// are small (a few rows), and there latency, not bandwidth, sets the
// time.  Bound: bytes,
// every word the round must read or write once: the sent and received
// (d, e) and the triple, g's and p's updated rows (g read and written, p
// written), the rows the next payload reads that this launch did not
// write, a' and b' read and (d', e') written, or the sign plane's two rows
// and the sign.  Vector and strip choice as ks_step's.
//
// Layouts (row-major, party dimension leading):
//   beaver_and  a, b, c, out: (P, per_party) words; d, e (and d_other,
//               e_other in the opening form): rows of per_party words per
//               party, party stride given; sel: (P,)
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
//   cone_step   sent: (P, 2, R, W), R = w-1 after the initial AND, 2n
//               after a cone level; d_other, e_other: rows of (R, W) per
//               party, party stride given; a, b, c: (P, R, W); g: (P,
//               w-1, W) and p: (P, w, W), updated in place; a_next,
//               b_next: (P, 2n', W); out: (P, 2, 2n', W), or (P, W) for
//               the sign plane when n' = 0.
// Each entry point launches on the given stream and returns
// cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// 4 words (uint4) or 1 (uint32_t) per access.
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

// grid: (blocks over the words, party); a grid-stride loop over the words
template <typename T, bool kOpen>
__global__ void beaver_and_kernel(const uint32_t* __restrict__ d,
                                  int64_t d_stride,
                                  const uint32_t* __restrict__ e,
                                  int64_t e_stride,
                                  const uint32_t* __restrict__ d_other,
                                  int64_t do_stride,
                                  const uint32_t* __restrict__ e_other,
                                  int64_t eo_stride,
                                  const uint32_t* __restrict__ a,
                                  const uint32_t* __restrict__ b,
                                  const uint32_t* __restrict__ c,
                                  const uint32_t* __restrict__ sel,
                                  uint32_t* __restrict__ out,
                                  int64_t per_party) {
  constexpr int kVec = sizeof(T) / sizeof(uint32_t);
  const int64_t party = blockIdx.y;
  const int64_t base = party * per_party;
  const uint32_t* dp = d + party * d_stride;
  const uint32_t* ep = e + party * e_stride;
  const uint32_t* dx = d_other + (kOpen ? party * do_stride : 0);
  const uint32_t* ex = e_other + (kOpen ? party * eo_stride : 0);
  const T s = splat<T>(sel[party]);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x * kVec;
  for (int64_t j = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * kVec;
       j < per_party; j += stride) {
    T dd = ld<T>(dp + j);
    T ee = ld<T>(ep + j);
    if constexpr (kOpen) {
      dd = dd ^ ld<T>(dx + j);
      ee = ee ^ ld<T>(ex + j);
    }
    const int64_t o = base + j;
    st<T>(out + o, ld<T>(c + o) ^ (dd & ld<T>(b + o)) ^ (ee & ld<T>(a + o)) ^
                       (s & dd & ee));
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

// grid: (strips of `strip` words, party); shared: this round's g and p
// rows, (n, strip) each; at least one thread per access of the next
// payload (or of the sign plane)
template <typename T, int kMaxThreads>
__global__ void __launch_bounds__(kMaxThreads)
cone_step_kernel(const uint32_t* __restrict__ sent,
                 const uint32_t* __restrict__ d_other, int64_t do_stride,
                 const uint32_t* __restrict__ e_other, int64_t eo_stride,
                 const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                 const uint32_t* __restrict__ c,
                 const uint32_t* __restrict__ sel, uint32_t* __restrict__ g,
                 uint32_t* __restrict__ p, const uint32_t* __restrict__ a_next,
                 const uint32_t* __restrict__ b_next,
                 uint32_t* __restrict__ out, int w, int64_t words, int strip,
                 int rows, int first, int step_bits, int n_next, int first_next,
                 int step_next, int shift_next) {
  // strip, slots and the level steps are powers of two: the index
  // arithmetic is shifts and masks, short chains for the small launches
  constexpr int kVec = sizeof(T) / sizeof(uint32_t);
  extern __shared__ __align__(16) uint32_t staged[];
  const int64_t party = blockIdx.y;
  const int64_t j0 = static_cast<int64_t>(blockIdx.x) * strip;
  const int slots = strip / kVec;          // accesses per row of the strip
  const int slot_bits = __ffs(slots) - 1;
  const int64_t t = party * rows * words;  // this party's triple rows
  const uint32_t* d = sent + 2 * t;
  const uint32_t* e = d + static_cast<int64_t>(rows) * words;
  const uint32_t* dx = d_other + party * do_stride;
  const uint32_t* ex = e_other + party * eo_stride;
  uint32_t* gp = g + party * (w - 1) * words;
  uint32_t* pp = p + party * w * words;
  const bool init = first < 0;             // the initial AND: g = z
  const int n = init ? rows : rows / 2;    // rows updated
  uint32_t* g_s = staged;                  // g of the updated rows, (n, strip)
  uint32_t* p_s = staged + n * strip;      // p of the updated rows (levels only)
  // where a row's value after this round lies: its index among the rows
  // this launch updates (then in shared memory), or -1 (device memory,
  // untouched by this launch)
  auto row_g = [&](int row) {
    if (init) return row < n ? row : -1;
    const int q = row - first;
    const int j = q >> step_bits;
    return q >= 0 && (q & ((1 << step_bits) - 1)) == 0 && j < n ? j : -1;
  };
  auto row_p = [&](int row) { return init ? -1 : row_g(row); };
  // this thread's access after the sync: row i2 of the next payload, or
  // the sign plane; what it reads from device memory is loaded now, so
  // that its latency overlaps the AND's
  const int items = n_next > 0 ? n_next * slots : slots;
  const int i2 = threadIdx.x >> slot_bits;
  const int64_t c2 = j0 + (threadIdx.x & (slots - 1)) * kVec;
  const bool mine = threadIdx.x < items && c2 < words;
  const int rp = n_next > 0 ? first_next + i2 * step_next : w - 1;   // p[rp]
  const int rs = n_next > 0 ? rp - shift_next : w - 2;   // g[rs] (and p[rs])
  const int jp = row_p(rp), jg = row_g(rs), js = row_p(rs);
  const int64_t half = static_cast<int64_t>(n_next) * words;
  const int64_t tn = party * 2 * half;     // this party's next triple rows
  T vp = splat<T>(0u), vg = vp, vs = vp, a0 = vp, a1 = vp, b0 = vp, b1 = vp;
  if (mine) {
    if (jp < 0) vp = ld<T>(pp + rp * words + c2);
    if (jg < 0) vg = ld<T>(gp + rs * words + c2);
    if (n_next > 0) {
      if (js < 0) vs = ld<T>(pp + rs * words + c2);
      const int64_t o = tn + i2 * words + c2;
      a0 = ld<T>(a_next + o);
      a1 = ld<T>(a_next + o + half);
      b0 = ld<T>(b_next + o);
      b1 = ld<T>(b_next + o + half);
    }
  }
  const T s = splat<T>(sel[party]);
  for (int k = threadIdx.x; k < n * slots; k += blockDim.x) {
    const int i = k >> slot_bits;
    const int col = (k & (slots - 1)) * kVec;
    if (j0 + col >= words) continue;       // whole access in or out
    const int64_t lo = i * words + j0 + col;
    const T dl = ld<T>(d + lo) ^ ld<T>(dx + lo);
    const T el = ld<T>(e + lo) ^ ld<T>(ex + lo);
    const T zg = ld<T>(c + t + lo) ^ (dl & ld<T>(b + t + lo)) ^
                 (el & ld<T>(a + t + lo)) ^ (s & dl & el);
    if (init) {
      st<T>(gp + lo, zg);
      st<T>(g_s + i * strip + col, zg);
      continue;
    }
    const int64_t hi = lo + static_cast<int64_t>(n) * words;
    const T dh = ld<T>(d + hi) ^ ld<T>(dx + hi);
    const T eh = ld<T>(e + hi) ^ ld<T>(ex + hi);
    const T zp = ld<T>(c + t + hi) ^ (dh & ld<T>(b + t + hi)) ^
                 (eh & ld<T>(a + t + hi)) ^ (s & dh & eh);
    const int64_t row = static_cast<int64_t>(first + (i << step_bits)) * words + j0 + col;
    const T gn = ld<T>(gp + row) ^ zg;
    st<T>(gp + row, gn);
    st<T>(pp + row, zp);
    st<T>(g_s + i * strip + col, gn);
    st<T>(p_s + i * strip + col, zp);
  }
  __syncthreads();
  if (!mine) return;
  const int cs = static_cast<int>(c2 - j0);   // column within the strip
  if (jp >= 0) vp = ld<T>(p_s + jp * strip + cs);
  if (jg >= 0) vg = ld<T>(g_s + jg * strip + cs);
  if (n_next == 0) {                       // the last round: the sign plane
    st<T>(out + party * words + c2, vp ^ vg);
    return;
  }
  if (js >= 0) vs = ld<T>(p_s + js * strip + cs);
  // d' = [p[r], p[r]] ^ a', e' = [g[r-s], p[r-s]] ^ b'
  uint32_t* dn = out + 2 * tn + i2 * words + c2;
  st<T>(dn, vp ^ a0);
  st<T>(dn + half, vp ^ a1);
  st<T>(dn + 2 * half, vg ^ b0);
  st<T>(dn + 3 * half, vs ^ b1);
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

extern "C" int hb_beaver_and(const void* d, int64_t d_stride, const void* e,
                             int64_t e_stride, const void* d_other,
                             int64_t do_stride, const void* e_other,
                             int64_t eo_stride, const void* a, const void* b,
                             const void* c, const void* sel, void* out,
                             int64_t n_parties, int64_t per_party,
                             void* stream) {
  const bool open = d_other != nullptr;
  const bool vec = per_party % 4 == 0 && d_stride % 4 == 0 && e_stride % 4 == 0 &&
                   aligned16(d) && aligned16(e) && aligned16(a) &&
                   aligned16(b) && aligned16(c) && aligned16(out) &&
                   (!open || (do_stride % 4 == 0 && eo_stride % 4 == 0 &&
                              aligned16(d_other) && aligned16(e_other)));
  const int64_t accesses = vec ? per_party / 4 : per_party;   // per party
  int64_t threads = kThreads;
  while (threads > 64 && n_parties * ((accesses + threads - 1) / threads) < kMinBlocks)
    threads /= 2;
  // at most one full wave (2048 resident threads per SM), a loop beyond
  const int64_t wave = kMinBlocks * (2048 / threads) / n_parties;
  int64_t blocks = (accesses + threads - 1) / threads;
  blocks = blocks < wave ? blocks : (wave > 0 ? wave : 1);
  const dim3 grid(static_cast<unsigned int>(blocks),
                  static_cast<unsigned int>(n_parties));
  const cudaStream_t cu_stream = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto kernel) {
    kernel<<<grid, static_cast<unsigned int>(threads), 0, cu_stream>>>(
        static_cast<const uint32_t*>(d), d_stride,
        static_cast<const uint32_t*>(e), e_stride,
        static_cast<const uint32_t*>(d_other), do_stride,
        static_cast<const uint32_t*>(e_other), eo_stride,
        static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
        static_cast<const uint32_t*>(c), static_cast<const uint32_t*>(sel),
        static_cast<uint32_t*>(out), per_party);
  };
  if (vec)
    open ? launch(beaver_and_kernel<uint4, true>) : launch(beaver_and_kernel<uint4, false>);
  else
    open ? launch(beaver_and_kernel<uint32_t, true>)
         : launch(beaver_and_kernel<uint32_t, false>);
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

extern "C" int hb_cone_step(const void* sent, const void* d_other,
                            int64_t do_stride, const void* e_other,
                            int64_t eo_stride, const void* a, const void* b,
                            const void* c, const void* sel, void* g, void* p,
                            const void* a_next, const void* b_next, void* out,
                            int64_t n_parties, int64_t w, int64_t words,
                            int64_t rows, int64_t first, int64_t step,
                            int64_t n_next, int64_t first_next,
                            int64_t step_next, int64_t shift_next,
                            void* stream) {
  int64_t strip = 32;                      // words per block and row
  while (strip > 8 && n_parties * ((words + strip - 1) / strip) < kMinBlocks)
    strip /= 2;
  const bool vec = words % 4 == 0 && do_stride % 4 == 0 && eo_stride % 4 == 0 &&
                   aligned16(sent) && aligned16(d_other) && aligned16(e_other) &&
                   aligned16(a) && aligned16(b) && aligned16(c) && aligned16(g) &&
                   aligned16(p) && aligned16(out) &&
                   (n_next == 0 || (aligned16(a_next) && aligned16(b_next)));
  // a thread for every access of the next payload (at most 32 rows), and
  // for every access of the round's AND where that takes no more
  const int64_t updated = first < 0 ? rows : rows / 2;
  const int64_t slots = strip / (vec ? 4 : 1);
  const int64_t next_items = (n_next > 0 ? n_next : 1) * slots;
  const int64_t most = vec ? 512 : 1024;
  int64_t threads = updated * slots > next_items ? updated * slots : next_items;
  threads = ((threads + 31) / 32) * 32;
  threads = threads < most ? threads : most;
  int step_bits = 0;                       // the level's step, a power of two
  while (step_bits < 30 && (int64_t{1} << step_bits) < step) ++step_bits;
  if (next_items > threads || (first >= 0 && (int64_t{1} << step_bits) != step))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned int>((words + strip - 1) / strip),
                  static_cast<unsigned int>(n_parties));
  const size_t smem = 2 * updated * strip * sizeof(uint32_t);
  const cudaStream_t cu_stream = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto kernel) {
    kernel<<<grid, static_cast<unsigned int>(threads), smem, cu_stream>>>(
        static_cast<const uint32_t*>(sent),
        static_cast<const uint32_t*>(d_other), do_stride,
        static_cast<const uint32_t*>(e_other), eo_stride,
        static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
        static_cast<const uint32_t*>(c), static_cast<const uint32_t*>(sel),
        static_cast<uint32_t*>(g), static_cast<uint32_t*>(p),
        static_cast<const uint32_t*>(a_next),
        static_cast<const uint32_t*>(b_next), static_cast<uint32_t*>(out),
        static_cast<int>(w), words, static_cast<int>(strip),
        static_cast<int>(rows), static_cast<int>(first), step_bits,
        static_cast<int>(n_next), static_cast<int>(first_next),
        static_cast<int>(step_next), static_cast<int>(shift_next));
  };
  if (vec)
    launch(cone_step_kernel<uint4, 512>);
  else
    launch(cone_step_kernel<uint32_t, 1024>);
  return static_cast<int>(cudaGetLastError());
}
