// Bit packing between per-element values and bit-sliced wire words, for
// sm_90a.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/bitpack.py:
//   hb_pack, hb_pack_ring  <- pack_pallas    (:44)
//   hb_unpack              <- unpack_pallas  (:60)
//
// Layout (as the reference): bit t of word (i, j) of a row is bit i of
// value 32j + t of that row; a row of w planes is (w, W) words with
// W = ceil(n / 32), tail bits zero.
//
// Both directions do a few integer operations per bit and move each byte
// once, so device-memory bandwidth bounds them:
//   pack:       4 bytes read per value, 4 written per (plane, word);
//   pack_ring:  8 bytes read per ring value, 4 written per (plane, word),
//               and 4 more read per (plane, word) with the A2B mask;
//   unpack:     4 bytes read per (plane, word), 4 written per value.
//
// pack / pack_ring: the TPU kernel shifts and sums a (BW, 32) tile in
// VMEM.  On the card one kernel template serves every w (1-64) and both
// input types.  Its main-path calls move 0.5-12.6 MB each, 0.3-3.8 us at
// the bound, so latency costs as much as bandwidth: the launch, the first
// copies' round trip, the transpositions' shuffle chains and the stores'
// drain, each about a microsecond at the stem, in turn within one block
// (PERF.md).  The design:
// - A block of 8 warps owns a tile of kWords consecutive words of one row
//   (32 kWords values); each warp transposes kWarpWords of them.  The
//   grid is one wave of the blocks the SMs hold at once (occupancy query,
//   at most 64 registers a thread so that 4 blocks fit), so every launch
//   spreads over all SMs, and a block walks its tiles with a grid stride.
// - Loads are cp.async copies into shared memory, a tile ahead: the block
//   issues its next tile's copies before it transposes the current one,
//   so they stay in flight without registers.  A thread copies 16 bytes
//   (two int64 or four int32 values) where the pointer and the row stride
//   allow it, else one value; values past n are zero-filled.
// - A 32x32 bit-matrix transposition across the warp (five shuffle
//   steps of three instructions) turns values into words.  Lane t holds
//   the w' bits of value 32j + t (w' the next power of two >= w, at most
//   32) for 32 / w' consecutive words j at once, so one transposition
//   yields w' planes of 32 / w' words: at w = 8 four words per
//   transposition, at w = 1 all 32 (the result of 32 ballots, in 5
//   shuffle steps).  Planes 32-63 of a ring value take a second pass.  A
//   warp transposes at least 4 words, and at w' < 8 the 32 / w' words one
//   transposition covers (so at w = 1 a tile is 256 words).
// - The words go through shared memory so that the block stores whole
//   lines of each plane (kWords words, 128 bytes at w' >= 8), 16 bytes a
//   thread where the row of words allows it, else one word; tiles of 8 or
//   16 words a plane measured slower (PERF.md).
// - With the A2B mask (pack_ring's masked form), the mask's tile is
//   copied beside the values' and XORed in before the store, so the A2B
//   round's masked planes take no second pass over the words.
//
// unpack: its main-path call is the sign plane (w = 1), 2 rows of up to
// 262 144 values: 4 bytes written per value against 1/8 of a byte read, a
// call of a few microseconds that launch, the first loads' latency and
// the stores' drain bound more than bandwidth.  So each thread writes
// whole 16-byte vectors (4 consecutive values) and one warp store
// instruction writes 512 contiguous bytes; the 8 lanes of a word share
// its load (a broadcast), so each plane's word is read once per 32
// values; each thread does kUnpackVectors vectors of a tile, with their
// loads issued together, one plane at a time (so w > 1 waits for w loads
// in turn; loading 8 planes before using any took 168 registers and made
// the w = 1 shapes up to 2x slower, see PERF.md).  A block owns a tile of
// kUnpackTile consecutive values of one row; the grid is sized to the
// tiles (rows x tiles per row), capped at a few waves of the device's
// SMs, with a grid-stride loop beyond.  A row whose output does not start
// 16-byte aligned (n % 4 != 0) and a row's last n % 4 values take scalar
// stores.
//
// Each entry point launches on the given stream and returns
// cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kPackThreads = 256;
constexpr int kPackWarps = kPackThreads / 32;
constexpr int kPackMinWarpWords = 4;   // 16-byte stores of 4 words
constexpr int kPackMinBlocks = 4;      // __launch_bounds__: 64 registers at most

// The tile of a kernel whose transposition holds w' = 2^kLogWp bits of each
// value: each warp transposes kWarpWords words of a row (at least 4, and
// at least the 32 / w' words one transposition covers), the block kWords.
template <int kLogWp>
struct PackTile {
  static constexpr int kWp = 1 << kLogWp;
  static constexpr int kPerT = 32 / kWp;             // words per transposition
  static constexpr int kWarpWords = kPerT > kPackMinWarpWords ? kPerT : kPackMinWarpWords;
  static constexpr int kT = kWarpWords / kPerT;      // transpositions per pass
  static constexpr int kWords = kPackWarps * kWarpWords;
  static constexpr int kStageRow = kWords + 1;       // +1: no bank clashes

  // Bytes of shared memory per block: two tiles of values, two of mask
  // words, the stage of w planes' words.
  template <typename T>
  static constexpr size_t bytes(int w, bool masked) {
    return 2 * kWords * 32 * sizeof(T) + (masked ? 2 * 4 * w * kWords : 0)
        + 4 * w * kStageRow;
  }
};

// Lane t holds row t of a 32x32 bit matrix (bit i = M[t][i]); afterwards
// lane i holds row i of its transpose (bit t = M[t][i]).  Step s swaps the
// off-diagonal s x s blocks between lanes t and t ^ s: each lane sends its
// row rotated so that the bits the partner takes sit in their new place
// (left by s from the lower lane, right by s from the upper), and keeps
// the rest of its own with one select of bits: three instructions a step.
__device__ __forceinline__ uint32_t transpose32(uint32_t x, int lane) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const uint32_t keep = 0xffffffffu / ((1u << s) + 1u);  // 0x0000ffff, ...
    const bool high = lane & s;
    const uint32_t y = __shfl_xor_sync(0xffffffffu,
                                       __funnelshift_l(x, x, high ? s : 32 - s), s);
    const uint32_t mine = high ? ~keep : keep;
    x = (x & mine) | (y & ~mine);
  }
  return x;
}

// Copy kBytes from global to shared memory asynchronously, or (valid
// false) write kBytes of zeros and read nothing.
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  const unsigned int to = static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  const int n = valid ? kBytes : 0;
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(to), "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(to), "l"(src), "n"(kBytes), "r"(n));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most one group of this thread's copies is in flight.
__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// A block's copies of a tile: the values of words j0 .. j0 + kWords - 1 of
// a row into ``vals`` (32 kWords values), and with a mask its (w, kWords)
// words into ``mask_tile``.
template <typename T, int kWords>
__device__ __forceinline__ void issue_tile(const T* row_vals, int64_t n,
                                           const uint32_t* row_mask, int64_t words,
                                           int w, int64_t j0, T* vals,
                                           uint32_t* mask_tile, bool vec_vals,
                                           bool vec_words) {
  const int64_t e0 = j0 * 32;
  if (vec_vals) {
    constexpr int kPer = 16 / sizeof(T);
#pragma unroll
    for (int i = 0; i < kWords * 32 / kPer / kPackThreads; ++i) {
      const int c = threadIdx.x + kPackThreads * i;
      const int64_t e = e0 + c * kPer;       // n % kPer == 0: all in or all out
      cp_async<16>(vals + c * kPer, e < n ? row_vals + e : row_vals, e < n);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kWords * 32 / kPackThreads; ++i) {
      const int c = threadIdx.x + kPackThreads * i;
      const int64_t e = e0 + c;
      cp_async<sizeof(T)>(vals + c, e < n ? row_vals + e : row_vals, e < n);
    }
  }
  if (row_mask == nullptr) return;
  // thread c copies word(s) g of planes p0, p0 + kStep, ...
  if (vec_words) {
    constexpr int kVecs = kWords / 4;        // per plane
    constexpr int kStep = kPackThreads / kVecs;
    const int g = (threadIdx.x % kVecs) * 4;
    const bool valid = j0 + g < words;       // words % 4 == 0: all in or all out
    const uint32_t* src = row_mask + j0 + (valid ? g : 0);
    for (int p = threadIdx.x / kVecs; p < w; p += kStep) {
      cp_async<16>(mask_tile + p * kWords + g, src + (valid ? p * words : 0), valid);
    }
  } else {
    constexpr int kStep = kPackThreads / kWords;
    const int g = threadIdx.x % kWords;
    const bool valid = j0 + g < words;
    const uint32_t* src = row_mask + j0 + (valid ? g : 0);
    for (int p = threadIdx.x / kWords; p < w; p += kStep) {
      cp_async<4>(mask_tile + p * kWords + g, src + (valid ? p * words : 0), valid);
    }
  }
}

// (rows, n) values -> (rows, w, W) words of bits shift .. shift + w - 1,
// each XORed with ``mask`` (same layout as out) where it is given.
// kLogWp: log2 of w' (w' = 32 for w > 16; two passes of 32 for w > 32).
template <typename T, int kLogWp>
__global__ void __launch_bounds__(kPackThreads, kPackMinBlocks)
pack_kernel(const T* __restrict__ v, int64_t rows, int64_t n, int64_t words,
            int shift, int w, const uint32_t* __restrict__ mask,
            uint32_t* __restrict__ out, bool vec_vals, bool vec_words) {
  using Tile = PackTile<kLogWp>;
  constexpr int kWp = Tile::kWp, kPerT = Tile::kPerT, kT = Tile::kT;
  constexpr int kWarpWords = Tile::kWarpWords, kWords = Tile::kWords;
  constexpr int kStageRow = Tile::kStageRow;
  static_assert(kPackThreads % kWords == 0, "a thread keeps its words of a plane");
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int g0 = (threadIdx.x / 32) * kWarpWords;         // this warp's words
  const unsigned int per_row = static_cast<unsigned int>((words + kWords - 1) / kWords);
  const unsigned int tiles = static_cast<unsigned int>(rows) * per_row;
  unsigned int tile = blockIdx.x;
  if (tile >= tiles) return;

  T* vals = reinterpret_cast<T*>(smem);
  uint32_t* mask_tiles = reinterpret_cast<uint32_t*>(vals + 2 * kWords * 32);
  uint32_t* stage = mask_tiles + (mask != nullptr ? 2 * w * kWords : 0);
  auto issue = [&](unsigned int t, int buf) {
    const unsigned int row = t / per_row;
    issue_tile<T, kWords>(
        v + row * n, n,
        mask != nullptr ? mask + static_cast<int64_t>(row) * w * words : nullptr,
        words, w, static_cast<int64_t>(t - row * per_row) * kWords,
        vals + buf * kWords * 32, mask_tiles + buf * w * kWords, vec_vals, vec_words);
  };
  issue(tile, 0);
  cp_async_commit();
  for (int buf = 0; tile < tiles; tile += gridDim.x, buf ^= 1) {
    if (tile + gridDim.x < tiles) issue(tile + gridDim.x, buf ^ 1);
    cp_async_commit();                     // (empty after the last tile)
    cp_async_wait_all_but_one();           // this tile's copies have landed
    __syncthreads();
    const unsigned int row = tile / per_row;
    const int64_t j0 = static_cast<int64_t>(tile - row * per_row) * kWords;
    // this lane's value of each of the warp's words, shifted, in registers:
    // the transpositions below then run side by side
    uint64_t x[kWarpWords];
#pragma unroll
    for (int g = 0; g < kWarpWords; ++g) {
      x[g] = static_cast<uint64_t>(vals[buf * kWords * 32 + (g0 + g) * 32 + lane])
          >> shift;
    }
    for (int base = 0; base < (kWp < 32 ? 1 : w); base += 32) {   // planes base ..
      const int wc = w - base < 32 ? w - base : 32;
      uint32_t bits[kT] = {};              // w' bits of kPerT words' values
#pragma unroll
      for (int g = 0; g < kWarpWords; ++g) {
        uint32_t b = static_cast<uint32_t>(x[g] >> base);
        if (kWp < 32) b &= (1u << kWp) - 1u;
        bits[g / kPerT] |= b << (g % kPerT * kWp);
      }
#pragma unroll
      for (int q = 0; q < kT; ++q) bits[q] = transpose32(bits[q], lane);
      const int p = lane & (kWp - 1);      // lane p + i w' holds plane p of
#pragma unroll                             // word q kPerT + i
      for (int q = 0; q < kT; ++q) {
        const int g = q * kPerT + (lane >> kLogWp);
        if (p < wc) stage[(base + p) * kStageRow + g0 + g] = bits[q];
      }
    }
    __syncthreads();
    // the block stores the tile, whole lines of each plane: thread c
    // stores word(s) g of planes p0, p0 + kStep, ...
    uint32_t* dst = out + static_cast<int64_t>(row) * w * words + j0;
    const uint32_t* mk = mask_tiles + buf * w * kWords;
    if (vec_words) {
      constexpr int kVecs = kWords / 4;
      constexpr int kStep = kPackThreads / kVecs;
      const int g = (threadIdx.x % kVecs) * 4;
      if (j0 + g < words) {
        for (int p = threadIdx.x / kVecs; p < w; p += kStep) {
          const uint32_t* s = stage + p * kStageRow + g;
          uint4 o = make_uint4(s[0], s[1], s[2], s[3]);
          if (mask != nullptr) {
            const uint4 r = *reinterpret_cast<const uint4*>(mk + p * kWords + g);
            o.x ^= r.x; o.y ^= r.y; o.z ^= r.z; o.w ^= r.w;
          }
          *reinterpret_cast<uint4*>(dst + p * words + g) = o;
        }
      }
    } else {
      constexpr int kStep = kPackThreads / kWords;
      const int g = threadIdx.x % kWords;
      if (j0 + g < words) {
        for (int p = threadIdx.x / kWords; p < w; p += kStep) {
          uint32_t o = stage[p * kStageRow + g];
          if (mask != nullptr) o ^= mk[p * kWords + g];
          dst[p * words + g] = o;
        }
      }
    }
    __syncthreads();                       // stage and this tile's buffers free
  }
}

int device_sms(int* dev, int* sms, int* threads_per_sm) {
  cudaError_t err = cudaGetDevice(dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, *dev);
  if (err == cudaSuccess && threads_per_sm != nullptr)
    err = cudaDeviceGetAttribute(threads_per_sm, cudaDevAttrMaxThreadsPerMultiProcessor, *dev);
  return static_cast<int>(err);
}

template <typename T, int kLogWp>
int launch_pack_wp(const T* v, int64_t rows, int64_t n, int64_t words, int shift,
                   int w, const uint32_t* mask, uint32_t* out, cudaStream_t stream) {
  using Tile = PackTile<kLogWp>;
  const auto kernel = pack_kernel<T, kLogWp>;
  const size_t bytes = Tile::template bytes<T>(w, mask != nullptr);
  // blocks one SM holds at once, per device, width and form (the
  // occupancy query costs the host more than the launch)
  static int resident[16][65][2];
  int dev = 0, sms = 0;
  if (const int rc = device_sms(&dev, &sms, nullptr)) return rc;
  int& per_sm = resident[dev & 15][w][mask != nullptr];
  if (per_sm == 0) {
    cudaError_t err = cudaSuccess;
    if (bytes > 48 * 1024) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(bytes));
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kPackThreads,
                                                          bytes);
    }
    if (err != cudaSuccess || per_sm == 0) {
      per_sm = 0;
      return static_cast<int>(err != cudaSuccess ? err : cudaErrorInvalidConfiguration);
    }
  }
  const int64_t tiles = rows * ((words + Tile::kWords - 1) / Tile::kWords);
  const int64_t cap = static_cast<int64_t>(per_sm) * sms;   // one wave
  if (tiles + cap >= (int64_t{1} << 32))
    return static_cast<int>(cudaErrorInvalidValue);   // tile indices are 32-bit
  const int64_t blocks = tiles < cap ? tiles : cap;
  const auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const bool vec_vals = aligned(v) && (n * static_cast<int64_t>(sizeof(T))) % 16 == 0;
  const bool vec_words = words % 4 == 0 && aligned(out)
      && (mask == nullptr || aligned(mask));
  kernel<<<static_cast<unsigned int>(blocks > 0 ? blocks : 1), kPackThreads, bytes,
           stream>>>(v, rows, n, words, shift, w, mask, out, vec_vals, vec_words);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_pack(const void* v, int64_t rows, int64_t n, void* out, int shift,
                int w, const void* mask, void* stream) {
  const int64_t words = (n + 31) / 32;
  const T* x = static_cast<const T*>(v);
  const uint32_t* m = static_cast<const uint32_t*>(mask);
  uint32_t* o = static_cast<uint32_t*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w <= 1) return launch_pack_wp<T, 0>(x, rows, n, words, shift, w, m, o, s);
  if (w <= 2) return launch_pack_wp<T, 1>(x, rows, n, words, shift, w, m, o, s);
  if (w <= 4) return launch_pack_wp<T, 2>(x, rows, n, words, shift, w, m, o, s);
  if (w <= 8) return launch_pack_wp<T, 3>(x, rows, n, words, shift, w, m, o, s);
  if (w <= 16) return launch_pack_wp<T, 4>(x, rows, n, words, shift, w, m, o, s);
  return launch_pack_wp<T, 5>(x, rows, n, words, shift, w, m, o, s);
}

constexpr int kUnpackThreads = 128;
constexpr int kUnpackVectors = 4;      // 16-byte stores per thread and tile
constexpr int kUnpackTile = kUnpackThreads * kUnpackVectors * 4;   // values
constexpr int kUnpackWaves = 4;

__global__ void __launch_bounds__(kUnpackThreads)
unpack_kernel(const uint32_t* __restrict__ words, int64_t rows, int w,
              int64_t n_words, int64_t n, uint32_t* __restrict__ out) {
  const int64_t per_row = (n + kUnpackTile - 1) / kUnpackTile;
  // vector v of this thread: values v * 128 + lane * 4 .. + 3 of its warp's
  // 512 in the tile
  const int offset = (threadIdx.x / 32) * (128 * kUnpackVectors) + (threadIdx.x & 31) * 4;
  for (int64_t tile = blockIdx.x; tile < rows * per_row; tile += gridDim.x) {
    const int64_t row = tile / per_row;
    const int64_t e0 = (tile - row * per_row) * kUnpackTile + offset;
    const uint32_t* src = words + row * w * n_words;
    uint32_t* dst = out + row * n;
    uint32_t vals[kUnpackVectors][4] = {};
    for (int i = 0; i < w; ++i) {
      const uint32_t* plane = src + i * n_words;
#pragma unroll
      for (int v = 0; v < kUnpackVectors; ++v) {
        const int64_t e = e0 + v * 128;
        if (e < n) {
          const uint32_t nibble = (plane[e >> 5] >> (e & 31)) & 0xfu;
#pragma unroll
          for (int k = 0; k < 4; ++k) vals[v][k] |= ((nibble >> k) & 1u) << i;
        }
      }
    }
    const bool aligned = (reinterpret_cast<uintptr_t>(dst) & 15) == 0;
#pragma unroll
    for (int v = 0; v < kUnpackVectors; ++v) {
      const int64_t e = e0 + v * 128;
      if (aligned && e + 4 <= n) {
        *reinterpret_cast<uint4*>(dst + e) =
            make_uint4(vals[v][0], vals[v][1], vals[v][2], vals[v][3]);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (e + k < n) dst[e + k] = vals[v][k];
        }
      }
    }
  }
}

}  // namespace

// v: (rows, n) int32 values -> out: (rows, w, W) words of bits 0..w-1.
extern "C" int hb_pack(const void* v, int64_t rows, int64_t n, void* out,
                       int64_t w, void* stream) {
  return launch_pack<uint32_t>(v, rows, n, out, 0, static_cast<int>(w), nullptr,
                               stream);
}

// x: (rows, n) int64 ring values -> out: (rows, k - m, W) words of bits
// m..k-1, XORed with mask (rows, k - m, W) int32 words where mask is not
// null.
extern "C" int hb_pack_ring(const void* x, int64_t rows, int64_t n, void* out,
                            int64_t k, int64_t m, const void* mask, void* stream) {
  return launch_pack<uint64_t>(x, rows, n, out, static_cast<int>(m),
                               static_cast<int>(k - m), mask, stream);
}

// words: (rows, w, W) -> out: (rows, n) values, n <= 32 W, 1 <= w <= 32.
extern "C" int hb_unpack(const void* words, int64_t rows, int64_t w,
                         int64_t n_words, int64_t n, void* out, void* stream) {
  int dev = 0, sms = 0, occ = 0;
  if (const int rc = device_sms(&dev, &sms, &occ)) return rc;
  const int64_t tiles = rows * ((n + kUnpackTile - 1) / kUnpackTile);
  const int64_t cap = static_cast<int64_t>(kUnpackWaves) * sms * (occ / kUnpackThreads);
  const int64_t blocks = tiles < cap ? tiles : cap;
  unpack_kernel<<<static_cast<unsigned int>(blocks > 0 ? blocks : 1), kUnpackThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), rows, static_cast<int>(w), n_words,
      n, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
