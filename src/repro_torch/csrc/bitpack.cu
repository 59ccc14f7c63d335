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
//   pack_ring:  8 bytes read per ring value, 4 written per (plane, word);
//   unpack:     4 bytes read per (plane, word), 4 written per value.
//
// pack / pack_ring: the TPU kernel shifts and sums a (BW, 32) tile in
// VMEM.  On the card a warp packs 32 values at a time, by one of two
// designs, chosen by w:
// - w > 4: a 32x32 bit-matrix transposition across the warp.  Each warp
//   owns 8 consecutive words of one row (256 values): lane t loads value
//   32j + t of each word j (coalesced), shifted right by m, and five
//   shuffle butterflies leave lane i holding plane i's word j, 32 planes
//   at once (about 20 instructions per 32 values and 32 planes).  The
//   words go through shared memory so that each store writes 8
//   consecutive words of 4 planes (4 whole 32-byte sectors).  Planes
//   32-63 of a ring value take a second transposition of the high word.
// - w <= 4: one ballot per plane and word (about 4 instructions per 32
//   values and plane, cheaper for few planes).  Each warp owns 32
//   consecutive words of one row and lane g keeps word g, so each plane's
//   32 words are stored by neighbouring lanes at neighbouring addresses.
// (The ballot design alone, at w = 64, did 2048 ballots per warp with one
// warp per scheduler and reached 8% of the bound; see PERF.md.)
// pack reads int32 values (w <= 32); pack_ring reads int64 ring shares and
// takes bits m..k-1 straight from them (w = k - m <= 64), with no
// extracted copy.
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

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned int kMaxGridY = 65535;

constexpr int kGroups = 8;           // words of a row per warp, transposing
constexpr int kBallotMaxW = 4;       // widest pack done by ballots

// Lane t holds row t of a 32x32 bit matrix (bit i = M[t][i]); afterwards
// lane i holds row i of its transpose (bit t = M[t][i]).  Step s swaps the
// off-diagonal s x s blocks between lanes t and t ^ s.
__device__ __forceinline__ uint32_t transpose32(uint32_t x, int lane) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const uint32_t keep = 0xffffffffu / ((1u << s) + 1u);  // 0x0000ffff, ...
    const uint32_t y = __shfl_xor_sync(0xffffffffu, x, s);
    x = (lane & s) ? (x & ~keep) | ((y >> s) & keep)
                   : (x & keep) | ((y & keep) << s);
  }
  return x;
}

template <typename T>
__global__ void pack_transpose_kernel(const T* __restrict__ v, int64_t rows,
                                      int64_t n, int64_t words, int shift,
                                      int w, uint32_t* __restrict__ out) {
  __shared__ uint32_t stage[kWarps][32][kGroups + 1];   // +1: no bank clash
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x / 32;
  const int64_t j0 = (static_cast<int64_t>(blockIdx.x) * kWarps + warp) * kGroups;
  if (j0 >= words) return;                 // whole warps leave together
  for (int64_t row = blockIdx.y; row < rows; row += gridDim.y) {
    const T* src = v + row * n;
    uint64_t vals[kGroups];
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int64_t e = (j0 + g) * 32 + lane;
      vals[g] = e < n ? static_cast<uint64_t>(src[e]) >> shift : 0u;
    }
    for (int base = 0; base < w; base += 32) {   // planes base .. base + 31
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        stage[warp][lane][g] =
            transpose32(static_cast<uint32_t>(vals[g] >> base), lane);
      }
      __syncwarp();
      const int g = lane % kGroups;
#pragma unroll
      for (int r = 0; r < 32; r += 32 / kGroups) {  // 4 planes per store
        const int plane = r + lane / kGroups;
        if (base + plane < w && j0 + g < words) {
          out[(row * w + base + plane) * words + j0 + g] = stage[warp][plane][g];
        }
      }
      __syncwarp();
    }
  }
}

template <typename T>
__global__ void pack_ballot_kernel(const T* __restrict__ v, int64_t rows,
                                   int64_t n, int64_t words, int shift, int w,
                                   uint32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t j0 =
      (static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32) * 32;
  if (j0 >= words) return;                 // whole warps leave together
  const bool store = j0 + lane < words;
  for (int64_t row = blockIdx.y; row < rows; row += gridDim.y) {
    const T* src = v + row * n;
    T vals[32];
#pragma unroll
    for (int g = 0; g < 32; ++g) {
      const int64_t e = (j0 + g) * 32 + lane;
      vals[g] = e < n ? static_cast<T>(src[e] >> shift) : T(0);
    }
    uint32_t* dst = out + row * w * words + j0 + lane;
    for (int i = 0; i < w; ++i) {
      uint32_t mine = 0;
#pragma unroll
      for (int g = 0; g < 32; ++g) {
        const uint32_t word =
            __ballot_sync(0xffffffffu, static_cast<int>((vals[g] >> i) & 1u));
        if (lane == g) mine = word;
      }
      if (store) dst[i * words] = mine;
    }
  }
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

unsigned int grid_y(int64_t rows) {
  return static_cast<unsigned int>(rows < kMaxGridY ? rows : kMaxGridY);
}

template <typename T>
int launch_pack(const void* v, int64_t rows, int64_t n, void* out, int shift,
                int w, void* stream) {
  const int64_t words = (n + 31) / 32;
  const bool ballot = w <= kBallotMaxW;
  const int64_t per_warp = ballot ? 32 : kGroups;
  const int64_t tiles = (words + per_warp - 1) / per_warp;  // one warp each
  const dim3 grid(static_cast<unsigned int>((tiles + kWarps - 1) / kWarps),
                  grid_y(rows));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ballot) {
    pack_ballot_kernel<T><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(v), rows, n, words, shift, w,
        static_cast<uint32_t*>(out));
  } else {
    pack_transpose_kernel<T><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(v), rows, n, words, shift, w,
        static_cast<uint32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// v: (rows, n) int32 values -> out: (rows, w, W) words of bits 0..w-1.
extern "C" int hb_pack(const void* v, int64_t rows, int64_t n, void* out,
                       int64_t w, void* stream) {
  return launch_pack<uint32_t>(v, rows, n, out, 0, static_cast<int>(w), stream);
}

// x: (rows, n) int64 ring values -> out: (rows, k - m, W) words of bits
// m..k-1.
extern "C" int hb_pack_ring(const void* x, int64_t rows, int64_t n, void* out,
                            int64_t k, int64_t m, void* stream) {
  return launch_pack<uint64_t>(x, rows, n, out, static_cast<int>(m),
                               static_cast<int>(k - m), stream);
}

// words: (rows, w, W) -> out: (rows, n) values, n <= 32 W, 1 <= w <= 32.
extern "C" int hb_unpack(const void* words, int64_t rows, int64_t w,
                         int64_t n_words, int64_t n, void* out, void* stream) {
  int dev = 0, sms = 0, occ = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&occ, cudaDevAttrMaxThreadsPerMultiProcessor, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tiles = rows * ((n + kUnpackTile - 1) / kUnpackTile);
  const int64_t cap = static_cast<int64_t>(kUnpackWaves) * sms * (occ / kUnpackThreads);
  const int64_t blocks = tiles < cap ? tiles : cap;
  unpack_kernel<<<static_cast<unsigned int>(blocks > 0 ? blocks : 1), kUnpackThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), rows, static_cast<int>(w), n_words,
      n, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
