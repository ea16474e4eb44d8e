// FIR resampling of NCHW images (upfirdn2d): zero-insert upsample by `up`,
// pad or crop, FIR filter, keep every `down`-th sample, as one polyphase
// pass that reads the input once and writes the output once.
//
// Not a TPU kernel: it replaces the plain PyTorch route of
// `gnerf_tpu_torch/ops/upfirdn2d.py`, the port of `gnerf_tpu/ops/upfirdn2d.py`,
// which is one XLA convolution (lhs dilation, window strides, negative
// padding) and has no Pallas kernel. The plain route writes the
// zero-inserted image (up^2 times the input), pads it (a second copy), runs
// a depthwise convolution at the upsampled size in which all but 1 / up^2
// of the taps multiply inserted zeros, and then slices every down-th sample.
//
// What bounds it on an H100: bytes. An output of the superresolution's
// up = 2, 4x4 layers takes 4 multiply-adds and 2 bytes written (bf16), its
// share of the input half a byte read: ~1.6 operations a byte, against the
// ~20 at which 67 TFLOP/s of fp32 and 3.35 TB/s balance. The least time is
// (input + output bytes) / 3.35 TB/s: `block1.conv0` of a 15-frame orbit
// chunk, [15, 256, 256, 256] bf16 in and [15, 256, 514, 514] out, moves
// 2.533 GB, 0.756 ms.
//
// The design moves only those bytes:
// - Polyphase. An output is computed from the input pixels whose taps
//   survive the zero-insertion (for up = 2 and 4 taps, 2x2 of them);
//   down > 1 computes only the kept outputs. Padding, negative padding (a
//   crop) included, is index arithmetic with zeros at the masked edges.
// - Tiles. A block loads its input tile and halo once into shared memory,
//   as fp32, with 16-byte loads where a row allows, then writes its output
//   tile: four times the input's pixels at up = 2. A thread computes 16
//   bytes of consecutive outputs of one row (8 bf16 or 4 fp32) and writes
//   them with one 16-byte store. Rows of a width that is not a multiple of
//   16 bytes (514 bf16 values are 1,028 bytes) are cut into groups aligned
//   on the address, so every group but a row's first and last is one
//   aligned store. NCHW contiguous in and out, as the plain route.
// - Arithmetic. fp32 sums, one rounding to the working type. The taps are
//   the plain route's: f * gain^(f.dim() / 2) in fp32, rounded to the
//   working type, flipped unless flip_filter (the plain route convolves);
//   so the two differ only in the order of their sums. A separable filter
//   sums a row's products, then the rows (the plain route rounds the first
//   pass to the working type; here only the output is rounded).
// - Instances, chosen by the host from what the call is: a compile-time body
//   for 2-D 4x4 taps at (up, down) = (2, 1), (1, 2) and (1, 1), the one
//   that the StyleGAN2 layers, their gradients and D's downsampling take,
//   with the taps and a row's inputs in registers and the phase of a group
//   (where its first output falls between inserted zeros) one of up^2
//   unrolled variants; and a body with run-time factors and taps, 2-D or
//   separable, for every other call (ADA's 12 taps, filtered_lrelu's
//   filters, the EG3D blur, pad-only calls without a filter).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 6;        // resident blocks an SM: at most 40 registers a thread
constexpr int kMaxSmem = 48 * 1024;  // without opting in to more shared memory

struct Params {
  const void* x;
  void* y;
  const float* f;  // the filter as given (fp32), or null: one tap of 1
  int planes, h, w, oh, ow;
  int upx, upy, downx, downy, padx0, pady0;
  int fw, fh, separable, flip;
  float scale;  // gain^(f.dim() / 2)
  int tile_oh, tile_groups;     // a block's output rows, and 16-byte groups a row
  int in_rows, in_cols, pitch;  // its input tile in shared memory
  int chunks;                   // 16-byte chunks that cover a tile row
};

// Loads, stores and rounding of the working type; kVec values are 16 bytes.
template <typename T>
struct Io;

template <>
struct Io<float> {
  static constexpr int kVec = 4;
  static __device__ __forceinline__ float get(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ void unpack(uint4 r, float (&v)[kVec]) {
    v[0] = __uint_as_float(r.x);
    v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z);
    v[3] = __uint_as_float(r.w);
  }
  static __device__ __forceinline__ uint4 pack(const float (&v)[kVec]) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
  }
  static __device__ __forceinline__ void put(float* p, float v) { *p = v; }
  static __device__ __forceinline__ float round(float v) { return v; }
};

template <>
struct Io<__nv_bfloat16> {
  static constexpr int kVec = 8;
  static __device__ __forceinline__ float get(const __nv_bfloat16* p) {
    return __uint_as_float(static_cast<uint32_t>(
                               __ldg(reinterpret_cast<const unsigned short*>(p)))
                           << 16);
  }
  static __device__ __forceinline__ void unpack(uint4 r, float (&v)[kVec]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = __uint_as_float(w[k] << 16);
      v[2 * k + 1] = __uint_as_float(w[k] & 0xFFFF0000u);
    }
  }
  static __device__ __forceinline__ uint32_t bits(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ uint4 pack(const float (&v)[kVec]) {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = bits(v[2 * k]) | (bits(v[2 * k + 1]) << 16);
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
  static __device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

__host__ __device__ __forceinline__ int floordiv(int a, int b) {  // b > 0
  const int q = a / b;
  return q * b > a ? q - 1 : q;
}

// The element offset of `p` from a 16-byte boundary, in values of T.
template <typename T>
__device__ __forceinline__ int misalignment(const T* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) / sizeof(T)) % Io<T>::kVec);
}

// The block's input tile, rows row0.., columns col0.., into shared memory as
// fp32, zero outside the image. Chunk k of a tile row is 16 bytes aligned on
// the address: one vector load where it lies inside the image.
template <typename T>
__device__ __forceinline__ void load_tile(const Params& p, const T* x, float* tile, int row0,
                                          int col0) {
  constexpr int V = Io<T>::kVec;
  const int n = p.in_rows * p.chunks;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int r = i / p.chunks;
    const int k = i - r * p.chunks;
    const int iy = row0 + r;
    const bool row_in = iy >= 0 && iy < p.h;
    const T* xrow = x + static_cast<int64_t>(row_in ? iy : 0) * p.w;
    // (the address of tile column 0 of this row, in values, mod V)
    const int mis = ((misalignment(xrow) + col0) % V + V) % V;
    const int c = k * V - mis;  // the chunk's first tile column
    if (c >= p.in_cols) continue;
    const int ix = col0 + c;
    float v[V];
    if (row_in && ix >= 0 && ix + V <= p.w) {
      Io<T>::unpack(__ldg(reinterpret_cast<const uint4*>(xrow + ix)), v);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        v[j] = row_in && ix + j >= 0 && ix + j < p.w ? Io<T>::get(xrow + ix + j) : 0.0f;
      }
    }
    float* dst = tile + r * p.pitch;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (c + j >= 0 && c + j < p.in_cols) dst[c + j] = v[j];
    }
  }
}

// The compile-time body: V outputs of one row from `src` (the tile at the
// group's first input row and column), phase (PY, PX): where the group's
// window starts between the inserted zeros.
template <int UP, int DOWN, int TAPS, int V, int PY, int PX>
__device__ __forceinline__ void accumulate(const float* src, int pitch,
                                           const float (&tap)[TAPS][TAPS], float (&acc)[V]) {
  constexpr int kCols = (PX + (V - 1) * DOWN + TAPS - 1) / UP + 1;
#pragma unroll
  for (int ky = 0; ky < TAPS; ++ky) {
    if ((PY + ky) % UP == 0) {
      const float* row = src + ((PY + ky) / UP) * pitch;
      float v[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) v[c] = row[c];
#pragma unroll
      for (int j = 0; j < V; ++j) {
#pragma unroll
        for (int kx = 0; kx < TAPS; ++kx) {
          if ((PX + j * DOWN + kx) % UP == 0) {
            acc[j] = fmaf(tap[ky][kx], v[(PX + j * DOWN + kx) / UP], acc[j]);
          }
        }
      }
    }
  }
}

template <int UP, int DOWN, int TAPS, int V>
__device__ __forceinline__ void accumulate_phase(int py, int px, const float* src, int pitch,
                                                 const float (&tap)[TAPS][TAPS],
                                                 float (&acc)[V]) {
  static_assert(UP == 1 || UP == 2, "compile-time bodies exist for up 1 and 2");
  if constexpr (UP == 1) {
    accumulate<1, DOWN, TAPS, V, 0, 0>(src, pitch, tap, acc);
  } else if (py == 0) {
    if (px == 0) {
      accumulate<2, DOWN, TAPS, V, 0, 0>(src, pitch, tap, acc);
    } else {
      accumulate<2, DOWN, TAPS, V, 0, 1>(src, pitch, tap, acc);
    }
  } else if (px == 0) {
    accumulate<2, DOWN, TAPS, V, 1, 0>(src, pitch, tap, acc);
  } else {
    accumulate<2, DOWN, TAPS, V, 1, 1>(src, pitch, tap, acc);
  }
}

// The run-time body: one output at (oy, ox). `taps` holds the correlation
// weights: fh x fw, or for a separable filter fw horizontal then fh
// vertical.
__device__ __forceinline__ float output_at(const Params& p, const float* taps,
                                           const float* tile, int row0, int col0, int oy,
                                           int ox) {
  const int ty = oy * p.downy - p.pady0;  // the window's first upsampled row
  const int tx = ox * p.downx - p.padx0;
  const int iy0 = floordiv(ty + p.upy - 1, p.upy);  // the first input row at or after it
  const int ix0 = floordiv(tx + p.upx - 1, p.upx);
  float sum = 0.0f;
  for (int ky = iy0 * p.upy - ty, iy = iy0; ky < p.fh; ky += p.upy, ++iy) {
    const float* row = tile + (iy - row0) * p.pitch - col0;
    if (p.separable) {
      float rsum = 0.0f;
      for (int kx = ix0 * p.upx - tx, ix = ix0; kx < p.fw; kx += p.upx, ++ix) {
        rsum = fmaf(taps[kx], row[ix], rsum);
      }
      sum = fmaf(taps[p.fw + ky], rsum, sum);
    } else {
      for (int kx = ix0 * p.upx - tx, ix = ix0; kx < p.fw; kx += p.upx, ++ix) {
        sum = fmaf(taps[ky * p.fw + kx], row[ix], sum);
      }
    }
  }
  return sum;
}

// UP == 0: the run-time body (factors and taps from `p`); otherwise the
// compile-time one for 2-D TAPS x TAPS taps at (UP, DOWN) on both axes.
template <typename T, int UP, int DOWN, int TAPS>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    upfirdn2d_kernel(const __grid_constant__ Params p) {
  constexpr int V = Io<T>::kVec;
  constexpr int K = TAPS > 0 ? TAPS : 1;
  extern __shared__ float smem[];
  const int ntaps = p.separable ? p.fw + p.fh : p.fw * p.fh;
  float* taps = smem;
  float* tile = smem + ntaps;
  for (int i = threadIdx.x; i < ntaps; i += kThreads) {
    int src;
    if (p.separable) {
      const int n = i < p.fw ? p.fw : p.fh;
      const int k = i < p.fw ? i : i - p.fw;
      src = p.flip ? k : n - 1 - k;
    } else {
      src = p.flip ? i : p.fw * p.fh - 1 - i;
    }
    taps[i] = Io<T>::round(__fmul_rn(p.f != nullptr ? p.f[src] : 1.0f, p.scale));
  }
  float tap[K][K];  // the compile-time body's taps, read after the tile's barrier
  const int ox_lo = blockIdx.x * p.tile_groups * V - (V - 1);  // the tile's lowest column
  const int oy0 = blockIdx.y * p.tile_oh;
  const int row0 = floordiv(oy0 * p.downy - p.pady0, p.upy);
  const int col0 = floordiv(ox_lo * p.downx - p.padx0, p.upx);
  const int items = p.tile_oh * p.tile_groups;
  const int half = (p.tile_oh + 1) / 2;
  for (int plane = blockIdx.z; plane < p.planes; plane += gridDim.z) {
    const T* x = static_cast<const T*>(p.x) + static_cast<int64_t>(plane) * p.h * p.w;
    T* y = static_cast<T*>(p.y) + static_cast<int64_t>(plane) * p.oh * p.ow;
    if (plane != blockIdx.z) __syncthreads();  // the last plane's tile has been read
    load_tile(p, x, tile, row0, col0);
    __syncthreads();
    if constexpr (TAPS > 0) {
#pragma unroll
      for (int ky = 0; ky < TAPS; ++ky) {
#pragma unroll
        for (int kx = 0; kx < TAPS; ++kx) tap[ky][kx] = taps[ky * TAPS + kx];
      }
    }
    for (int i = threadIdx.x; i < items; i += kThreads) {
      const int q = i / p.tile_groups;
      const int g = i - q * p.tile_groups;
      // up = 2: the tile's even rows first, then its odd ones, so that the
      // rows of a warp share their vertical phase
      const int r = UP == 2 ? (q < half ? 2 * q : 2 * (q - half) + 1) : q;
      const int oy = oy0 + r;
      if (oy >= p.oh || r >= p.tile_oh) continue;
      T* yrow = y + static_cast<int64_t>(oy) * p.ow;
      // Group g of a row starts -misalignment(yrow) + V g: aligned stores.
      const int gx = V * (blockIdx.x * p.tile_groups + g) - misalignment(yrow);
      if (gx >= p.ow) continue;
      float acc[V];
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] = 0.0f;
      if constexpr (UP > 0) {
        const int ty = oy * DOWN - p.pady0;
        const int tx = gx * DOWN - p.padx0;
        const int iy = floordiv(ty, UP);
        const int ix = floordiv(tx, UP);
        accumulate_phase<UP, DOWN, TAPS, V>(ty - iy * UP, tx - ix * UP,
                                            tile + (iy - row0) * p.pitch + (ix - col0), p.pitch,
                                            tap, acc);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          if (gx + j >= 0 && gx + j < p.ow) {
            acc[j] = output_at(p, taps, tile, row0, col0, oy, gx + j);
          }
        }
      }
      if (gx >= 0 && gx + V <= p.ow) {
        *reinterpret_cast<uint4*>(yrow + gx) = Io<T>::pack(acc);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          if (gx + j >= 0 && gx + j < p.ow) Io<T>::put(yrow + gx + j, acc[j]);
        }
      }
    }
  }
}

// The channels-last instance: x [N, H, W, C] bf16 upsampled by 2 on both
// axes through 2-D 4x4 taps, optionally after a per-(n, c) input scale
// rounded to bf16 (the plain chain's x * styles), into y [N, OH, OW, C]. At
// up = 2 with 4 taps the two outputs of a row pair whose first window starts
// on an inserted zero (odd ty) read the same two input rows, and likewise
// for columns: a quad of 2 x 2 outputs reads a 2 x 2 window of inputs. A
// thread takes 8 channels of one quad: four 16-byte loads, 16 sums of four
// products each, four 16-byte stores. The sums are the NCHW body's (taps in
// ascending ky, then kx, from 0, with fmaf), so from the same scaled input
// the two instances are equal bit for bit. A block's threads in x cover a
// quad's C / 8 channel slices, those in y neighbouring quads of a row.
struct NhwcParams {
  const __nv_bfloat16* x;
  __nv_bfloat16* y;
  const __nv_bfloat16* styles;  // [N, C] or null
  const float* f;               // the 4x4 filter as given (fp32)
  int h, w, c, oh, ow;
  int quads_y, quads_x;  // quad rows and columns
  int shift_y, shift_x;  // output row (column) of quad 0's first, negated
  int row0, col0;        // the first input row (column) of quad 0
  float scale;           // gain
};

__global__ void __launch_bounds__(kThreads) upfirdn2d_nhwc_kernel(const NhwcParams p) {
  constexpr int V = Io<__nv_bfloat16>::kVec;
  const int qx = blockIdx.x * blockDim.y + threadIdx.y;
  const int qy = blockIdx.y;
  const int n = blockIdx.z;
  if (qx >= p.quads_x) return;
  const int c0 = threadIdx.x * V;
  float tap[4][4];  // correlation taps, as the NCHW body's: the filter flipped, rounded
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    tap[i / 4][i % 4] = Io<__nv_bfloat16>::round(__fmul_rn(__ldg(p.f + 15 - i), p.scale));
  }
  float style[V];
  if (p.styles != nullptr) {
    Io<__nv_bfloat16>::unpack(
        __ldg(reinterpret_cast<const uint4*>(p.styles + static_cast<size_t>(n) * p.c + c0)),
        style);
  }
  const int iy0 = p.row0 + qy, ix0 = p.col0 + qx;
  const __nv_bfloat16* x = p.x + static_cast<size_t>(n) * p.h * p.w * p.c + c0;
  float in[2][2][V];  // [input row][input column][channel]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int iy = iy0 + r, ix = ix0 + s;
      if (iy >= 0 && iy < p.h && ix >= 0 && ix < p.w) {
        Io<__nv_bfloat16>::unpack(
            __ldg(reinterpret_cast<const uint4*>(
                x + (static_cast<size_t>(iy) * p.w + ix) * p.c)),
            in[r][s]);
        if (p.styles != nullptr) {
#pragma unroll
          for (int j = 0; j < V; ++j) {
            in[r][s][j] = Io<__nv_bfloat16>::round(in[r][s][j] * style[j]);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) in[r][s][j] = 0.0f;
      }
    }
  }
  __nv_bfloat16* y = p.y + static_cast<size_t>(n) * p.oh * p.ow * p.c + c0;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int oy = 2 * qy - p.shift_y + a;
    if (oy < 0 || oy >= p.oh) continue;
    const int ky = 1 - a;  // the first input row's tap: 1 on an odd ty, 0 on an even one
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int ox = 2 * qx - p.shift_x + b;
      if (ox < 0 || ox >= p.ow) continue;
      const int kx = 1 - b;
      float acc[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float sum = 0.0f;
        sum = fmaf(tap[ky][kx], in[0][0][j], sum);
        sum = fmaf(tap[ky][kx + 2], in[0][1][j], sum);
        sum = fmaf(tap[ky + 2][kx], in[1][0][j], sum);
        sum = fmaf(tap[ky + 2][kx + 2], in[1][1][j], sum);
        acc[j] = sum;
      }
      *reinterpret_cast<uint4*>(y + (static_cast<size_t>(oy) * p.ow + ox) * p.c) =
          Io<__nv_bfloat16>::pack(acc);
    }
  }
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Tiles: a tile row of ~512 output bytes and ~16 groups a thread for an
// upsampling call, which writes up^2 times what it reads, so that a block's
// loads, barriers and halo serve more outputs (PERF.md has the variants'
// times); ~256 bytes and ~8 groups otherwise, whose input tile is up to
// down^2 times its output's. Shrunk (rows first, then groups) until the
// input tile fits in 48 KB.
template <typename T, int UP, int DOWN, int TAPS>
int launch(Params p, cudaStream_t stream) {
  constexpr int V = Io<T>::kVec;
  const bool up = p.upx * p.upy > 1;
  const int tile_bytes = up ? 512 : 256;
  const int items = up ? 16 : 8;
  // Groups of a row, its first one starting up to V - 1 columns before it.
  const int groups = (p.ow + 2 * V - 2) / V;
  const int ntaps = p.separable ? p.fw + p.fh : p.fw * p.fh;
  int want_groups = tile_bytes / 16;
  int want_rows = kThreads * items / want_groups;
  size_t smem = 0;
  int tiles_x = 0, tiles_y = 0;
  for (;;) {
    tiles_x = ceil_div(groups, want_groups);
    p.tile_groups = ceil_div(groups, tiles_x);
    tiles_y = ceil_div(p.oh, want_rows);
    p.tile_oh = ceil_div(p.oh, tiles_y);
    p.in_rows = ((p.tile_oh - 1) * p.downy + p.fh - 1) / p.upy + 2;
    p.in_cols = ((p.tile_groups * V + V - 2) * p.downx + p.fw - 1) / p.upx + 2;
    p.pitch = p.in_cols | 1;  // odd: neighbouring rows start in other banks
    p.chunks = ceil_div(p.in_cols, V) + 1;
    smem = sizeof(float) * (ntaps + static_cast<size_t>(p.in_rows) * p.pitch);
    if (smem <= kMaxSmem) break;
    if (p.tile_oh > 1) {
      want_rows = ceil_div(p.tile_oh, 2);
    } else if (p.tile_groups > 1) {
      want_groups = ceil_div(p.tile_groups, 2);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);  // the filter alone is too large
    }
  }
  if (tiles_y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(tiles_x, tiles_y, p.planes < 65535 ? p.planes : 65535);
  upfirdn2d_kernel<T, UP, DOWN, TAPS><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Params& p, cudaStream_t stream) {
  const bool square4 = !p.separable && p.fw == 4 && p.fh == 4 && p.upx == p.upy &&
                       p.downx == p.downy;
  if (square4 && p.upx == 2 && p.downx == 1) return launch<T, 2, 1, 4>(p, stream);
  if (square4 && p.upx == 1 && p.downx == 2) return launch<T, 1, 2, 4>(p, stream);
  if (square4 && p.upx == 1 && p.downx == 1) return launch<T, 1, 1, 4>(p, stream);
  return launch<T, 0, 0, 0>(p, stream);
}

}  // namespace

// y[planes, oh, ow] = upfirdn2d(x[planes, h, w]), both contiguous, fp32
// (bf16 = 0) or bf16 (bf16 = 1). `f`: the fp32 filter on the card, [fh, fw]
// or (separable) [fw] with fw == fh, or null with fw = fh = 1. padx0 and
// pady0: the left and top padding of the upsampled image (negative crops);
// oh and ow follow from it and the right and bottom padding, as the caller
// computed them. `scale`: gain^(f.dim() / 2). Returns the launch's CUDA
// error (0 on success).
extern "C" int upfirdn2d_launch(const void* x, void* y, const float* f, int bf16, int planes,
                                int h, int w, int oh, int ow, int upx, int upy, int downx,
                                int downy, int padx0, int pady0, int fw, int fh, int separable,
                                int flip, float scale, void* stream) {
  if (planes < 1 || h < 1 || w < 1 || oh < 1 || ow < 1 || upx < 1 || upy < 1 || downx < 1 ||
      downy < 1 || fw < 1 || fh < 1 || (separable && fw != fh)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{};
  p.x = x;
  p.y = y;
  p.f = f;
  p.planes = planes;
  p.h = h;
  p.w = w;
  p.oh = oh;
  p.ow = ow;
  p.upx = upx;
  p.upy = upy;
  p.downx = downx;
  p.downy = downy;
  p.padx0 = padx0;
  p.pady0 = pady0;
  p.fw = fw;
  p.fh = fh;
  p.separable = separable;
  p.flip = flip;
  p.scale = scale;
  auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(p, s) : dispatch<float>(p, s);
}

// y[N, OH, OW, C] = upfirdn2d(x[N, H, W, C] * styles[N, C]) at up = 2, down
// = 1 on both axes through the 2-D 4x4 filter `f` (fp32 on the card,
// convolved: flip_filter false); x and y bf16, channels last, contiguous
// and 16-byte aligned; `styles` bf16 [N, C] or null (no input scale).
// padx0, pady0: the left and top padding of the upsampled image (negative
// crops); oh and ow as the caller computed them. `scale`: gain. C a
// multiple of 8 up to 2048, N at most 65535. Returns the launch's CUDA
// error (0 on success).
extern "C" int upfirdn2d_nhwc_launch(const void* x, void* y, const float* f, const void* styles,
                                     int n, int h, int w, int c, int oh, int ow, int padx0,
                                     int pady0, float scale, void* stream) {
  if (n < 1 || n > 65535 || h < 1 || w < 1 || oh < 1 || ow < 1 || c < 8 || c % 8 ||
      c > 8 * kThreads || f == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  NhwcParams p{};
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.y = static_cast<__nv_bfloat16*>(y);
  p.styles = static_cast<const __nv_bfloat16*>(styles);
  p.h = h;
  p.w = w;
  p.c = c;
  p.f = f;
  p.oh = oh;
  p.ow = ow;
  p.scale = scale;
  // Quad q's first output row is 2 q - shift_y, the row whose window starts
  // on an odd upsampled row (ty = oy - pady0), and its input rows are
  // row0 + q and row0 + q + 1.
  p.shift_y = ((pady0 + 1) % 2 + 2) % 2;
  p.shift_x = ((padx0 + 1) % 2 + 2) % 2;
  p.row0 = (-p.shift_y - pady0 + 1) / 2;
  p.col0 = (-p.shift_x - padx0 + 1) / 2;
  p.quads_y = (oh + p.shift_y + 1) / 2;
  p.quads_x = (ow + p.shift_x + 1) / 2;
  const dim3 block(c / 8, kThreads / (c / 8));
  const dim3 grid(ceil_div(p.quads_x, block.y), p.quads_y, n);
  if (p.quads_y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  upfirdn2d_nhwc_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
