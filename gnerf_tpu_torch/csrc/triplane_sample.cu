// Tri-plane sampling: bilinear lookups of the three feature planes at 3D
// points, the render's `sample_from_planes`, as one pass that reads each
// point's coordinates once and writes its 3 x C features once.
//
// Not a TPU kernel: the JAX package samples the planes with one XLA gather
// (`gnerf_tpu/render/renderer.py::sample_from_planes`) and has no Pallas
// kernel for it. It was added because the port's route without a gradient,
// `F.grid_sample` on NCHW planes widened to fp32, then a transpose and a cast
// to the planes' type made contiguous, moved ~8.5 GB of device memory for
// each 15-frame orbit chunk's pass where ~1.2 GB are needed: an fp32
// [3, C, M] intermediate written and read twice more, each output channel a
// separate strided gather.
//
// What bounds it on an H100: bytes. A point reads 12 bytes of coordinates
// and writes 3 x C values; the planes ([N, 3, H, W, C], 12.6 MB in bf16 at
// 32 x 256^2) stay in the 50 MB L2. Least time: (N * M * (12 + 3 * C * elt)
// + N * 3 * C * H * W * elt) / 3.35 TB/s, 0.363 ms for an orbit chunk
// (N = 1, M = 15 * 64^2 * 96, C = 32, bf16).
//
// The design moves only those bytes, 16 bytes a load or store:
// - Channels last. The wrapper gives the planes as [N, 3, H, W, C], so one
//   texel's C channels are contiguous (64 bytes in bf16, 128 in fp32).
// - A thread takes one point and 8 channels (one 16-byte slice in bf16, two
//   in fp32) and walks the three planes. Neighbouring lanes take a point's
//   slices, then neighbouring points: at C = 32 a bf16 warp (8 points)
//   writes 512 contiguous bytes of each plane's [M, C] rows and reads whole
//   64-byte texels; an fp32 thread's two slices sit 64 bytes apart, so that
//   each of its loads and stores still covers 64 contiguous bytes a point.
//   Points come ray-major (a ray's samples next to each other in M), so
//   neighbouring lanes read nearby texels, which L1 and L2 hold.
// - Corners outside the plane are masked, not loaded. Indices are 32-bit
//   within a plane. The result is rounded once to the planes' type and
//   stored with an evict-first hint, so that the output does not push the
//   planes out of L2. No fp32 intermediate or transposed copy is written.
// - Measured alternatives (bf16 orbit chunk, ms, bound 0.363): two threads
//   a point (16 channels each) 0.70, one 1.01; all 12 corner loads issued
//   before any sum 0.58; this design 0.54, 0.48 on importance-like samples.
// - Arithmetic: `F.grid_sample`'s CUDA kernel (bilinear, zeros outside,
//   align_corners=False), written as it writes it: points scaled in fp32
//   (a rounded product), source index ((u + 1) * W - 1) / 2, corner weights
//   as products of distances, the four products summed nw, ne, sw, se into
//   an fp32 sum from 0, bf16 texels widened exactly. nvcc contracts the
//   same expressions the same way, so the sums equal the library's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChannels = 8;  // channels a thread: one 16-byte slice in bf16, two in fp32

struct Params {
  const void* planes;   // [N, 3, H, W, C], channels last
  const float* coords;  // [N, M, 3] fp32
  void* out;            // [N, 3, M, C]
  int m, c, h, w;
  float scale;          // 2 / box_warp, in fp32
};

// One 16-byte slice of a texel (kSlice channels) into fp32, and kSlice fp32
// sums out, rounded once to the type.
template <typename T>
struct Io;

template <>
struct Io<float> {
  static constexpr int kSlice = 4;
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  }
};

template <>
struct Io<__nv_bfloat16> {
  static constexpr int kSlice = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
    const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = __uint_as_float(w[k] << 16);
      v[2 * k + 1] = __uint_as_float(w[k] & 0xFFFF0000u);
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
      w[k] = *reinterpret_cast<const uint32_t*>(&b);
    }
    __stcs(reinterpret_cast<uint4*>(p), make_uint4(w[0], w[1], w[2], w[3]));
  }
};

// F.grid_sample's unnormalisation (align_corners=False), as it writes it.
__device__ __forceinline__ float source_index(float coord, int size) {
  return ((coord + 1.f) * size - 1) / 2;
}

// Grid: x over points (blockDim.y a block), y over N; a point's C channels
// on blockDim.x = C / 8 neighbouring threads. Thread h takes the 16-byte
// slices h, h + blockDim.x, ... of a texel, so that each load or store of a
// warp covers blockDim.x x 16 contiguous bytes of every point's row. The
// planes one after another: a corner's loads, its products, a plane's store.
template <typename T>
__global__ void __launch_bounds__(kThreads) triplane_sample_kernel(Params p) {
  constexpr int S = Io<T>::kSlice;
  constexpr int K = kChannels / S;  // slices a thread
  const int m = blockIdx.x * blockDim.y + threadIdx.y;
  if (m >= p.m) return;
  const int lane_step = blockDim.x * S;  // channels between a thread's slices
  const size_t n = blockIdx.y;
  const float* xyz = p.coords + (n * p.m + m) * 3;
  // Rounded products, as the separate scaling the library route makes:
  // never contracted into the source index's addition.
  const float x = __fmul_rn(xyz[0], p.scale);
  const float y = __fmul_rn(xyz[1], p.scale);
  const float z = __fmul_rn(xyz[2], p.scale);
  const float us[3] = {x, x, z};  // indexes W
  const float vs[3] = {y, z, x};  // indexes H
  const size_t plane_size = static_cast<size_t>(p.h) * p.w * p.c;
  const int first = threadIdx.x * S;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float ix = source_index(us[k], p.w);
    float iy = source_index(vs[k], p.h);
    // A point a texel or more past a plane's edge, or not finite, reads no
    // corner: its index becomes -2, both of whose corners lie outside, which
    // keeps the offsets below small.
    if (!(ix > -2.f && ix < p.w + 1.f)) ix = -2.f;
    if (!(iy > -2.f && iy < p.h + 1.f)) iy = -2.f;
    const float x0 = floorf(ix), y0 = floorf(iy);
    const float x1 = x0 + 1.f, y1 = y0 + 1.f;
    const float weight[4] = {(x1 - ix) * (y1 - iy), (ix - x0) * (y1 - iy),
                             (x1 - ix) * (iy - y0), (ix - x0) * (iy - y0)};  // nw ne sw se
    const int cx = static_cast<int>(x0), cy = static_cast<int>(y0);
    const bool in_x0 = static_cast<unsigned>(cx) < static_cast<unsigned>(p.w);
    const bool in_x1 = static_cast<unsigned>(cx + 1) < static_cast<unsigned>(p.w);
    const bool in_y0 = static_cast<unsigned>(cy) < static_cast<unsigned>(p.h);
    const bool in_y1 = static_cast<unsigned>(cy + 1) < static_cast<unsigned>(p.h);
    const bool inside[4] = {in_y0 && in_x0, in_y0 && in_x1, in_y1 && in_x0, in_y1 && in_x1};
    const int nw = (cy * p.w + cx) * p.c + first;
    const int offset[4] = {nw, nw + p.c, nw + p.w * p.c, nw + (p.w + 1) * p.c};
    const T* plane = static_cast<const T*>(p.planes) + (n * 3 + k) * plane_size;
    float acc[kChannels];
#pragma unroll
    for (int j = 0; j < kChannels; ++j) acc[j] = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (!inside[q]) continue;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        float v[S];
        Io<T>::load(plane + offset[q] + j * lane_step, v);
#pragma unroll
        for (int i = 0; i < S; ++i) acc[j * S + i] += v[i] * weight[q];
      }
    }
    T* row = static_cast<T*>(p.out) + ((n * 3 + k) * p.m + m) * static_cast<size_t>(p.c);
    row += first;
#pragma unroll
    for (int j = 0; j < K; ++j) Io<T>::store(row + j * lane_step, acc + j * S);
  }
}

template <typename T>
int launch(const Params& p, int n, cudaStream_t stream) {
  const dim3 block(p.c / kChannels, kThreads / (p.c / kChannels));
  const dim3 grid((p.m + block.y - 1) / block.y, n);
  triplane_sample_kernel<T><<<grid, block, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out[N, 3, M, C] = the bilinear samples of planes[N, 3, H, W, C] (channels
// last, contiguous) at coords[N, M, 3] (fp32, contiguous) scaled by `scale`,
// projected to (x, y), (x, z), (z, x); zeros outside. fp32 (bf16 = 0) or bf16
// (bf16 = 1) planes and output, 16-byte aligned; C a multiple of 8 up to
// 2048, N at most 65535, (H + 1) * (W + 1) * C below 2^31. Returns the launch's CUDA
// error (0 on success).
extern "C" int triplane_sample_launch(const void* planes, const float* coords, void* out,
                                      int bf16, int n, int m, int c, int h, int w, float scale,
                                      void* stream) {
  if (n < 1 || n > 65535 || m < 1 || c < 8 || c % 8 || c > 2048 || h < 1 || w < 1 ||
      static_cast<long long>(h + 1) * (w + 1) * c >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{};
  p.planes = planes;
  p.coords = coords;
  p.out = out;
  p.m = m;
  p.c = c;
  p.h = h;
  p.w = w;
  p.scale = scale;
  auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(p, n, s) : launch<float>(p, n, s);
}
