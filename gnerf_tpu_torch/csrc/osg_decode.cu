// OSG tri-plane point decoder for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernel gnerf_tpu/ops/fused_decoder.py::fused_osg_decode.
// For features f[N, 3, M, C] (fp32 or bf16) and gain-folded weights
//   w1e[C, H] (feature dtype), b1e[H], w2e[H, D], b2e[D] (fp32)
// it writes out[N, M, D] (fp32):
//   h   = softplus((f0 + f1 + f2) . w1e / 3 + b1e)
//   o   = h . w2e + b2e
//   out = [o_0 | sigmoid(o_1..) * 1.002 - 0.001]
//
// Bound: at the main-path shape (M = 64*64*96, C = 32, H = 64, D = 33, bf16
// features) the call moves ~127 MB for ~3.3 GFLOP, so it is memory-bound on
// an H100 (~38 us at 3.35 TB/s). The design therefore reads every feature
// byte once with 16-byte vector loads, keeps the 64-wide hidden layer in
// registers, and writes each output row once, staged through shared memory so
// that the block's stores are contiguous. The plane mean is folded ahead of
// the first product (one C x H product per point instead of three). Weights
// live in shared memory, zero-padded to kMaxH so the unrolled loops need no
// bounds checks. One thread decodes one point; blocks stride over tiles of
// kThreads points, and the ragged tail is masked in-kernel (no padding copy).
// Tensor-core (wgmma) products and fusing the bilinear plane lookups are
// later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // points per tile, one per thread
constexpr int kMaxC = 64;      // feature width limit (multiple of 8)
constexpr int kMaxH = 64;      // hidden width limit; smem rows padded to this
constexpr int kMaxD = 64;      // output width limit

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// Eight consecutive features from a 16-byte aligned address, widened to fp32.
template <bool kBf16>
__device__ __forceinline__ void load8(const void* p, float* v) {
  if (kBf16) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    v[0] = bf16_lo(q.x); v[1] = bf16_hi(q.x);
    v[2] = bf16_lo(q.y); v[3] = bf16_hi(q.y);
    v[4] = bf16_lo(q.z); v[5] = bf16_hi(q.z);
    v[6] = bf16_lo(q.w); v[7] = bf16_hi(q.w);
  } else {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
}

template <bool kBf16>
__device__ __forceinline__ float load_weight(const void* w, int i) {
  if (kBf16) {
    const uint16_t bits = reinterpret_cast<const uint16_t*>(w)[i];
    return __uint_as_float(static_cast<uint32_t>(bits) << 16);
  }
  return reinterpret_cast<const float*>(w)[i];
}

// Numerically stable softplus, as jax.nn.softplus.
__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
osg_decode_kernel(const void* __restrict__ feats, const void* __restrict__ w1e,
                  const float* __restrict__ b1e, const float* __restrict__ w2e,
                  const float* __restrict__ b2e, float* __restrict__ out,
                  int M, int C, int H, int D) {
  extern __shared__ __align__(16) float smem[];
  float* s_w1 = smem;                 // [C][kMaxH], columns >= H are zero
  float* s_w2t = s_w1 + C * kMaxH;    // [D][kMaxH] (w2e transposed), zero-padded
  float* s_b1 = s_w2t + D * kMaxH;    // [kMaxH]
  float* s_b2 = s_b1 + kMaxH;         // [D]
  float* s_out = s_b2 + D;            // [kThreads][D] output staging

  const int tid = threadIdx.x;
  for (int i = tid; i < C * kMaxH; i += kThreads) {
    const int c = i / kMaxH, h = i % kMaxH;
    s_w1[i] = h < H ? load_weight<kBf16>(w1e, c * H + h) : 0.0f;
  }
  for (int i = tid; i < D * kMaxH; i += kThreads) {
    const int d = i / kMaxH, h = i % kMaxH;
    s_w2t[i] = h < H ? w2e[h * D + d] : 0.0f;
  }
  for (int h = tid; h < kMaxH; h += kThreads) s_b1[h] = h < H ? b1e[h] : 0.0f;
  for (int d = tid; d < D; d += kThreads) s_b2[d] = b2e[d];
  __syncthreads();

  const int n = blockIdx.y;
  const size_t elem = kBf16 ? 2 : 4;
  const char* plane0 = static_cast<const char*>(feats) + (size_t)n * 3 * M * C * elem;
  const size_t plane_stride = (size_t)M * C * elem;
  float* out_n = out + (size_t)n * M * D;
  const int n_tiles = (M + kThreads - 1) / kThreads;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int m0 = tile * kThreads;
    const int m = m0 + tid;
    const int rows = min(kThreads, M - m0);
    if (m < M) {
      float acc[kMaxH];
#pragma unroll
      for (int h = 0; h < kMaxH; ++h) acc[h] = 0.0f;
      const char* row0 = plane0 + (size_t)m * C * elem;
      for (int c0 = 0; c0 < C; c0 += 8) {
        float f0[8], f1[8], f2[8];
        load8<kBf16>(row0 + c0 * elem, f0);
        load8<kBf16>(row0 + plane_stride + c0 * elem, f1);
        load8<kBf16>(row0 + 2 * plane_stride + c0 * elem, f2);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float s = f0[j] + f1[j] + f2[j];
          const float* w = s_w1 + (c0 + j) * kMaxH;
#pragma unroll
          for (int h = 0; h < kMaxH; ++h) acc[h] = fmaf(s, w[h], acc[h]);
        }
      }
#pragma unroll
      for (int h = 0; h < kMaxH; ++h) acc[h] = softplus(acc[h] / 3.0f + s_b1[h]);
      float* dst = s_out + tid * D;
      for (int d = 0; d < D; ++d) {
        const float* w = s_w2t + d * kMaxH;
        float o = s_b2[d];
#pragma unroll
        for (int h = 0; h < kMaxH; ++h) o = fmaf(acc[h], w[h], o);
        dst[d] = d == 0 ? o : 1.0f / (1.0f + expf(-o)) * (1.0f + 2.0f * 0.001f) - 0.001f;
      }
    }
    __syncthreads();
    float* dst = out_n + (size_t)m0 * D;
    for (int i = tid; i < rows * D; i += kThreads) dst[i] = s_out[i];
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Shared memory bytes one block needs for the given sizes.
static size_t osg_decode_smem_bytes(int C, int D) {
  return sizeof(float) * ((size_t)C * kMaxH + (size_t)D * kMaxH + kMaxH + D + (size_t)kThreads * D);
}

// Launches the decoder on `stream`; returns the CUDA error code (0 = success).
// Pointers are device pointers to contiguous tensors; feats_bf16 selects the
// feature (and w1e) type: 0 = fp32, 1 = bf16. Limits: C % 8 == 0, C <= 64,
// H <= 64, D <= 64, N <= 65535.
int osg_decode_launch(const void* feats, const void* w1e, const void* b1e,
                      const void* w2e, const void* b2e, void* out,
                      int N, int M, int C, int H, int D, int feats_bf16,
                      void* stream) {
  if (C % 8 != 0 || C > kMaxC || C <= 0 || H > kMaxH || H <= 0 || D > kMaxD ||
      D <= 0 || N <= 0 || N > 65535 || M < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (M == 0) return 0;
  const size_t smem = osg_decode_smem_bytes(C, D);
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int n_tiles = (M + kThreads - 1) / kThreads;
  const int blocks_x = n_tiles < sms * 8 ? n_tiles : sms * 8;
  const dim3 grid(blocks_x, N);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (feats_bf16) {
    err = cudaFuncSetAttribute(osg_decode_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    osg_decode_kernel<true><<<grid, kThreads, smem, s>>>(
        feats, w1e, static_cast<const float*>(b1e), static_cast<const float*>(w2e),
        static_cast<const float*>(b2e), static_cast<float*>(out), M, C, H, D);
  } else {
    err = cudaFuncSetAttribute(osg_decode_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    osg_decode_kernel<false><<<grid, kThreads, smem, s>>>(
        feats, w1e, static_cast<const float*>(b1e), static_cast<const float*>(w2e),
        static_cast<const float*>(b2e), static_cast<float*>(out), M, C, H, D);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
