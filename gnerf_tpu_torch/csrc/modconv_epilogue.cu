// The epilogue of a modulated convolution on channels-last bf16: the
// demodulation scale, the noise, the bias, the activation, its gain and
// clamp, and the next convolution's input styles, as one pass that reads the
// convolution's output once and writes the result once.
//
// Not a TPU kernel: it replaces the plain PyTorch chain of
// `gnerf_tpu_torch/models/stylegan2.py` (`modulated_conv2d`'s demodulation
// and noise, then `ops/bias_act.py`, then the next layer's style multiply),
// the port of `gnerf_tpu/models/stylegan2.py`, which leaves the same chain to
// XLA's fusion and has no Pallas kernel. In PyTorch each link is a pass of
// its own over the activations: up to eight reads and eight writes of a
// [15, 128, 512, 512] bf16 tensor for a 15-frame orbit chunk's
// `block1.conv1`.
//
// What bounds it on an H100: bytes. A value takes up to eight operations
// and 4 bytes (one bf16 read, one written), ~2 operations a byte against the
// ~20 at which 67 TFLOP/s of fp32 and 3.35 TB/s balance. The least time is
// (2 x elements x 2 bytes + the per-channel vectors) / 3.35 TB/s: 0.601 ms
// for `block1.conv1` of an orbit chunk.
//
// The design moves only those bytes:
// - Channels last. The convolution's output is [N, H, W, C] (cuDNN's NHWC
//   fprop writes it so), and a thread takes 8 channels of a pixel: one
//   16-byte load and one 16-byte store. The block's threads in x cover a
//   pixel's C channels, those in y neighbouring pixels, so that a warp reads
//   and writes contiguous bytes.
// - The per-(n, c) vectors (demodulation coefficients, next styles) and the
//   bias stay in registers: a thread loads its 8 channels of each once and
//   then walks kPixels pixels, whose loads it issues before any arithmetic.
//   The noise is one bf16 value a pixel, shared by the pixel's threads.
// - In place. The result overwrites the convolution's output, which nothing
//   else reads; a thread reads each of its values before it writes it.
// - Arithmetic: the plain chain's, rounded where it rounds. PyTorch computes
//   each bf16 op in fp32 and rounds its result to bf16, so this kernel
//   rounds after every multiply, add, activation, gain and clamp, in the
//   plain chain's order, with bf16 vectors and fp32 scalars (alpha, gain)
//   as PyTorch holds them. From the same convolution output the two are
//   equal bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;     // channels a thread: one 16-byte slice of bf16
constexpr int kPixels = 4;  // pixels a thread

struct Params {
  __nv_bfloat16* y;             // [N, HW, C], the convolution's output, overwritten
  const __nv_bfloat16* dcoefs;  // [N, C] or null
  const __nv_bfloat16* noise;   // [N or 1, HW] or null
  const __nv_bfloat16* bias;    // [C] or null
  const __nv_bfloat16* styles;  // [N, C], the next convolution's input styles, or null
  int hw, c;
  int noise_per_sample;  // the noise has N rows (else one, shared)
  int lrelu;             // the activation: leaky ReLU (else linear)
  int has_gain, has_clamp;
  float alpha, gain, clamp;  // clamp: the bound as PyTorch holds it, rounded to bf16
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float bf16_at(const __nv_bfloat16* p) {
  return __uint_as_float(static_cast<uint32_t>(
                             __ldg(reinterpret_cast<const unsigned short*>(p)))
                         << 16);
}

__device__ __forceinline__ void unpack(uint4 r, float (&v)[kVec]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xFFFF0000u);
  }
}

__device__ __forceinline__ uint4 pack(const float (&v)[kVec]) {
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    w[k] = *reinterpret_cast<const uint32_t*>(&b);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// A thread's 8 channels of a per-channel vector, or `fill` without one.
__device__ __forceinline__ void load_vector(const __nv_bfloat16* p, float fill,
                                            float (&v)[kVec]) {
  if (p == nullptr) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) v[j] = fill;
  } else {
    unpack(__ldg(reinterpret_cast<const uint4*>(p)), v);
  }
}

// Grid: x over groups of blockDim.y * kPixels pixels, y over N. Block:
// x over a pixel's C / 8 channel slices, y over pixels.
__global__ void __launch_bounds__(kThreads) modconv_epilogue_kernel(const Params p) {
  const int n = blockIdx.y;
  const int c0 = threadIdx.x * kVec;
  float dcoef[kVec], bias[kVec], style[kVec];
  load_vector(p.dcoefs == nullptr ? nullptr : p.dcoefs + static_cast<size_t>(n) * p.c + c0,
              1.f, dcoef);
  load_vector(p.bias == nullptr ? nullptr : p.bias + c0, 0.f, bias);
  load_vector(p.styles == nullptr ? nullptr : p.styles + static_cast<size_t>(n) * p.c + c0,
              1.f, style);
  const __nv_bfloat16* noise =
      p.noise == nullptr ? nullptr
                         : p.noise + (p.noise_per_sample ? static_cast<size_t>(n) * p.hw : 0);
  const int first = blockIdx.x * blockDim.y * kPixels + threadIdx.y;
  const size_t base = static_cast<size_t>(n) * p.hw;
  uint4 raw[kPixels];
#pragma unroll
  for (int k = 0; k < kPixels; ++k) {
    const int pixel = first + k * blockDim.y;
    if (pixel < p.hw) {
      raw[k] = *reinterpret_cast<const uint4*>(p.y + (base + pixel) * p.c + c0);
    }
  }
#pragma unroll
  for (int k = 0; k < kPixels; ++k) {
    const int pixel = first + k * blockDim.y;
    if (pixel >= p.hw) continue;
    float v[kVec];
    unpack(raw[k], v);
    const float nz = noise == nullptr ? 0.f : bf16_at(noise + pixel);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      float x = v[j];
      if (p.dcoefs != nullptr) x = round_bf16(x * dcoef[j]);
      if (noise != nullptr) x = round_bf16(x + nz);
      if (p.bias != nullptr) x = round_bf16(x + bias[j]);
      if (p.lrelu) x = x > 0.f ? x : round_bf16(x * p.alpha);
      if (p.has_gain) x = round_bf16(x * p.gain);
      if (p.has_clamp && !(x != x)) x = fminf(fmaxf(x, -p.clamp), p.clamp);
      if (p.styles != nullptr) x = round_bf16(x * style[j]);
      v[j] = x;
    }
    *reinterpret_cast<uint4*>(p.y + (base + pixel) * p.c + c0) = pack(v);
  }
}

}  // namespace

// y[N, HW, C] = the epilogue of y[N, HW, C], in place (bf16, channels
// last, contiguous, 16-byte aligned). Every vector is bf16 and
// contiguous, or null: dcoefs [N, C], noise [N, HW] (noise_per_sample) or
// [HW], bias [C], styles [N, C]. C a multiple of 8 up to 2048, N at most
// 65535. lrelu: the activation (else linear) with slope alpha; the gain and
// the clamp (a bf16 value, as PyTorch rounds the bound) where has_gain and
// has_clamp. Returns the launch's CUDA error (0 on success).
extern "C" int modconv_epilogue_launch(void* y, const void* dcoefs,
                                       const void* noise, const void* bias, const void* styles,
                                       int n, int hw, int c, int noise_per_sample, int lrelu,
                                       float alpha, int has_gain, float gain, int has_clamp,
                                       float clamp, void* stream) {
  if (n < 1 || n > 65535 || hw < 1 || c < kVec || c % kVec || c > kVec * kThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{};
  p.y = static_cast<__nv_bfloat16*>(y);
  p.dcoefs = static_cast<const __nv_bfloat16*>(dcoefs);
  p.noise = static_cast<const __nv_bfloat16*>(noise);
  p.bias = static_cast<const __nv_bfloat16*>(bias);
  p.styles = static_cast<const __nv_bfloat16*>(styles);
  p.hw = hw;
  p.c = c;
  p.noise_per_sample = noise_per_sample;
  p.lrelu = lrelu;
  p.alpha = alpha;
  p.has_gain = has_gain;
  p.gain = gain;
  p.has_clamp = has_clamp;
  p.clamp = clamp;
  const dim3 block(c / kVec, kThreads / (c / kVec));
  const int per_block = block.y * kPixels;
  const dim3 grid((hw + per_block - 1) / per_block, n);
  modconv_epilogue_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
