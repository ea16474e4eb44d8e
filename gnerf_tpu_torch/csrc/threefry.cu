// Draws of jax.random's partitionable threefry key stream, for a key and the
// counters of a draw's shape, or of a block of it (a rank's part): the
// words, or the float32 uniform and normal values made from them.
//
// Not a TPU kernel: JAX leaves threefry to XLA, which fuses its rounds into
// one loop. In the port the same words were ~170 int64 elementwise launches
// per draw (`ops/threefry.py::threefry2x32`, the plain version), each
// reading and writing 8-byte words, and a normal draw ~80 more for its
// float steps; a training step makes dozens of draws, most of them small,
// where those launches held the card waiting on the host. This kernel
// computes element i from i alone: threefry2x32(key, (hi32(i), lo32(i))),
// 20 rounds of add / rotate / xor in uint32 registers, then writes, in one
// launch, 4 bytes per element (the xor of the two words, as `bits` takes
// it; or a float32 uniform or normal value) or 8 (both words, for `split` /
// `fold_in`).
//
// The float steps are the plain version's, rounded alike: uniform puts the
// top 23 bits in a float's mantissa in [1, 2), takes 1 away and computes
// max(lo, f * (hi - lo) + lo) with one rounding (an FMA, as XLA contracts
// it); normal is sqrt(2) * erfinv(uniform(-1 + ulp, 1)) with XLA's erfinv
// polynomial, each Horner step one FMA, log1pf and sqrtf from CUDA's math
// library as torch's CUDA ops call them (the CPU's log1p may differ from
// CUDA's in the last place: normal draws agree within 1e-6).
//
// What bounds it on an H100: per element at least 68 32-bit integer
// instructions (2 key adds, 20 rounds of add / funnel-shift / xor, 5 key
// injections into x1, those into x0 folded into three-input adds, the output
// xor; a normal value adds ~30 float operations and a log1pf), plus the
// block-to-flat index mapping (64-bit div / mod per dimension when a block
// is asked for), against 4 bytes written. Of those, the 20 funnel shifts and
// 21 xors can only run on the ALU pipe, 64 lanes an SM; the adds may also
// issue on the FMA pipe. At 132 SMs x 1.98 GHz the ALU pipe's 41 take ~2.6
// us per 2^20 elements, all 68 at the issue rate (128 an SM a clock) ~2.1
// us, and the writes ~1.25 us at 3.35 TB/s: the kernel is bound by its ALU
// operations, in registers, with no shared memory and no tensor cores. Most
// draws of a step are small (N x 1 x r x r noise for r = 4 .. 256, ADA's
// per-sample parameters), where the launch itself is the cost.
//
// The key arrives either as two 32-bit words (a key on the host) or as a
// pointer to the key tensor's two int64 words on the card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxDims = 8;
constexpr uint32_t kParity = 0x1BD11BDAu;

struct Block {
  int ndim;                 // 0: the whole draw, element i at counter i
  int64_t size[kMaxDims];   // the block's sizes
  int64_t start[kMaxDims];  // its first index in each dimension of the draw
  int64_t stride[kMaxDims]; // the draw's row-major strides
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1, uint32_t& x0,
                                         uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ kParity};
  constexpr int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
}

__device__ __forceinline__ int64_t counter(int64_t j, const Block& b) {
  if (b.ndim == 0) return j;
  int64_t idx = 0;
#pragma unroll 1
  for (int d = b.ndim - 1; d >= 0; --d) {
    const int64_t c = j % b.size[d];
    j /= b.size[d];
    idx += (b.start[d] + c) * b.stride[d];
  }
  return idx;
}

enum Kind { kBits = 0, kPairs = 1, kUniform = 2, kNormal = 3 };

__device__ __forceinline__ float uniform(uint32_t bits, float lo, float span) {
  const float f = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
  return fmaxf(lo, __fmaf_rn(f, span, lo));
}

// XLA's single-precision erfinv (ErfInv32): a degree-8 polynomial in w - 2.5
// for w = -log1p(-x^2) < 5, in sqrt(w) - 3 beyond.
__device__ __forceinline__ float erfinv(float x) {
  constexpr float kSmall[9] = {2.81022636e-08f, 3.43273939e-07f, -3.5233877e-06f,
                               -4.39150654e-06f, 0.00021858087f, -0.00125372503f,
                               -0.00417768164f, 0.246640727f, 1.50140941f};
  constexpr float kLarge[9] = {-0.000200214257f, 0.000100950558f, 0.00134934322f,
                               -0.00367342844f, 0.00573950773f, -0.0076224613f,
                               0.00943887047f, 1.00167406f, 2.83297682f};
  float w = -log1pf(-__fmul_rn(x, x));
  const bool small = w < 5.0f;
  w = small ? __fsub_rn(w, 2.5f) : __fsub_rn(sqrtf(w), 3.0f);
  float p = small ? kSmall[0] : kLarge[0];
#pragma unroll
  for (int k = 1; k < 9; ++k) p = __fmaf_rn(p, w, small ? kSmall[k] : kLarge[k]);
  return __fmul_rn(p, x);
}

// kBits: out[j] = x0 ^ x1; kPairs: out[2j] = x0, out[2j + 1] = x1; kUniform /
// kNormal: out[j] the float32 value of x0 ^ x1.
template <int kKind>
__global__ void __launch_bounds__(256) threefry_words(uint32_t k0, uint32_t k1,
                                                      const int64_t* __restrict__ key,
                                                      Block b, int64_t n, float lo,
                                                      float span, void* __restrict__ out) {
  if (key != nullptr) {
    k0 = static_cast<uint32_t>(key[0]);
    k1 = static_cast<uint32_t>(key[1]);
  }
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; j < n;
       j += step) {
    const int64_t i = counter(j, b);
    uint32_t x0 = static_cast<uint32_t>(static_cast<uint64_t>(i) >> 32);
    uint32_t x1 = static_cast<uint32_t>(i);
    threefry(k0, k1, x0, x1);
    if (kKind == kPairs) {
      static_cast<uint2*>(out)[j] = make_uint2(x0, x1);
    } else if (kKind == kBits) {
      static_cast<uint32_t*>(out)[j] = x0 ^ x1;
    } else if (kKind == kUniform) {
      static_cast<float*>(out)[j] = uniform(x0 ^ x1, lo, span);
    } else {
      static_cast<float*>(out)[j] = __fmul_rn(1.41421354f, erfinv(uniform(x0 ^ x1, lo, span)));
    }
  }
}

}  // namespace

// kind: 0 bits, 1 pairs, 2 uniform in [lo, lo + span), 3 normal (lo and
// span those of its uniform draw).
extern "C" int threefry_launch(uint32_t k0, uint32_t k1, const void* key, int ndim,
                               const int64_t* size, const int64_t* start,
                               const int64_t* stride, int64_t n, int kind, float lo,
                               float span, void* out, void* stream) {
  if (ndim < 0 || ndim > kMaxDims) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  Block b{};
  b.ndim = ndim;
  for (int d = 0; d < ndim; ++d) {
    b.size[d] = size[d];
    b.start[d] = start[d];
    b.stride[d] = stride[d];
  }
  const int threads = 256;
  const int64_t want = (n + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 132 * 32 ? want : 132 * 32);
  auto s = static_cast<cudaStream_t>(stream);
  auto k = static_cast<const int64_t*>(key);
  switch (kind) {
    case kBits:
      threefry_words<kBits><<<blocks, threads, 0, s>>>(k0, k1, k, b, n, lo, span, out);
      break;
    case kPairs:
      threefry_words<kPairs><<<blocks, threads, 0, s>>>(k0, k1, k, b, n, lo, span, out);
      break;
    case kUniform:
      threefry_words<kUniform><<<blocks, threads, 0, s>>>(k0, k1, k, b, n, lo, span, out);
      break;
    case kNormal:
      threefry_words<kNormal><<<blocks, threads, 0, s>>>(k0, k1, k, b, n, lo, span, out);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
