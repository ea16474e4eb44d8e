// Draws of jax.random's partitionable threefry key stream: for a table of up
// to 32 draws, each a key and the counters of a draw's shape or of a block
// of it (a rank's part), the words, or the float32 uniform and normal
// values made from them, in one launch.
//
// Not a TPU kernel: JAX leaves threefry to XLA, which fuses its rounds into
// one loop. In the port the same words were ~170 int64 elementwise launches
// per draw (`ops/threefry.py::threefry2x32`, the plain version), and a
// normal draw ~80 more for its float steps. Value j of a draw is
// threefry2x32(key, (hi32(i), lo32(i))) with i the flat index of the
// block's j-th element in the whole draw: 20 rounds of add / rotate / xor in
// uint32 registers, then 4 bytes per value (the xor of the two words, as
// `bits` takes it, or a float32 uniform or normal value) or 8 (both words,
// for `split` / `fold_in`).
//
// The float steps are the plain version's, rounded alike: uniform puts the
// top 23 bits in a float's mantissa in [1, 2), takes 1 away and computes
// max(lo, f * (hi - lo) + lo) with one rounding (an FMA, as XLA contracts
// it); normal is sqrt(2) * erfinv(uniform(-1 + ulp, 1)) with XLA's erfinv
// polynomial, each Horner step one FMA, log1pf and sqrtf from CUDA's math
// library as torch's CUDA ops call them (the CPU's log1p may differ from
// CUDA's in the last place: normal draws agree within 1e-6).
//
// What bounds it on an H100: per value at least 68 32-bit integer
// instructions (2 key adds, 20 rounds of add / funnel-shift / xor, 5 key
// injections, the output xor; a normal value adds ~40 float operations),
// against 4 bytes written. The 20 funnel shifts and 21 xors run only on the
// ALU pipe, 64 lanes an SM: at 132 SMs x 1.98 GHz ~2.6 us per 2^20 values,
// against ~1.25 us of writes at 3.35 TB/s. So the kernel is bound by its ALU
// operations, in registers, and a step's draws (2^16 - 2^20 values, most far
// fewer) by their launch. What the design does about it:
// - 32-bit indexing. The host collapses every dimension a block takes whole
//   into its outer neighbour and folds those of size 1 into the block's
//   first counter, so a data-rank block is one offset plus j and a ray-rank
//   block two dimensions. The kernel maps j to i with a multiply-high
//   divisor per inner dimension (Granlund and Montgomery's round-up method,
//   exact for every 32-bit j: `__umulhi`, an add, two shifts): no 64-bit
//   division or modulo per value. A draw whose counters reach 2^32, or
//   whose block keeps more than 4 dimensions, takes the 64-bit instance
//   (`Wide`: plain 64-bit / and %); no draw of the training steps does.
// - Four values a thread. Each thread runs the four counters' chains
//   interleaved (four independent add / rotate / xor chains hide the ALU
//   pipe's latency with a quarter of the warps) and writes them with one
//   16-byte store (two for pairs); the draw's last n % 4 values, or an
//   output that is not 16-byte aligned, take 4-byte stores.
// - One launch for a table of draws. An entry holds its key, kind, lo /
//   span and geometry; the host gives each entry ceil(n / 1024) blocks of
//   256 threads, at most one wave of the card (132 SMs x 8 blocks; a larger
//   entry loops over its values), and the prefix of those counts; a block
//   finds its entry by scanning the prefix. The table is a by-value kernel
//   parameter (`__grid_constant__`, read in place), 3,720 bytes for 32
//   entries, inside the 4 KB parameter limit.
//
// A key arrives either as two 32-bit words (a key on the host) or as a
// pointer to the key tensor's two int64 words on the card.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr uint32_t kParity = 0x1BD11BDAu;
constexpr int kThreads = 256;
constexpr int kValues = 4;        // values a thread computes per loop trip
constexpr int kMaxEntries = 32;   // draws of one launch (`Narrow` table)

enum Kind { kBits = 0, kPairs = 1, kUniform = 2, kNormal = 3 };

// One draw of a table. `I` holds the counters: uint32 for every draw whose
// counters stay below 2^32, uint64 beyond. The block's value j has the
// counter base + sum_d c_d * stride[d], with (c_0, .., c_{ndim-1}) the
// row-major coordinates of j in the block's sizes (innermost last); magic /
// shift divide by size[d] for d >= 1.
template <typename I, int kDims>
struct Entry {
  using Index = I;
  void* out;
  const int64_t* key;  // the key's words on the card, or null: k0 and k1
  uint32_t k0, k1;
  float lo, span;      // a float draw's [lo, lo + span)
  int32_t kind, ndim;
  I n, base;
  I size[kDims], stride[kDims];
  uint32_t magic[kDims], shift[kDims];
};

using Narrow = Entry<uint32_t, 4>;
using Wide = Entry<uint64_t, 8>;

template <class E, int kEntries>
struct Table {
  int32_t count;
  uint32_t first[kEntries + 1];  // entry k's blocks are [first[k], first[k + 1])
  E e[kEntries];
};

using NarrowTable = Table<Narrow, kMaxEntries>;
using WideTable = Table<Wide, 1>;

// The layout `ops/threefry.py` packs.
static_assert(sizeof(Narrow) == 112 && sizeof(Wide) == 248, "entry layout");
static_assert(offsetof(NarrowTable, e) == 136 && offsetof(WideTable, e) == 16, "table layout");
static_assert(sizeof(NarrowTable) <= 4096, "kernel parameter limit");

__device__ __forceinline__ uint32_t counter(const Narrow& e, uint32_t j) {
  uint32_t i = e.base;
  for (int d = e.ndim - 1; d > 0; --d) {
    const uint32_t t = __umulhi(j, e.magic[d]);
    const uint32_t q = (t + ((j - t) >> 1)) >> e.shift[d];
    i += (j - q * e.size[d]) * e.stride[d];
    j = q;
  }
  return i + j * e.stride[0];
}

__device__ __forceinline__ uint64_t counter(const Wide& e, uint64_t j) {
  uint64_t i = e.base;
  for (int d = e.ndim - 1; d > 0; --d) {
    i += (j % e.size[d]) * e.stride[d];
    j /= e.size[d];
  }
  return i + j * e.stride[0];
}

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// threefry2x32 of kValues counters at once, their rounds interleaved.
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1, uint32_t (&x0)[kValues],
                                         uint32_t (&x1)[kValues]) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ kParity};
  constexpr int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
#pragma unroll
  for (int v = 0; v < kValues; ++v) {
    x0[v] += ks[0];
    x1[v] += ks[1];
  }
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int v = 0; v < kValues; ++v) {
        x0[v] += x1[v];
        x1[v] = rotl(x1[v], rot[i % 2][j]) ^ x0[v];
      }
    }
#pragma unroll
    for (int v = 0; v < kValues; ++v) {
      x0[v] += ks[(i + 1) % 3];
      x1[v] += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
    }
  }
}

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

// Values j0 .. j0 + 3 of an entry (those below n): kBits out[j] = x0 ^ x1;
// kPairs out[2j] = x0, out[2j + 1] = x1; kUniform / kNormal out[j] the
// float32 value of x0 ^ x1. 16-byte stores where all four are in the draw
// and the output is 16-byte aligned.
template <class E, typename I>
__device__ __forceinline__ void store(const E& e, I j0, I n, const uint32_t (&x0)[kValues],
                                      const uint32_t (&x1)[kValues]) {
  const bool whole = n - j0 >= kValues && (reinterpret_cast<uintptr_t>(e.out) & 15) == 0;
  if (e.kind == kPairs) {
    uint32_t* o = static_cast<uint32_t*>(e.out) + 2 * static_cast<size_t>(j0);
    if (whole) {
      reinterpret_cast<uint4*>(o)[0] = make_uint4(x0[0], x1[0], x0[1], x1[1]);
      reinterpret_cast<uint4*>(o)[1] = make_uint4(x0[2], x1[2], x0[3], x1[3]);
    } else {
      for (int v = 0; v < kValues && j0 + v < n; ++v) {
        o[2 * v] = x0[v];
        o[2 * v + 1] = x1[v];
      }
    }
    return;
  }
  uint32_t w[kValues];
#pragma unroll
  for (int v = 0; v < kValues; ++v) {
    w[v] = x0[v] ^ x1[v];
    if (e.kind == kUniform) {
      w[v] = __float_as_uint(uniform(w[v], e.lo, e.span));
    } else if (e.kind == kNormal) {
      w[v] = __float_as_uint(__fmul_rn(1.41421354f, erfinv(uniform(w[v], e.lo, e.span))));
    }
  }
  uint32_t* o = static_cast<uint32_t*>(e.out) + j0;
  if (whole) {
    *reinterpret_cast<uint4*>(o) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    for (int v = 0; v < kValues && j0 + v < n; ++v) o[v] = w[v];
  }
}

template <class E, int kEntries>
__global__ void __launch_bounds__(kThreads, 8)
    threefry_table(const __grid_constant__ Table<E, kEntries> t) {
  using I = typename E::Index;
  int k = 0;
  while (k + 1 < t.count && blockIdx.x >= t.first[k + 1]) ++k;
  const E& e = t.e[k];
  uint32_t k0 = e.k0, k1 = e.k1;
  if (e.key != nullptr) {
    k0 = static_cast<uint32_t>(e.key[0]);
    k1 = static_cast<uint32_t>(e.key[1]);
  }
  const I n = e.n;
  const I quads = n / kValues + (n % kValues != 0);
  const I step = static_cast<I>(t.first[k + 1] - t.first[k]) * kThreads;
  for (I q = static_cast<I>(blockIdx.x - t.first[k]) * kThreads + threadIdx.x; q < quads;
       q += step) {
    const I j0 = q * kValues;
    uint32_t x0[kValues], x1[kValues];
#pragma unroll
    for (int v = 0; v < kValues; ++v) {
      const uint64_t i = counter(e, j0 + v < n ? j0 + v : n - 1);
      x0[v] = static_cast<uint32_t>(i >> 32);
      x1[v] = static_cast<uint32_t>(i);
    }
    threefry(k0, k1, x0, x1);
    store(e, j0, n, x0, x1);
  }
}

template <class E, int kEntries>
int launch(const void* table, cudaStream_t stream) {
  using T = Table<E, kEntries>;
  T t;
  memcpy(&t, table, offsetof(T, e));
  if (t.count < 1 || t.count > kEntries || t.first[0] != 0 || t.first[t.count] == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  memcpy(t.e, static_cast<const char*>(table) + offsetof(T, e), t.count * sizeof(E));
  threefry_table<E, kEntries><<<t.first[t.count], kThreads, 0, stream>>>(t);
  return static_cast<int>(cudaGetLastError());
}

__global__ void empty_kernel() {}

}  // namespace

// `table`: a Table of `Narrow` entries (wide = 0, up to 32) or one `Wide`
// entry (wide = 1), as `ops/threefry.py` packs it. kind: 0 bits, 1 pairs,
// 2 uniform in [lo, lo + span), 3 normal (lo and span those of its uniform
// draw). The grid is the table's block prefix.
extern "C" int threefry_launch(const void* table, int wide, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return wide ? launch<Wide, 1>(table, s) : launch<Narrow, kMaxEntries>(table, s);
}

// An empty kernel of `blocks` x 256 threads: the floor of a launch's device
// time, which the measurements put beside the draws'.
extern "C" int threefry_empty_launch(int blocks, void* stream) {
  empty_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
