// OSG tri-plane point decoder for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernel gnerf_tpu/ops/fused_decoder.py::fused_osg_decode.
// For features f[N, 3, M, C] (fp32 or bf16) and gain-folded weights
//   w1e[C, H] (feature dtype), b1e[H], w2e[H, D], b2e[D] (fp32)
// it writes out[N, M, D] (fp32):
//   h   = softplus((f0 . w1e + f1 . w1e + f2 . w1e) / 3 + b1e)
//   o   = h . w2e + b2e
//   out = [o_0 | sigmoid(o_1..) * 1.002 - 0.001]
//
// What bounds it. At the main-path shape (N = 1, M = 64*64*96, C = 32,
// H = 64, D = 33) the call reads 75.5 MB of bf16 features (151 MB in fp32)
// and writes 51.9 MB: ~38 us (bf16) or ~61 us (fp32) at 3.35 TB/s. Its
// products are ~6.5 GFLOP, ~7 us on the bf16 tensor cores. So it is bound by
// bytes, but only once the ~4,200 multiply-adds per point leave the CUDA
// cores: done there, one point per thread with every weight read from shared
// memory, they alone cost ~50 us of instruction issue. What is left on the
// CUDA cores and the special-function unit (192 ex2/lg2/rcp per point for 64
// softplus and 32 sigmoid, the fp16 split, the copy addressing) keeps this
// kernel above the byte bound.
//
// One kernel body (decode) serves both feature types; only layer 1 differs.
//  * Layer 1, bf16 features (the main path, osg_decode_tc), as the TPU kernel
//    does it: the three plane rows of a point are one A row of depth 3C
//    against B = [w1e; w1e; w1e], with mma.sync m16n8k16 bf16 x bf16 -> fp32
//    fed by ldmatrix. bf16 products are exact, so this is the TPU kernel's
//    three dots with fp32 sums. K is padded per plane to a multiple of 16
//    with zeros (C = 8 works).
//  * Layer 1, fp32 features (parity mode and the shape sweep,
//    osg_decode_tf32), in 3xTF32: the three planes' fragments are summed in
//    fp32 in registers (the plane mean folded ahead of one product of depth
//    C), the sum s is split into tf32 parts hi = rna(s), lo = rna(s - hi),
//    w1e likewise once per block, and hi.w_hi + hi.w_lo + lo.w_hi accumulate
//    in fp32 on mma.sync m16n8k8 tf32 (96 products per 16 points at C = 32,
//    twice the bf16 path's 48). ldmatrix .b16 on rows of fp32 hands each lane
//    the tf32 A fragment directly. hi + lo holds s to ~2^-24 and the dropped
//    lo.w_lo is ~2^-24 of a product; with the tensor cores' fp32 sums, which
//    do not round to nearest, 3xTF32 keeps ~21-22 bits where the TPU
//    kernel's fp32 dot keeps 24: within rtol 1e-4 of the fp32 plain
//    version. One TF32 pass keeps 11 bits and misses it. This is not the
//    TF32 mode that resolve_device turns off for torch's own fp32 products:
//    that one rounds each operand once. Both parts are rounded with cvt.rna:
//    an operand fed to mma unrounded is truncated to 10 mantissa bits. TF32
//    keeps fp32's exponent, so no range handling is needed here.
//    mma.sync, not wgmma, in both: the tensor work hides under the bytes
//    even at mma.sync's rate, a warp works alone on its 16 points (wgmma
//    would tie four warps together), and the m16n8 accumulator fragment
//    (rows g, g + 8, columns 2 t4, 2 t4 + 1 for k16 and k8 alike) is, in
//    registers, the A fragment of the next product.
//  * Bias and softplus on the accumulator fragments with ex2/lg2.approx, in
//    log2 units: y = x / ln 2, h / ln 2 = max(y, 0) + log2(1 + 2^-|y|), and
//    ln 2 is folded into w2e.
//  * Layer 2 on tensor cores in split fp16 for the rgb columns: h = h_hi +
//    h_lo and w2e * 2^s = w_hi + w_lo (fp16 parts, 2^s puts max|w2e| in
//    [2^14, 2^15)), summing h_hi.w_hi + h_hi.w_lo + h_lo.w_hi in fp32
//    (m16n8k16 f16). That keeps ~22 bits of h and w2e, where the TPU
//    kernel's fp32 dot keeps 24. A bf16 split keeps ~16 and misses rtol 1e-4
//    once features are large. A row whose largest h reaches 2^15 (beyond
//    fp16 once split) is scaled by a power of two first. Sigma, the one other
//    column, is an fp32 dot on the CUDA cores: an n8 tile of three products
//    for one column costs more.
//  * Each warp runs its own pipeline over warp tiles of 16 points: features
//    arrive by 16-byte cp.async copies into the warp's ring, swizzled so
//    that ldmatrix reads them without bank conflicts; rows past M and the k
//    padding are zero-filled by the copy itself. bf16: 3 KB tiles (C = 32)
//    in a ring of 3, 2 in flight while one is decoded, 16 warps per SM:
//    96 KB in flight. fp32: 6 KB tiles in a ring of 2, 1 in flight, 12
//    warps per SM: 72 KB in flight. Both are ~3-4x the ~25 KB per SM that
//    3.35 TB/s needs. The on-chip work of a tile is a long dependent chain,
//    so warps hide more than depth does: a third fp32 stage leaves room for
//    9 warps only, which is slower; so are 14 warps (the most that fit),
//    whose launch bounds leave ptxas 128 registers
//    (H100 readings in CHANGES.md). No
//    block-wide barrier follows the weight staging, so the
//    copies, the products and the special-function work of different warps
//    overlap. Persistent blocks, one per SM, walk over the tiles of all N.
//  * Each warp tile's output (16 * D fp32, contiguous in out) is staged in
//    shared memory and written with one cp.async.bulk, or with coalesced
//    stores where its size or address is not a multiple of 16 bytes.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxC = 64;  // feature width limit (multiple of 8)
constexpr int kMaxH = 64;  // hidden width limit; weights padded to this
constexpr int kMaxD = 64;  // output width limit

constexpr int kRows = 16;          // points per warp tile: one m16 fragment
constexpr int kLdW2 = kMaxH + 8;   // row stride of the layer-2 B tiles (halves)
constexpr float kHalfLimit = 32768.0f;  // h below this splits into fp16 safely

// What layer 1 differs in, by feature type.
template <bool kF32>
struct Features;
template <>
struct Features<false> {  // bf16: m16n8k16 bf16, K padded per plane to 16
  using T = uint16_t;
  static constexpr int kStep = 16;   // k per product
  static constexpr int kStages = 3;  // warp tiles in a warp's copy ring (2 in flight)
};
template <>
struct Features<true> {  // fp32: 3xTF32 on m16n8k8 tf32
  using T = float;
  static constexpr int kStep = 8;
  static constexpr int kStages = 2;  // 1 in flight: room for 12 warps, not 9
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                        uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_f16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rounded to tf32 (10 mantissa bits, nearest, ties away from zero), as
// fp32 bits with the low 13 bits zero.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lg2_approx(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// softplus(x) / ln 2 = max(y, 0) + log2(1 + 2^-|y|) for y = x / ln 2, on the
// special-function unit. The kernel carries h / ln 2 and folds ln 2 into w2e.
__device__ __forceinline__ float softplus_log2(float y) {
  return fmaxf(y, 0.0f) + lg2_approx(1.0f + ex2_approx(-fabsf(y)));
}

// (x, y) -> fp16 pairs hi = fp16(x, y) and lo = fp16((x, y) - hi), packed as
// an mma operand register (x in the low half).
__device__ __forceinline__ void split_f16x2(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __half2 h = __floats2half2_rn(x, y);
  const float2 f = __half22float2(h);
  const __half2 l = __floats2half2_rn(x - f.x, y - f.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// 16-byte chunk c of ring row r lives at chunk c ^ swizzle(r): for every even
// row size of 2 to 16 chunks (bf16 Cp = 16, 32, 48, 64; fp32 C = 8 ... 64),
// the 8 rows that one ldmatrix phase reads then fall into 8 different bank
// groups. Rows of 8 or 16 chunks start in the same group, so the chunk index
// takes all 8 values; rows of 4 or 12 start in 2 groups and it takes 4; rows
// of 2, 6, 10 or 14 start in 4 and it takes 2. The XOR stays inside the row.
__device__ __forceinline__ int swizzle(int r, int row_chunks) {
  return (row_chunks & 7) == 0 ? (r & 7) : (row_chunks & 3) == 0 ? ((r >> 1) & 3) : ((r >> 2) & 1);
}

// Shared memory of the decoder, in bytes from the dynamic base:
//   b1 [kMaxH] fp32                         b1e / ln 2, zero-padded
//   b2 [kMaxD + 8] fp32                     b2e, zero-padded
//   w2s [kMaxH] fp32                        sigma column w2e[:, 0] * ln 2
//   w2h, w2l [8 * nt2][kLdW2] fp16          hi / lo parts of (w2e[:, 1:] * ln 2 * 2^s)^T
//   w1: bf16 [kMaxH][Cp + 8]                w1e^T, zero-padded to Cp = 16 * ceil(C / 16)
//       fp32 [2][kMaxH][C + 4]              tf32 hi / lo parts of w1e^T, zero-padded
//   per warp: ring [stages][3][kRows][Cp] features (swizzled), out [kRows][D] fp32
// Each w1 row ends in one 16-byte chunk of padding, so that ldmatrix reads 8
// rows in 8 different bank groups.
struct TcLayout {
  int cp;
  size_t b2, w2s, w2h, w2l, w1, w1_row, warps, ring_stage, ring, per_warp;
  __host__ __device__ TcLayout(int C, int D, int nt2, bool f32, int stages) {
    const int kElem = f32 ? 4 : 2, kStep = f32 ? 8 : 16;
    cp = kStep * ((C + kStep - 1) / kStep);
    b2 = kMaxH * 4;
    w2s = b2 + (kMaxD + 8) * 4;
    w2h = w2s + kMaxH * 4;
    w2l = w2h + (size_t)8 * nt2 * kLdW2 * 2;
    w1 = w2l + (size_t)8 * nt2 * kLdW2 * 2;
    w1_row = (size_t)cp * kElem + 16;
    warps = w1 + (size_t)(f32 ? 2 : 1) * kMaxH * w1_row;
    ring_stage = (size_t)3 * kRows * cp * kElem;
    ring = stages * ring_stage;
    per_warp = ring + (size_t)kRows * D * 4;
  }
  size_t bytes(int n_warps) const { return warps + n_warps * per_warp; }
};

// The decoder for one block; kNT2 = rgb width D - 1 padded to n8 tiles (4
// for D <= 33, 8 for D <= 64).
template <bool kF32, int kNT2>
__device__ __forceinline__ void decode(
    unsigned char* smem, unsigned int* s_w2max,  // bits of max |w2e|
    const typename Features<kF32>::T* __restrict__ feats,
    const typename Features<kF32>::T* __restrict__ w1e, const float* __restrict__ b1e,
    const float* __restrict__ w2e, const float* __restrict__ b2e, float* __restrict__ out,
    int N, int M, int C, int H, int D) {
  using T = typename Features<kF32>::T;
  constexpr int kStep = Features<kF32>::kStep;
  constexpr int kStages = Features<kF32>::kStages;
  constexpr int kChunk = 16 / (int)sizeof(T);  // features per 16-byte chunk
  const TcLayout L(C, D, kNT2, kF32, kStages);
  const int cp = L.cp;
  const int kc = cp / kStep;              // k steps per plane, 2 chunks each
  const int row_chunks = cp / kChunk;     // 16-byte chunks per ring row
  const uint32_t plane_bytes = kRows * cp * sizeof(T);
  float* s_b1 = reinterpret_cast<float*>(smem);
  float* s_b2 = reinterpret_cast<float*>(smem + L.b2);
  float* s_w2s = reinterpret_cast<float*>(smem + L.w2s);
  __half* s_w2h = reinterpret_cast<__half*>(smem + L.w2h);
  __half* s_w2l = reinterpret_cast<__half*>(smem + L.w2l);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int n_warps = blockDim.x >> 5;
  unsigned char* warp_smem = smem + L.warps + warp * L.per_warp;
  const uint32_t ring = smem_addr(warp_smem);
  float* s_out = reinterpret_cast<float*>(warp_smem + L.ring);

  const int tiles_per_n = (M + kRows - 1) / kRows;
  const long long n_tiles = (long long)N * tiles_per_n;
  const long long tile0 = (long long)blockIdx.x * n_warps + warp;
  const long long tile_step = (long long)gridDim.x * n_warps;
  // A lane copies chunk c_lane of ring rows r_lane, r_lane + rows_per_pass, ...
  // of each plane (for 6, 10, 12 or 14 chunks per row, the last lanes copy
  // nothing).
  const int rows_per_pass = 32 / row_chunks;
  const int c_lane = lane % row_chunks, r_lane = lane / row_chunks;
  const bool lane_copies = r_lane < rows_per_pass;
  const bool lane_data = c_lane < C / kChunk;  // else a chunk of k padding (bf16 only)

  // Queues the copies of warp tile `tile` into ring slot `stage`: one commit
  // group per call (empty past the last tile, so the count stays uniform).
  // Rows past M and the k padding are zero-filled.
  auto issue = [&](long long tile, int stage) {
    if (tile < n_tiles && lane_copies) {
      const int n = (int)(tile / tiles_per_n);
      const int m0 = (int)(tile - (long long)n * tiles_per_n) * kRows;
      const int rows = min(kRows, M - m0);
      const uint32_t slot = ring + stage * (uint32_t)L.ring_stage;
      for (int p = 0; p < 3; ++p) {
        const T* plane = feats + (((size_t)n * 3 + p) * M + m0) * C + kChunk * c_lane;
        for (int r = r_lane; r < kRows; r += rows_per_pass) {
          const bool live = lane_data && r < rows;
          const uint32_t dst =
              slot + ((p * kRows + r) * row_chunks + (c_lane ^ swizzle(r, row_chunks))) * 16;
          cp_async16(dst, live ? plane + r * C : feats, live ? 16 : 0);
        }
      }
    }
    cp_async_commit();
  };

  for (int s = 0; s < kStages - 1; ++s) issue(tile0 + s * tile_step, s);

  // Weights, once per block. w1 rows are hidden units n, columns k.
  if (tid == 0) *s_w2max = 0u;
  if constexpr (kF32) {
    float* s_w1h = reinterpret_cast<float*>(smem + L.w1);
    float* s_w1l = reinterpret_cast<float*>(smem + L.w1 + kMaxH * L.w1_row);
    const int ld = (int)(L.w1_row / 4);
    for (int i = tid; i < kMaxH * cp; i += blockDim.x) {
      const int n = i / cp, k = i - n * cp;
      const float w = (n < H && k < C) ? w1e[k * H + n] : 0.0f;
      const uint32_t hi = tf32_rna(w);
      s_w1h[n * ld + k] = __uint_as_float(hi);
      s_w1l[n * ld + k] = __uint_as_float(tf32_rna(w - __uint_as_float(hi)));
    }
  } else {
    uint16_t* s_w1 = reinterpret_cast<uint16_t*>(smem + L.w1);
    const int ld = (int)(L.w1_row / 2);
    for (int i = tid; i < kMaxH * cp; i += blockDim.x) {
      const int n = i / cp, k = i - n * cp;
      s_w1[n * ld + k] = (n < H && k < C) ? w1e[k * H + n] : (uint16_t)0;
    }
  }
  for (int i = tid; i < kMaxH; i += blockDim.x) {
    s_b1[i] = i < H ? b1e[i] * kLog2e : 0.0f;
    s_w2s[i] = i < H ? w2e[i * D] * kLn2 : 0.0f;
  }
  for (int i = tid; i < kMaxD + 8; i += blockDim.x) s_b2[i] = i < D ? b2e[i] : 0.0f;
  float wmax = 0.0f;
  for (int i = tid; i < H * D; i += blockDim.x) wmax = fmaxf(wmax, fabsf(w2e[i]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) wmax = fmaxf(wmax, __shfl_xor_sync(0xffffffffu, wmax, o));
  __syncthreads();  // s_w2max is zero
  if (lane == 0) atomicMax(s_w2max, __float_as_uint(wmax));
  __syncthreads();
  int w2exp;
  frexpf(__uint_as_float(*s_w2max), &w2exp);  // max |w2e| < 2^w2exp
  const float w2scale = ldexpf(1.0f, 15 - w2exp);
  const float w2unscale = ldexpf(1.0f, w2exp - 15);
  for (int i = tid; i < 8 * kNT2 * kMaxH; i += blockDim.x) {
    const int n = i / kMaxH, k = i - n * kMaxH;
    const float w = (n + 1 < D && k < H) ? w2e[k * D + n + 1] * kLn2 * w2scale : 0.0f;
    const __half hi = __float2half_rn(w);
    s_w2h[n * kLdW2 + k] = hi;
    s_w2l[n * kLdW2 + k] = __float2half_rn(w - __half2float(hi));
  }
  __syncthreads();

  const int g = lane >> 2, t4 = lane & 3;  // mma fragment row group, column pair
  float b1r[8][2], b2r[kNT2][2];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    b1r[j][0] = s_b1[8 * j + 2 * t4];
    b1r[j][1] = s_b1[8 * j + 2 * t4 + 1];
  }
#pragma unroll
  for (int j = 0; j < kNT2; ++j) {
    b2r[j][0] = s_b2[1 + 8 * j + 2 * t4];
    b2r[j][1] = s_b2[2 + 8 * j + 2 * t4];
  }
  const float b2_sigma = s_b2[0];
  // ldmatrix row addresses, per lane. A: ring row (lane & 15) of each plane,
  // chunk (lane >> 4) of the k step (bf16 k 0-7 / 8-15, fp32 k 0-3 / 4-7).
  // w1, bf16: n rows 8 * (lane >> 4) + (lane & 7), k half (lane >> 3) & 1
  // (two n8 tiles). w1, fp32: hi for lanes 0-15, lo for 16-31, n rows
  // lane & 7, k half (lane >> 3) & 1 (one n8 tile, both parts). w2: hi for
  // lanes 0-15, lo for 16-31, n rows lane & 7, k half (lane >> 3) & 1.
  const int a_row = lane & 15, a_half = lane >> 4;
  const int a_swz = swizzle(a_row, row_chunks);
  const uint32_t w1_lane =
      kF32 ? smem_addr(smem + L.w1 + (lane >> 4) * kMaxH * L.w1_row) +
                 (lane & 7) * (uint32_t)L.w1_row + ((lane >> 3) & 1) * 16
           : smem_addr(smem + L.w1) + (8 * (lane >> 4) + (lane & 7)) * (uint32_t)L.w1_row +
                 ((lane >> 3) & 1) * 16;
  const uint32_t w2_lane = smem_addr(lane < 16 ? s_w2h : s_w2l) +
                           ((lane & 7) * kLdW2 + ((lane >> 3) & 1) * 8) * 2;
  const uint32_t out_smem = smem_addr(s_out);

  int stage = 0;
  for (long long tile = tile0; tile < n_tiles; tile += tile_step) {
    cp_async_wait<kStages - 2>();  // this lane's copies of `tile` landed
    __syncwarp();                  // everyone's did; the oldest slot is free
    issue(tile + (kStages - 1) * tile_step, (stage + kStages - 1) % kStages);

    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
    const uint32_t a_slot = ring + stage * (uint32_t)L.ring_stage + a_row * cp * sizeof(T);
#pragma unroll
    for (int ks = 0; ks < kMaxC / kStep; ++ks) {
      if (ks < kc) {
        const uint32_t a_chunk = ((2 * ks + a_half) ^ a_swz) * 16;
        if constexpr (kF32) {
          // Layer 1 in 3xTF32: [16 x C] . [C x 64] on the plane sum.
          uint32_t a[3][4], ah[4], al[4];
#pragma unroll
          for (int p = 0; p < 3; ++p)
            ldsm_x4(a_slot + p * plane_bytes + a_chunk, a[p][0], a[p][1], a[p][2], a[p][3]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float s = (__uint_as_float(a[0][i]) + __uint_as_float(a[1][i])) +
                            __uint_as_float(a[2][i]);
            ah[i] = tf32_rna(s);
            al[i] = tf32_rna(s - __uint_as_float(ah[i]));
          }
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            uint32_t bh0, bh1, bl0, bl1;
            ldsm_x4(w1_lane + 8 * j * (uint32_t)L.w1_row + 32 * ks, bh0, bh1, bl0, bl1);
            mma_tf32(acc[j], ah, bl0, bl1);
            mma_tf32(acc[j], al, bh0, bh1);
            mma_tf32(acc[j], ah, bh0, bh1);
          }
        } else {
          // Layer 1 in bf16: [16 x 3Cp] . [3Cp x 64], each k step of w1
          // reused for 3 planes.
          uint32_t b[8][2];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            ldsm_x4(w1_lane + 16 * jj * (uint32_t)L.w1_row + 32 * ks, b[2 * jj][0],
                    b[2 * jj][1], b[2 * jj + 1][0], b[2 * jj + 1][1]);
#pragma unroll
          for (int p = 0; p < 3; ++p) {
            uint32_t a[4];
            ldsm_x4(a_slot + p * plane_bytes + a_chunk, a[0], a[1], a[2], a[3]);
#pragma unroll
            for (int j = 0; j < 8; ++j) mma_bf16(acc[j], a, b[j][0], b[j][1]);
          }
        }
      }
    }

    // Bias, softplus (h / ln 2), and sigma = h . w2e[:, 0] in fp32 on the
    // CUDA cores: one output column is not worth an n8 tile of three
    // products. acc[j][e] is row g + 8 * (e >> 1), hidden unit
    // 8 * j + 2 * t4 + (e & 1).
    float hmax = 0.0f, sigma[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 ws = *reinterpret_cast<const float2*>(s_w2s + 8 * j + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[j][e] = softplus_log2(fmaf(acc[j][e], kLog2e / 3.0f, b1r[j][e & 1]));
        sigma[e >> 1] = fmaf(acc[j][e], (e & 1) ? ws.y : ws.x, sigma[e >> 1]);
        hmax = fmaxf(hmax, acc[j][e]);
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      sigma[half] += __shfl_xor_sync(0xffffffffu, sigma[half], 1);
      sigma[half] += __shfl_xor_sync(0xffffffffu, sigma[half], 2);
    }
    // A row whose largest h reaches 2^15 is scaled by 2^-k into fp16 range,
    // and its outputs by 2^k (exact powers of two).
    float row_scale[2] = {w2unscale, w2unscale};
    if (__any_sync(0xffffffffu, hmax >= kHalfLimit)) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float rmax = 0.0f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          rmax = fmaxf(rmax, fmaxf(acc[j][2 * half], acc[j][2 * half + 1]));
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 1));
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 2));
        int e;
        frexpf(rmax, &e);  // rmax < 2^e
        const int k = max(e - 15, 0);
        const float down = ldexpf(1.0f, -k);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[j][2 * half] *= down;
          acc[j][2 * half + 1] *= down;
        }
        row_scale[half] = ldexpf(w2unscale, k);
      }
    }

    // Layer 2: the accumulator fragments of hidden units 16 kk .. 16 kk + 15
    // are the A fragment of k step kk. Split fp16: hi.hi + hi.lo + lo.hi.
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      split_f16x2(acc[2 * kk][0], acc[2 * kk][1], ah[kk][0], al[kk][0]);
      split_f16x2(acc[2 * kk][2], acc[2 * kk][3], ah[kk][1], al[kk][1]);
      split_f16x2(acc[2 * kk + 1][0], acc[2 * kk + 1][1], ah[kk][2], al[kk][2]);
      split_f16x2(acc[2 * kk + 1][2], acc[2 * kk + 1][3], ah[kk][3], al[kk][3]);
    }
    float o[kNT2][4];
#pragma unroll
    for (int j = 0; j < kNT2; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < kNT2; ++j) {
        uint32_t bh0, bh1, bl0, bl1;
        ldsm_x4(w2_lane + (8 * j * kLdW2 + 16 * kk) * 2, bh0, bh1, bl0, bl1);
        mma_f16(o[j], ah[kk], bh0, bh1);
        mma_f16(o[j], ah[kk], bl0, bl1);
        mma_f16(o[j], al[kk], bh0, bh1);
      }

    // Epilogue into the warp's staging tile: [sigma | sigmoid(o) * 1.002 - 0.001].
    if (lane == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    __syncwarp();  // the previous tile's store has read the staging tile
    if (t4 == 0) {
      s_out[g * D] = sigma[0] + b2_sigma;
      s_out[(g + 8) * D] = sigma[1] + b2_sigma;
    }
#pragma unroll
    for (int j = 0; j < kNT2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 1 + 8 * j + 2 * t4 + (e & 1);
        const float v = fmaf(o[j][e], row_scale[e >> 1], b2r[j][e & 1]);
        const float rgb =
            (1.0f + 2.0f * 0.001f) * rcp_approx(1.0f + ex2_approx(-v * kLog2e)) - 0.001f;
        if (col < D) s_out[(g + 8 * (e >> 1)) * D + col] = rgb;
      }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for the bulk copy
    __syncwarp();
    const int n = (int)(tile / tiles_per_n);
    const int m0 = (int)(tile - (long long)n * tiles_per_n) * kRows;
    const int rows = min(kRows, M - m0);
    float* dst = out + ((size_t)n * M + m0) * D;
    const uint32_t bytes = (uint32_t)rows * D * 4;
    if ((bytes & 15) == 0 && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
      if (lane == 0) {
        asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
                     :: "l"(dst), "r"(out_smem), "r"(bytes) : "memory");
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    } else {
      for (int i = lane; i < rows * D; i += 32) dst[i] = s_out[i];
    }
    stage = (stage + 1) % kStages;
  }
  cp_async_wait<0>();
  if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// The two kernels, one per feature type; kMaxWarps bounds the block so that
// the registers fit.
template <int kNT2, int kMaxWarps>
__global__ void __launch_bounds__(32 * kMaxWarps, 1)
osg_decode_tc(const uint16_t* __restrict__ feats, const uint16_t* __restrict__ w1e,
              const float* __restrict__ b1e, const float* __restrict__ w2e,
              const float* __restrict__ b2e, float* __restrict__ out,
              int N, int M, int C, int H, int D) {
  extern __shared__ __align__(128) unsigned char smem_tc[];
  __shared__ unsigned int s_w2max;
  decode<false, kNT2>(smem_tc, &s_w2max, feats, w1e, b1e, w2e, b2e, out, N, M, C, H, D);
}

template <int kNT2, int kMaxWarps>
__global__ void __launch_bounds__(32 * kMaxWarps, 1)
osg_decode_tf32(const float* __restrict__ feats, const float* __restrict__ w1e,
                const float* __restrict__ b1e, const float* __restrict__ w2e,
                const float* __restrict__ b2e, float* __restrict__ out,
                int N, int M, int C, int H, int D) {
  extern __shared__ __align__(128) unsigned char smem_tc[];
  __shared__ unsigned int s_w2max;
  decode<true, kNT2>(smem_tc, &s_w2max, feats, w1e, b1e, w2e, b2e, out, N, M, C, H, D);
}

template <bool kF32, int kNT2, int kMaxWarps>
auto decode_kernel() {
  if constexpr (kF32) return osg_decode_tf32<kNT2, kMaxWarps>;
  else return osg_decode_tc<kNT2, kMaxWarps>;
}

// Launches the kernel with as many warps per block as shared memory and
// kMaxWarps allow, one block per SM (or fewer, for few tiles).
template <bool kF32, int kNT2, int kMaxWarps>
cudaError_t launch_tc(const void* feats, const void* w1e, const void* b1e, const void* w2e,
                      const void* b2e, void* out, int N, int M, int C, int H, int D,
                      cudaStream_t stream) {
  using T = typename Features<kF32>::T;
  auto kernel = decode_kernel<kF32, kNT2, kMaxWarps>();
  const TcLayout layout(C, D, kNT2, kF32, Features<kF32>::kStages);
  int device = 0, sms = 0, optin = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  const size_t room = (size_t)optin - attr.sharedSizeBytes;
  int warps = room > layout.warps ? (int)((room - layout.warps) / layout.per_warp) : 0;
  if (warps > kMaxWarps) warps = kMaxWarps;
  if (warps < 1) return cudaErrorInvalidConfiguration;
  const size_t smem = layout.bytes(warps);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * warps, smem);
  if (err != cudaSuccess) return err;
  const long long n_tiles = (long long)N * ((M + kRows - 1) / kRows);
  const long long wanted = (n_tiles + warps - 1) / warps;
  const long long resident = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  const int blocks = (int)(wanted < resident ? wanted : resident);
  kernel<<<blocks, 32 * warps, smem, stream>>>(
      static_cast<const T*>(feats), static_cast<const T*>(w1e),
      static_cast<const float*>(b1e), static_cast<const float*>(w2e),
      static_cast<const float*>(b2e), static_cast<float*>(out), N, M, C, H, D);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (feats_bf16) {
    return (int)(D <= 33
        ? launch_tc<false, 4, 16>(feats, w1e, b1e, w2e, b2e, out, N, M, C, H, D, s)
        : launch_tc<false, 8, 8>(feats, w1e, b1e, w2e, b2e, out, N, M, C, H, D, s));
  }
  return (int)(D <= 33 ? launch_tc<true, 4, 12>(feats, w1e, b1e, w2e, b2e, out, N, M, C, H, D, s)
                       : launch_tc<true, 8, 8>(feats, w1e, b1e, w2e, b2e, out, N, M, C, H, D, s));
}

}  // extern "C"
