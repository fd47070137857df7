// What the two tensor-core GEMM files share: the 2-D GEMM (quant_matmul.cu,
// row 2) and the expert stack's persistent kernel (quant_matmul_experts.cu,
// row 2e).  The K step, the packed-weight chunk, the levels' bf16 bits
// (levels_bf16x2: an expert's outputs are the 2-D kernel's bytes), the
// mbarrier and TMA wrappers, the predicated loads, and the host's tensor-map
// encoder with its cache.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>

#include "common.cuh"

namespace rq {

constexpr int kBK = 64;           // K values per step: one 128-byte swizzled bf16 row
constexpr int kWChunk = 128;      // bytes of each packed row per weight chunk

template <int CB> struct WTile {
  static constexpr int kLanes = 8 / CB;
  static constexpr int kRowBytes = kBK / kLanes;                // per step: 16, 32, 64
  static constexpr int kStepBytes = kRowBytes / 4;              // per k16 step: 4, 8, 16
  static constexpr int kSteps = kWChunk / kRowBytes;            // steps per chunk: 8, 4, 2
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}
// The box of `map` at (c0 innermost, c1); what lies outside the tensor
// arrives as zeros.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// Four neighbouring outputs in one store (`out` 4-value aligned).
__device__ __forceinline__ void store4(float* out, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(out) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* out, float a, float b, float c, float d) {
  *reinterpret_cast<uint2*>(out) = make_uint2(bf16x2_bits(a, b), bf16x2_bits(c, d));
}

// Two consecutive levels (k, k+1) of one packed row as a bf16x2 register
// (k in the low half); `pair` holds their two CB-bit fields, k's lowest.
template <int CB>
__device__ __forceinline__ uint32_t levels_bf16x2(uint32_t pair) {
  if constexpr (CB == 8) {
    // 2^23 + u for u = byte ^ 0x80, minus 2^23 + 128: exact in f32, then in bf16
    const float lo = __uint_as_float(0x4B000000u | ((pair ^ 0x80u) & 0xFFu)) - 8388736.f;
    const float hi = __uint_as_float(0x4B000000u | (((pair >> 8) ^ 0x80u) & 0xFFu)) - 8388736.f;
    return bf16x2_bits(lo, hi);
  } else {
    // bf16 128 + (field ^ half) minus 128 + half, half = 2^(CB-1): exact.
    // (pair & mask) * (1 + 2^(16-CB)) puts field k at bit 0 and k+1 at 16.
    constexpr uint32_t kMask = (1u << (2 * CB)) - 1;
    constexpr uint32_t kBias = 0x4300u | (1u << (CB - 1));
    constexpr uint32_t kField = (1u << CB) - 1;
    const uint32_t w = (((pair & kMask) * (1u + (1u << (16 - CB)))) & (kField | (kField << 16))) ^
                       (kBias | (kBias << 16));
    const __nv_bfloat162 v = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&w),
                                     __halves2bfloat162(__ushort_as_bfloat16((unsigned short)kBias),
                                                        __ushort_as_bfloat16((unsigned short)kBias)));
    return *reinterpret_cast<const uint32_t*>(&v);
  }
}

// The path for rows that are not 16-byte aligned: predicated loads by
// thread `tid` of `threads`, zeros outside, in the layouts the TMA path
// leaves.  x step `it` (K values 64 it ..) of rows tok0.. into an x stage
// (bf16: the swizzled B tile, unit c of row r at c ^ (r % 8); f32: plain
// rows of 256 bytes):
template <int NT, typename T>
__device__ void load_x_any(uint8_t* stage, const T* __restrict__ x, int M, int K, int tok0, int it,
                           int tid, int threads) {
  constexpr int ROW = kBK * sizeof(T), CHUNKS = ROW / 16, PER = 16 / sizeof(T);
  const int k0 = it * kBK;
  for (int id = tid; id < NT * CHUNKS; id += threads) {
    const int r = id / CHUNKS, c = id % CHUNKS;
    const int tok = tok0 + r, k = k0 + c * PER;
    uint8_t* dst = stage + (sizeof(T) == 4 ? r * ROW + c * 16 : r * 128 + ((c ^ (r & 7)) << 4));
    alignas(16) T v[PER];
#pragma unroll
    for (int e = 0; e < PER; ++e)
      v[e] = (tok < M && k + e < K) ? x[(size_t)tok * K + k + e] : from_f<T>(0.f);
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
  }
}
// and the packed chunk from byte b0 of `rows` rows ch0.. into a weight slot.
__device__ __forceinline__ void load_w_any(uint8_t* slot, const uint8_t* __restrict__ packed,
                                           int N, int kp, int ch0, int rows, int b0, int tid,
                                           int threads) {
  for (int id = tid; id < rows * (kWChunk / 16); id += threads) {
    const int r = id / (kWChunk / 16), c = id % (kWChunk / 16);
    const int n = ch0 + r, b = b0 + c * 16;
    alignas(16) uint8_t v[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) v[e] = (n < N && b + e < kp) ? packed[(size_t)n * kp + b + e] : 0;
    *reinterpret_cast<uint4*>(slot + r * kWChunk + (((c ^ r) & 7) << 4)) =
        *reinterpret_cast<const uint4*>(v);
  }
}

// cuTensorMapEncodeTiled from the driver, found once.
inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (!encode) {
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode),
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      encode = nullptr;
  }
  return encode;
}

// What a tensor map is encoded from: the same key, the same map.
struct MapKey {
  const void* base;
  int type, rows, cols, box_rows, box_cols, swizzle, layers;
  bool operator==(const MapKey& o) const {
    return base == o.base && type == o.type && rows == o.rows && cols == o.cols &&
           box_rows == o.box_rows && box_cols == o.box_cols && swizzle == o.swizzle &&
           layers == o.layers;
  }
};

// A row-major (layers, rows, cols) tensor of `elem`-byte values as boxes of
// (1, box_rows, box_cols); `layers` 0 encodes the 2-D (rows, cols) map.
// Encoding costs host time on every launch, so the maps are kept in a
// direct-mapped cache: a layer's weights give the same key on every call, and
// x often does (the allocator reuses its buffers).
inline bool encode_map(CUtensorMap* map, CUtensorMapDataType type, int elem, const void* base,
                       int rows, int cols, int box_rows, int box_cols,
                       CUtensorMapSwizzle swizzle, int layers = 0) {
  constexpr int kSlots = 512;
  struct Slot { MapKey key; CUtensorMap map; bool full; };
  thread_local Slot cache[kSlots] = {};
  const MapKey key{base, (int)type, rows, cols, box_rows, box_cols, (int)swizzle, layers};
  Slot& slot = cache[(reinterpret_cast<uintptr_t>(base) >> 4 ^ (uintptr_t)rows * 31 ^
                      (uintptr_t)box_rows * 7 ^ (uintptr_t)layers * 131) % kSlots];
  if (slot.full && slot.key == key) {
    *map = slot.map;
    return true;
  }
  auto encode = tensor_map_encoder();
  if (!encode) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)layers};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * elem, (cuuint64_t)rows * cols * elem};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  if (encode(map, type, layers ? 3 : 2, const_cast<void*>(base), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  slot = Slot{key, *map, true};
  return true;
}

// The 2-D GEMM's launcher (quant_matmul.cu): E experts of x (E, M, K) against
// packed (E, N, kp), one CTA an output tile; the expert stack's f32 x runs it.
int matmul_entry(const void* x, const void* packed, const void* scale, void* y, int E, int M,
                 int N, int K, int kp, int bits, int dtype, int nt, int wgs, int splits,
                 int csize, long long sstride, void* stream);

}  // namespace rq
