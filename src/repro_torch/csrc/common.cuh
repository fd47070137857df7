// Shared device helpers of the port's kernels: the packed lane layout of
// repro_torch/core/packing.py (value k at byte k/lanes, field k%lanes, low
// bits first, sign-extended; 6- and 8-bit values one per byte as int8) and
// the two activation types the kernels accept.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rq {

// dtype codes the Python wrappers pass
enum DType { kF32 = 0, kBF16 = 1 };

__host__ __device__ constexpr int lanes_of(int bits) {
  return bits == 2 ? 4 : (bits == 4 ? 2 : 1);
}

// Field `lane` of a packed byte as a signed level.
__device__ __forceinline__ int unpack_lane(uint32_t byte, int bits, int lane) {
  if (bits >= 6) return (int)(int8_t)(uint8_t)byte;
  return ((int)(byte << (32 - bits * (lane + 1)))) >> (32 - bits);
}

// Value v of a packed 4-byte word whose fields are cb = 8 / lanes bits wide
// (6- and 8-bit levels: whole int8 bytes), sign-extended.  Bytes are little
// endian, so value v of the word is value 4 * lanes * word + v of the row.
__device__ __forceinline__ int word_lane(uint32_t word, int cb, int v) {
  return ((int)(word << (32 - cb * (v + 1)))) >> (32 - cb);
}

// One level's bits in its field of a packed byte (6/8 bits: the int8 byte).
__device__ __forceinline__ uint32_t pack_field(int lev, int bits, int lane) {
  if (bits >= 6) return (uint32_t)(lev & 0xFF);
  return ((uint32_t)(lev & ((1 << bits) - 1))) << (bits * lane);
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

}  // namespace rq
