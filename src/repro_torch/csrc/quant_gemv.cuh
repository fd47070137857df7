// The GEMV's per-output-channel accumulation, shared by quant_gemv.cu and
// quant_kv_proj.cu so that a channel projected inside the fused decode step
// is the GEMV kernel's value for that row and channel bit for bit.
//
// One warp sums ROWS consecutive packed rows against up to MAXM rows of x:
// lane j takes the 4-byte words j, j + 32, ... of each packed row (bytes
// j, j + 32, ... on the byte-wise path), the values of a word go in order
// with acc += x * level, and a butterfly warp_sum finishes every sum on
// every lane.  Each accumulator belongs to one (x row, channel), so the
// value of a channel does not depend on M or on which kernel asked.
#pragma once

#include "common.cuh"

namespace rq {

__device__ __forceinline__ void bf16x2_to_f(uint32_t w, float& lo, float& hi) {
  lo = __uint_as_float(w << 16);
  hi = __uint_as_float(w & 0xFFFF0000u);
}

// NV consecutive values at p as f32; p is aligned to the vector it is read by.
template <int NV>
__device__ __forceinline__ void load_x(const float* p, float (&v)[NV]) {
#pragma unroll
  for (int i = 0; i < NV; i += 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p + i));
    v[i] = t.x; v[i + 1] = t.y; v[i + 2] = t.z; v[i + 3] = t.w;
  }
}

template <int NV>
__device__ __forceinline__ void load_x(const __nv_bfloat16* p, float (&v)[NV]) {
  if constexpr (NV % 8 == 0) {
#pragma unroll
    for (int i = 0; i < NV; i += 8) {
      const uint4 t = __ldg(reinterpret_cast<const uint4*>(p + i));
      bf16x2_to_f(t.x, v[i], v[i + 1]);
      bf16x2_to_f(t.y, v[i + 2], v[i + 3]);
      bf16x2_to_f(t.z, v[i + 4], v[i + 5]);
      bf16x2_to_f(t.w, v[i + 6], v[i + 7]);
    }
  } else {
    static_assert(NV == 4, "a word holds 4, 8 or 16 values");
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    bf16x2_to_f(t.x, v[0], v[1]);
    bf16x2_to_f(t.y, v[2], v[3]);
  }
}

// acc[r][m] = sum_k x[m, k] * level[r, k] for the rows packed, packed + kp,
// ... (ROWS of them, the first nrows real) and the M rows of x (M <= MAXM),
// unscaled, on every lane of the warp.  vec != 0: every packed row is a
// whole number of aligned 4-byte words with no K padding, and x is 16-byte
// aligned (the caller checks).
template <int BITS, int ROWS, int MAXM, typename T>
__device__ __forceinline__ void gemv_rows(const T* __restrict__ x, int M, int K,
                                          const uint8_t* __restrict__ packed, int kp,
                                          int nrows, int vec, int lane,
                                          float (&acc)[ROWS][MAXM]) {
  constexpr int LANES = lanes_of(BITS);
  constexpr int CB = 8 / LANES;   // container bits of one value (6-bit values ride in 8)
  constexpr int NV = 4 * LANES;   // values in one 4-byte word
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int m = 0; m < MAXM; ++m) acc[r][m] = 0.f;

  if (vec) {
    const int nw = kp / 4;
#pragma unroll 2
    for (int w = lane; w < nw; w += 32) {
      float lev[ROWS][NV];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const uint32_t word =
            r < nrows ? __ldg(reinterpret_cast<const uint32_t*>(packed + (size_t)r * kp) + w)
                      : 0u;
#pragma unroll
        for (int v = 0; v < NV; ++v)
          lev[r][v] = (float)word_lane(word, CB, v);
      }
#pragma unroll
      for (int m = 0; m < MAXM; ++m) {
        if (m >= M) break;
        float xv[NV];
        load_x<NV>(x + (size_t)m * K + (size_t)w * NV, xv);
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
#pragma unroll
          for (int v = 0; v < NV; ++v) acc[r][m] += xv[v] * lev[r][v];
      }
    }
  } else {
    for (int j = lane; j < kp; j += 32) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (r >= nrows) break;
        const uint32_t byte = packed[(size_t)r * kp + j];
#pragma unroll
        for (int l = 0; l < LANES; ++l) {
          const int k = j * LANES + l;
          if (k >= K) break;
          const float w = (float)unpack_lane(byte, BITS, l);
#pragma unroll
          for (int m = 0; m < MAXM; ++m)
            if (m < M) acc[r][m] += to_f(x[(size_t)m * K + k]) * w;
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int m = 0; m < MAXM; ++m) acc[r][m] = warp_sum(acc[r][m]);
}

// The vector path's preconditions, as both launchers decide them.
inline int gemv_vec(const void* x, const void* packed, int K, int kp, int bits) {
  return kp % 4 == 0 && kp * lanes_of(bits) == K &&
         (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
         (reinterpret_cast<uintptr_t>(packed) & 3) == 0;
}

}  // namespace rq
