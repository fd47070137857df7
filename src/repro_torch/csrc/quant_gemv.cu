// quant_gemv: y[m, n] = scale[n] * sum_k x[m, k] * level[n, k], for M <= 8.
//
// Replaces the TPU kernel quant_gemv_pallas (repro/kernels/quant_gemv/
// kernel.py:64, pallas_call at :96): the decode-time linear, where M is the
// handful of active slots and every packed weight byte is read once.
//
// Bound on the H100: the packed weight bytes, N * ceil(K/lanes), at
// 3.35 TB/s.  x is at most 8 x 16384 values and stays in L1/L2.
//
// Design.  The Pallas kernel keeps the whole x row-block resident in VMEM;
// here 8 rows of a 16384-wide f32 x take 512 KB, over the 227 KB a block can
// use, so x is read straight from global memory through the read-only cache.
// One warp owns kGemvRows output channels.  Lane j of the warp reads the
// 4-byte words j, j + 32, ... of each packed row, so a warp's load is 128
// contiguous bytes, and the x values under a word are NV consecutive values
// read as 16- or 8-byte vectors, contiguous across the warp too.  Levels are
// unpacked in registers once per word and reused for every row of x; the
// sums of x * level are kept in f32 and the per-channel scale multiplies the
// finished sum once, as in the Pallas kernel.  The ragged N edge is masked
// per row.  Rows whose packed length is not a whole number of words, or
// whose K was padded to fill the last byte, take a byte-wise path that masks
// the padding.  Split-K and a shared-memory x tile are later work.
#include "common.cuh"

namespace rq {

constexpr int kGemvMaxM = 8;
constexpr int kGemvThreads = 256;
constexpr int kGemvRows = 2;  // output channels per warp

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

// vec != 0: every packed row is a whole number of aligned 4-byte words with
// no K padding, and x is 16-byte aligned (checked by the launcher).
template <int BITS, typename T>
__global__ void __launch_bounds__(kGemvThreads)
quant_gemv_kernel(const T* __restrict__ x, const uint8_t* __restrict__ packed,
                  const float* __restrict__ scale, T* __restrict__ y,
                  int M, int N, int K, int kp, int vec) {
  constexpr int LANES = lanes_of(BITS);
  constexpr int CB = 8 / LANES;   // container bits of one value (6-bit values ride in 8)
  constexpr int NV = 4 * LANES;   // values in one 4-byte word
  const int warp = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  const int n0 = warp * kGemvRows;
  if (n0 >= N) return;  // uniform per warp
  float acc[kGemvRows][kGemvMaxM];
#pragma unroll
  for (int r = 0; r < kGemvRows; ++r)
#pragma unroll
    for (int m = 0; m < kGemvMaxM; ++m) acc[r][m] = 0.f;

  if (vec) {
    const int nw = kp / 4;
#pragma unroll 2
    for (int w = lane; w < nw; w += 32) {
      float lev[kGemvRows][NV];
#pragma unroll
      for (int r = 0; r < kGemvRows; ++r) {
        const int n = n0 + r;
        const uint32_t word =
            n < N ? __ldg(reinterpret_cast<const uint32_t*>(packed + (size_t)n * kp) + w) : 0u;
#pragma unroll
        for (int v = 0; v < NV; ++v)
          lev[r][v] = (float)word_lane(word, CB, v);
      }
#pragma unroll
      for (int m = 0; m < kGemvMaxM; ++m) {
        if (m >= M) break;
        float xv[NV];
        load_x<NV>(x + (size_t)m * K + (size_t)w * NV, xv);
#pragma unroll
        for (int r = 0; r < kGemvRows; ++r)
#pragma unroll
          for (int v = 0; v < NV; ++v) acc[r][m] += xv[v] * lev[r][v];
      }
    }
  } else {
    for (int j = lane; j < kp; j += 32) {
#pragma unroll
      for (int r = 0; r < kGemvRows; ++r) {
        const int n = n0 + r;
        if (n >= N) break;
        const uint32_t byte = packed[(size_t)n * kp + j];
#pragma unroll
        for (int l = 0; l < LANES; ++l) {
          const int k = j * LANES + l;
          if (k >= K) break;
          const float w = (float)unpack_lane(byte, BITS, l);
#pragma unroll
          for (int m = 0; m < kGemvMaxM; ++m)
            if (m < M) acc[r][m] += to_f(x[(size_t)m * K + k]) * w;
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kGemvRows; ++r)
#pragma unroll
    for (int m = 0; m < kGemvMaxM; ++m) acc[r][m] = warp_sum(acc[r][m]);
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < kGemvRows; ++r) {
      const int n = n0 + r;
      if (n >= N) break;
      const float s = scale[n];
#pragma unroll
      for (int m = 0; m < kGemvMaxM; ++m)
        if (m < M) y[(size_t)m * N + n] = from_f<T>(acc[r][m] * s);
    }
  }
}

template <typename T>
cudaError_t launch_gemv(const void* x, const void* packed, const void* scale, void* y,
                        int M, int N, int K, int kp, int bits, cudaStream_t stream) {
  const int lanes = lanes_of(bits);
  const int vec = kp % 4 == 0 && kp * lanes == K &&
                  (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                  (reinterpret_cast<uintptr_t>(packed) & 3) == 0;
  const int rows_per_block = (kGemvThreads / 32) * kGemvRows;
  const dim3 block(kGemvThreads);
  const dim3 grid((unsigned)((N + rows_per_block - 1) / rows_per_block));
  const T* xx = static_cast<const T*>(x);
  const uint8_t* pp = static_cast<const uint8_t*>(packed);
  const float* ss = static_cast<const float*>(scale);
  T* yy = static_cast<T*>(y);
  switch (bits) {
    case 2: quant_gemv_kernel<2, T><<<grid, block, 0, stream>>>(xx, pp, ss, yy, M, N, K, kp, vec); break;
    case 4: quant_gemv_kernel<4, T><<<grid, block, 0, stream>>>(xx, pp, ss, yy, M, N, K, kp, vec); break;
    case 6: quant_gemv_kernel<6, T><<<grid, block, 0, stream>>>(xx, pp, ss, yy, M, N, K, kp, vec); break;
    case 8: quant_gemv_kernel<8, T><<<grid, block, 0, stream>>>(xx, pp, ss, yy, M, N, K, kp, vec); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace rq

// y (M, N) in x's type; x (M, K); packed (N, kp) int8; scale (N,) f32.
extern "C" int rq_quant_gemv(const void* x, const void* packed, const void* scale, void* y,
                             int M, int N, int K, int kp, int bits, int dtype, void* stream) {
  if (M < 1 || M > rq::kGemvMaxM || N < 1 || K < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rq::kF32) return (int)rq::launch_gemv<float>(x, packed, scale, y, M, N, K, kp, bits, s);
  if (dtype == rq::kBF16)
    return (int)rq::launch_gemv<__nv_bfloat16>(x, packed, scale, y, M, N, K, kp, bits, s);
  return (int)cudaErrorInvalidValue;
}
