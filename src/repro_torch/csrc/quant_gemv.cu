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
// the padding.  The accumulation itself lives in quant_gemv.cuh, which the
// projection-fused decode step (quant_kv_proj.cu) calls too.  Split-K and a
// shared-memory x tile are later work.
#include "quant_gemv.cuh"

namespace rq {

constexpr int kGemvMaxM = 8;
constexpr int kGemvThreads = 256;
constexpr int kGemvRows = 2;  // output channels per warp

template <int BITS, typename T>
__global__ void __launch_bounds__(kGemvThreads)
quant_gemv_kernel(const T* __restrict__ x, const uint8_t* __restrict__ packed,
                  const float* __restrict__ scale, T* __restrict__ y,
                  int M, int N, int K, int kp, int vec) {
  const int warp = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  const int n0 = warp * kGemvRows;
  if (n0 >= N) return;  // uniform per warp
  float acc[kGemvRows][kGemvMaxM];
  gemv_rows<BITS, kGemvRows, kGemvMaxM>(x, M, K, packed + (size_t)n0 * kp, kp, N - n0, vec,
                                        lane, acc);
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
  const int vec = gemv_vec(x, packed, K, kp, bits);
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
