// quant_matmul: y[m, n] = sum_k x[m, k] * (level[n, k] * scale[n]), for M > 8.
//
// Replaces the TPU kernel quant_matmul_pallas (repro/kernels/quant_matmul/
// kernel.py:68, pallas_call at :99): the prefill linear, M = admitted rows
// times the prefill pad.
//
// Bound on the H100: at the prefill widths of gemma-2b (M = 128, K up to
// 16384, N up to 32768) the FLOPs, 2*M*N*K, at the bf16 tensor-core rate;
// this kernel runs on CUDA cores in f32 and is far from that bound.
//
// Design.  A shared-memory tiled GEMM (64 x 64 output tile, K step 32, 256
// threads with a 4 x 4 register tile each).  Like the Pallas body, the
// weight tile is dequantized in the tile (level * scale in f32, before the
// product), x is widened to f32, and the sum is kept in f32 with K
// innermost.  Ragged M, N and K edges load zeros.  Tensor cores
// (mma.sync / wgmma on bf16) and TMA are later work.
#include "common.cuh"

namespace rq {

constexpr int kBM = 64, kBN = 64, kBK = 32, kMatThreads = 256;

template <int BITS, typename T>
__global__ void __launch_bounds__(kMatThreads)
quant_matmul_kernel(const T* __restrict__ x, const uint8_t* __restrict__ packed,
                    const float* __restrict__ scale, T* __restrict__ y,
                    int M, int N, int K, int kp) {
  constexpr int LANES = lanes_of(BITS);
  __shared__ float As[kBK][kBM + 4];
  __shared__ float Bs[kBK][kBN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int i = tid; i < kBM * kBK; i += kMatThreads) {
      const int r = i / kBK, c = i % kBK;
      const int m = m0 + r, k = k0 + c;
      As[c][r] = (m < M && k < K) ? to_f(x[(size_t)m * K + k]) : 0.f;
    }
    for (int i = tid; i < kBN * kBK; i += kMatThreads) {
      const int r = i / kBK, c = i % kBK;
      const int n = n0 + r, k = k0 + c;
      float w = 0.f;
      if (n < N && k < K) {
        const uint32_t byte = packed[(size_t)n * kp + k / LANES];
        w = (float)unpack_lane(byte, BITS, k % LANES) * scale[n];
      }
      Bs[c][r] = w;
    }
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < kBK; ++c) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[c][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[c][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) y[(size_t)m * N + n] = from_f<T>(acc[i][j]);
    }
  }
}

template <typename T>
cudaError_t launch_matmul(const void* x, const void* packed, const void* scale, void* y,
                          int M, int N, int K, int kp, int bits, cudaStream_t stream) {
  const dim3 block(kMatThreads);
  const dim3 grid((unsigned)((N + kBN - 1) / kBN), (unsigned)((M + kBM - 1) / kBM));
  const T* xx = static_cast<const T*>(x);
  const uint8_t* pp = static_cast<const uint8_t*>(packed);
  const float* ss = static_cast<const float*>(scale);
  T* yy = static_cast<T*>(y);
  switch (bits) {
    case 2: quant_matmul_kernel<2, T><<<grid, block, 0, stream>>>(xx, pp, ss, yy, M, N, K, kp); break;
    case 4: quant_matmul_kernel<4, T><<<grid, block, 0, stream>>>(xx, pp, ss, yy, M, N, K, kp); break;
    case 6: quant_matmul_kernel<6, T><<<grid, block, 0, stream>>>(xx, pp, ss, yy, M, N, K, kp); break;
    case 8: quant_matmul_kernel<8, T><<<grid, block, 0, stream>>>(xx, pp, ss, yy, M, N, K, kp); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace rq

// y (M, N) in x's type; x (M, K); packed (N, kp) int8; scale (N,) f32.
extern "C" int rq_quant_matmul(const void* x, const void* packed, const void* scale, void* y,
                               int M, int N, int K, int kp, int bits, int dtype, void* stream) {
  if (M < 1 || N < 1 || K < 1 || M > 65535 * rq::kBM) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rq::kF32) return (int)rq::launch_matmul<float>(x, packed, scale, y, M, N, K, kp, bits, s);
  if (dtype == rq::kBF16)
    return (int)rq::launch_matmul<__nv_bfloat16>(x, packed, scale, y, M, N, K, kp, bits, s);
  return (int)cudaErrorInvalidValue;
}
