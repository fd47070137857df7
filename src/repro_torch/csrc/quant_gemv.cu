// quant_gemv: y[m, n] = scale[n] * sum_k x[m, k] * level[n, k], for M <= 8.
//
// Replaces the TPU kernel quant_gemv_pallas (repro/kernels/quant_gemv/
// kernel.py:64, pallas_call at :96): the decode-time linear, where M is the
// handful of active slots and every packed weight byte is read once.
//
// Bound on the H100: the packed weight bytes, N * ceil(K/lanes), at
// 3.35 TB/s (one gemma-2b layer's four fused linears at 4 bits: 55 MB,
// 0.0166 ms).  At that rate the card must turn about two packed values a
// byte into products with up to 8 rows of x: beyond the CUDA cores' f32 FMA
// rate at M = 8 and beyond their int -> float conversion rate at any M.
//
// Design (the arithmetic is quant_gemv.cuh's, which row 8 shares):
//  * Tensor cores.  mma.sync m16n8k16 with the 16 channels of a warp as A
//    (levels, exact in bf16, made by bit tricks) and up to 8 rows of x as B.
//  * x once per CTA.  A CTA owns 128 x `tiles` channels (8 warps, each
//    `tiles` tiles of 16 rows) and one K range, and stages that range of x
//    in shared memory in the B operand's order before its warps read it, so
//    x comes from L2 once per CTA, not once per warp.  `tiles` grows with N
//    (kernel.py plan) while the CTAs still make one wave: one CTA a tile
//    paid its launch, first load and cluster barrier for 16 KB of w_gu.
//  * Bytes in flight.  Each lane keeps two load groups of kGemvGroup
//    rounds (16 bytes of each of its two rows a round) in flight, the first
//    asked for before x is staged, the next across tile boundaries.  One
//    round a group: deeper groups held more registers, fewer warps fit an
//    SM, and the kernel ran slower (tools/gemv_variants.py, PERF.md
//    section 6); so did a cp.async ring in shared memory.
//  * All SMs streaming.  K is cut into ranges of whole 256-value units by
//    K alone: 8 below 64 units, 16 from there (w_down's K 16384), so the
//    narrow linears (N 2048-2560, 16-20 tiles) run 128-160 CTAs, w_down
//    256, and w_gu's 256 tiles x 8 ranges 256 CTAs of 8 tiles.  The ranges of a
//    CTA's channels run on the CTAs of one thread-block cluster; each rank
//    owns a slice of the channels, every rank stores its partials for a
//    slice into the owner's shared memory (after a first cluster barrier,
//    arrived at before x is staged and waited on after, so that every CTA of
//    the cluster has started), and after a second the owner adds them from
//    zero in rank order.  No atomics: the same bits
//    run to run, whatever M or N.
#include <cooperative_groups.h>

#include "quant_gemv.cuh"

namespace cg = cooperative_groups;

namespace rq {

// The CTA's partial sums: every rank's for this rank's slice of the channels.
__host__ __device__ constexpr size_t gemv_part_bytes(int tiles) {
  return (size_t)(kGemvChannels * tiles + kGemvMaxSplit) * kGemvMaxM * 4;
}

template <int CB, typename T>
__global__ void __launch_bounds__(kGemvThreads)
quant_gemv_kernel(const T* __restrict__ x, const uint8_t* __restrict__ packed,
                  const float* __restrict__ scale, T* __restrict__ y, int M, int N, int K, int kp,
                  int splits, int tiles, int wvec, int xvec) {
  extern __shared__ __align__(16) uint8_t gsm[];
  constexpr bool XF32 = sizeof(T) == 4;
  using S = GemvShape<CB>;
  float* part = reinterpret_cast<float*>(gsm);
  uint8_t* xs = gsm + gemv_part_bytes(tiles);
  const int s = blockIdx.x, n0 = blockIdx.y * kGemvChannels * tiles;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  int k0, k1;
  gemv_range(K, splits, s, k0, k1);
  const int rounds = (k1 - k0 + S::kRound - 1) / S::kRound;
  const int piece = gemv_piece_bytes<CB>(M, rounds);

  GemvWarp<CB, XF32> wr{packed, kp, wvec, k0 / (8 / CB), rounds, lane,
                         n0 + warp * kGemvTileRows, kGemvChannels, N, tiles};
  wr.prime();                                  // the weights come while x is staged
  // No rank may touch another's shared memory before every CTA of the
  // cluster has started: arrive now, wait once x is staged, so the barrier's
  // latency hides behind the staging.
  if (splits > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  gemv_stage_x<CB, T>(x, K, M, k0, k1, rounds, xvec, xs, piece);
  __syncthreads();
  if (splits > 1) asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  // Each rank owns a slice of the CTA's channels; every rank stores each
  // tile's C fragment (rows g, g + 8 of the warp's 16 x columns, the x rows,
  // 2q, 2q + 1) into the owner's part, (splits, M, W): one cluster barrier
  // after the stores then suffices, and the fold reads local memory.
  const int nc = kGemvChannels * tiles;
  const int W = (nc + splits - 1) / splits;
  cg::cluster_group cluster = cg::this_cluster();
  wr.run(xs, piece, M, [&](int t, const float (&acc)[4]) {
    const int rl = t * kGemvChannels + warp * kGemvTileRows + g;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = rl + 8 * h, o = ((c + 1) * splits - 1) / nc, c0 = o * nc / splits;
      float* dst = splits > 1 ? cluster.map_shared_rank(part, o) : part;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = 2 * q + e;
        if (m < M) dst[(s * M + m) * W + c - c0] = acc[2 * h + e];
      }
    }
  });
  if (splits > 1) cluster.sync();
  else __syncthreads();

  // the owner adds every rank's partial from zero in rank order, times the
  // channel's scale
  const int c0 = s * nc / splits, c1 = (s + 1) * nc / splits;
  for (int i = threadIdx.x; i < M * (c1 - c0); i += blockDim.x) {
    const int m = i / (c1 - c0), c = i % (c1 - c0), n = n0 + c0 + c;
    float total = 0.f;
    for (int r = 0; r < splits; ++r) total = gemv_fold(total, part[(r * M + m) * W + c]);
    if (n < N) y[(size_t)m * N + n] = from_f<T>(__fmul_rn(total, scale[n]));
  }
}

template <int CB, typename T>
cudaError_t launch_gemv_cb(const T* x, const uint8_t* packed, const float* scale, T* y, int M,
                           int N, int K, int kp, int splits, int tiles, cudaStream_t stream) {
  constexpr bool XF32 = sizeof(T) == 4;
  static bool configured = false;      // the attributes, once per instantiation
  auto kernel = quant_gemv_kernel<CB, T>;
  const size_t smem = gemv_part_bytes(tiles) + (XF32 ? 3 : 1) *
                      (size_t)gemv_piece_bytes<CB>(M, gemv_max_rounds<CB>(K, splits));
  if (!configured) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  const int cta_channels = kGemvChannels * tiles;
  cfg.gridDim = dim3((unsigned)splits, (unsigned)((N + cta_channels - 1) / cta_channels));
  cfg.blockDim = dim3(kGemvThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, x, packed, scale, y, M, N, K, kp, splits,
                                       tiles, gemv_wvec(packed, kp), gemv_xvec(x, K));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_gemv(const void* x, const void* packed, const void* scale, void* y, int M,
                        int N, int K, int kp, int bits, int splits, int tiles,
                        cudaStream_t stream) {
  const T* xx = static_cast<const T*>(x);
  const uint8_t* pp = static_cast<const uint8_t*>(packed);
  const float* ss = static_cast<const float*>(scale);
  T* yy = static_cast<T*>(y);
  switch (gemv_cb(bits)) {
    case 2: return launch_gemv_cb<2, T>(xx, pp, ss, yy, M, N, K, kp, splits, tiles, stream);
    case 4: return launch_gemv_cb<4, T>(xx, pp, ss, yy, M, N, K, kp, splits, tiles, stream);
    default: return launch_gemv_cb<8, T>(xx, pp, ss, yy, M, N, K, kp, splits, tiles, stream);
  }
}

}  // namespace rq

// y (M, N) in x's type; x (M, K); packed (N, kp) int8; scale (N,) f32;
// splits the K ranges (kernels/quant_gemv/kernel.py plan: a function of K),
// tiles the 16-row tiles of each warp (128 * tiles channels a CTA).
extern "C" int rq_quant_gemv(const void* x, const void* packed, const void* scale, void* y,
                             int M, int N, int K, int kp, int bits, int dtype, int splits,
                             int tiles, void* stream) {
  if (M < 1 || M > rq::kGemvMaxM || N < 1 || K < 1 || rq::bad_gemv_bits(bits) ||
      kp != (K + rq::lanes_of(bits) - 1) / rq::lanes_of(bits) ||
      rq::bad_gemv_split(K, splits) || tiles < 1 || tiles > rq::kGemvMaxTiles)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rq::kF32)
    return (int)rq::launch_gemv<float>(x, packed, scale, y, M, N, K, kp, bits, splits, tiles, s);
  if (dtype == rq::kBF16)
    return (int)rq::launch_gemv<__nv_bfloat16>(x, packed, scale, y, M, N, K, kp, bits, splits,
                                               tiles, s);
  return (int)cudaErrorInvalidValue;
}
