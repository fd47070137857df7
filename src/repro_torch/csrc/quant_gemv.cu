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
//
// The expert stack (rq_quant_gemv_experts): the TPU kernel under jax.vmap
// in the MoE layer's qt_matmul (repro/kernels/quant_matmul/ops.py:66-94), x
// (E, C, K) against packed (E, N, kp), one launch for all E, the experts on
// grid z.  At a decode step most experts hold no token (deepseek-moe-16b, 4
// slots, top-6 of 64: about 21 live), and the MoE layer leaves their rows
// of the capacity buffer exact zeros.  So:
//  * What it reads first.  Each CTA reads 16 bytes of row 0 of every
//    expert (the layer writes an expert's first token there) and orders the
//    experts: those whose 16 bytes hold a nonzero (sign aside), in index
//    order, then the rest.  CTA slot z takes the z-th: the clusters of the
//    live experts are dispatched first, the skipped ones fill in behind.
//    Such a hinted expert is live; any other is read in full, M x K with
//    16-byte loads, a nonzero with the sign masked off (-0.0 is zero, NaN
//    live) making it live.
//  * What it skips.  A CTA whose expert's x is all zero loads none of its
//    weights and joins no cluster barrier (every rank reads the same x, so
//    the cluster leaves together): it writes its owned outputs and returns.
//  * Why those are the same bits.  Zero products sum to zeros in any order;
//    the fold starts from 0.f, and +0 + -0 = +0, so the full path would
//    write from_f(+0 * scale[n]), which is what the skip writes (a negative
//    or NaN scale included).  A live expert runs the 2-D kernel's path with
//    the 2-D plan's split, so its outputs are the 2-D kernel's on its slice,
//    bit for bit; the stack's tiles (kernel.py expert_tiles: the 2-D rule's
//    CTA count, N cut evenly) do not move a channel's bits.
//  * Measured (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py phase 13 (a),
//    device time of a layer's three linears, 4 bits, bf16, C 8): 0.0978 ms
//    on the routed buffer of 4 tokens (20 of 64 experts live; the live
//    experts' bytes bound it at 0.0290) and 0.2254 ms on dense x (bound
//    0.0858), where every expert was streamed whatever x held: 0.2497 ms.
//    Without the order (slot z taking expert z, every x read in full) the
//    routed buffer took about 0.13 ms (tools/gemv_variants.py noorder).
#include <cooperative_groups.h>

#include "quant_gemv.cuh"

namespace cg = cooperative_groups;

namespace rq {

// The CTA's partial sums: every rank's for this rank's slice of the channels.
__host__ __device__ constexpr size_t gemv_part_bytes(int tiles) {
  return (size_t)(kGemvChannels * tiles + kGemvMaxSplit) * kGemvMaxM * 4;
}

__device__ __forceinline__ uint32_t bits_of(float v) { return __float_as_uint(v); }
__device__ __forceinline__ uint32_t bits_of(__nv_bfloat16 v) { return __bfloat16_as_ushort(v); }

// Whether any of x (M x K, contiguous) is nonzero once its sign bit is
// masked off (-0.0 counts as zero, NaN as live), decided by the whole CTA.
// vec16: x may be read 16 bytes at a time (K * sizeof(T) % 16 == 0, x
// 16-byte aligned).
template <typename T>
__device__ bool gemv_any_live(const T* __restrict__ x, int K, int M, int vec16) {
  constexpr uint32_t kMag = sizeof(T) == 4 ? 0x7FFFFFFFu : 0x7FFF7FFFu;
  uint32_t seen = 0u;
  if (vec16) {
    const uint4* v = reinterpret_cast<const uint4*>(x);
    for (int it = threadIdx.x; it < M * K / (16 / (int)sizeof(T)); it += blockDim.x) {
      const uint4 w = __ldg(v + it);
      seen |= w.x | w.y | w.z | w.w;
    }
  } else {
    for (int it = threadIdx.x; it < M * K; it += blockDim.x) seen |= bits_of(x[it]);
  }
  return __syncthreads_or((seen & kMag) != 0u) != 0;
}

// One CTA's work on one weight (an expert's, offset by the caller): rank
// s = blockIdx.x of the cluster sums K range s for the channels of block
// blockIdx.y.  SCAN (the expert stack): unless `hinted` (row 0 of x begins
// with a nonzero, so x is live), read all of x, and if it is zero skip the
// weights and write what the sums would give (the design note above).
template <int CB, typename T, bool SCAN>
__device__ __forceinline__ void gemv_cta(const T* __restrict__ x,
                                         const uint8_t* __restrict__ packed,
                                         const float* __restrict__ scale, T* __restrict__ y,
                                         int M, int N, int K, int kp, int splits, int tiles,
                                         int wvec, int xvec, int xscan, bool hinted,
                                         uint8_t* gsm) {
  constexpr bool XF32 = sizeof(T) == 4;
  using S = GemvShape<CB>;
  float* part = reinterpret_cast<float*>(gsm);
  uint8_t* xs = gsm + gemv_part_bytes(tiles);
  const int s = blockIdx.x, n0 = blockIdx.y * kGemvChannels * tiles;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  int k0, k1;
  gemv_range(K, splits, s, k0, k1);
  if constexpr (SCAN) {
    // Every rank of a cluster reads the same x, so all return here or none
    // does, before any cluster barrier.  The sums of zero products are
    // zeros, the fold from 0.f makes them +0, so the outputs are +0 times
    // the scale, bit for bit what the full path writes.
    if (!hinted && !gemv_any_live(x, K, M, xscan)) {
      const int nc = kGemvChannels * tiles;     // this rank's channels, as the fold's below
      const int c0 = s * nc / splits, c1 = (s + 1) * nc / splits;
      for (int i = threadIdx.x; i < M * (c1 - c0); i += blockDim.x) {
        const int m = i / (c1 - c0), n = n0 + c0 + i % (c1 - c0);
        if (n < N) y[(size_t)m * N + n] = from_f<T>(__fmul_rn(0.f, scale[n]));
      }
      return;
    }
  }
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

// The expert that CTA slot z = blockIdx.z of a stack takes, times 2, plus 1
// if it is hinted: position z of an order of the E experts that puts first,
// in index order, those whose row 0 holds a nonzero (sign aside) among its
// first 16 bytes (the MoE layer writes an expert's first token into row 0),
// then the rest in index order.  Every CTA computes the same order from the
// same bytes, so each expert is taken once.  The order lets the clusters of
// the experts that hold a token be dispatched first; a hinted expert is
// live (no scan), the others are read in full (gemv_cta).
template <typename T>
__device__ int gemv_expert_of_slot(const T* __restrict__ x, int E, int M, int K, int xscan) {
  __shared__ int warp_hint[kGemvWarps];
  __shared__ int mine;
  constexpr uint32_t kMag = sizeof(T) == 4 ? 0x7FFFFFFFu : 0x7FFF7FFFu;
  const int z = blockIdx.z, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lead = K < 16 / (int)sizeof(T) ? K : 16 / (int)sizeof(T);
  auto hinted = [&](int e) {
    uint32_t seen = 0u;
    if (e < E) {
      const T* row = x + (size_t)e * M * K;
      if (xscan) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(row));
        seen = v.x | v.y | v.z | v.w;
      } else {
        for (int j = 0; j < lead; ++j) seen |= bits_of(row[j]);
      }
    }
    return (seen & kMag) != 0u;
  };
  int total = 0;                               // hinted experts in all
  for (int e0 = 0; e0 < E; e0 += blockDim.x) total += __syncthreads_count(hinted(e0 + threadIdx.x));
  int before = 0;                              // hinted experts below this chunk
  for (int e0 = 0; e0 < E; e0 += blockDim.x) {
    const int e = e0 + threadIdx.x;
    const bool h = hinted(e);
    const unsigned votes = __ballot_sync(0xffffffffu, h);
    if (lane == 0) warp_hint[warp] = __popc(votes);
    __syncthreads();
    int rank = before + __popc(votes & ((1u << lane) - 1u)), chunk = 0;
    for (int w = 0; w < kGemvWarps; ++w) {
      rank += w < warp ? warp_hint[w] : 0;
      chunk += warp_hint[w];
    }
    // e - rank: the experts below e that are not hinted
    if (e < E && (h ? rank : total + e - rank) == z) mine = 2 * e + h;
    before += chunk;
    __syncthreads();
  }
  return mine;
}

// One 2-D weight (E 1), or (SCAN) an expert stack of E on grid z.
template <int CB, typename T, bool SCAN>
__global__ void __launch_bounds__(kGemvThreads)
quant_gemv_kernel(const T* __restrict__ x, const uint8_t* __restrict__ packed,
                  const float* __restrict__ scale, T* __restrict__ y, int E, int M, int N, int K,
                  int kp, int splits, int tiles, int wvec, int xvec, int xscan,
                  long long sstride) {
  extern __shared__ __align__(16) uint8_t gsm[];
  size_t ex = 0;                               // the expert (0 for a 2-D weight)
  bool hinted = false;
  if constexpr (SCAN) {
    const int slot = gemv_expert_of_slot(x, E, M, K, xscan);
    ex = slot >> 1;
    hinted = slot & 1;
  }
  gemv_cta<CB, T, SCAN>(x + ex * M * K, packed + ex * N * kp, scale + ex * sstride,
                        y + ex * M * N, M, N, K, kp, splits, tiles, wvec, xvec, xscan, hinted,
                        gsm);
}

template <int CB, typename T>
cudaError_t launch_gemv_cb(const T* x, const uint8_t* packed, const float* scale, T* y, int E,
                           int M, int N, int K, int kp, int splits, int tiles,
                           long long sstride, bool scan, cudaStream_t stream) {
  constexpr bool XF32 = sizeof(T) == 4;
  static bool configured[2] = {false, false};   // the attributes, once per instantiation
  auto kernel = scan ? &quant_gemv_kernel<CB, T, true> : &quant_gemv_kernel<CB, T, false>;
  const size_t smem = gemv_part_bytes(tiles) + (XF32 ? 3 : 1) *
                      (size_t)gemv_piece_bytes<CB>(M, gemv_max_rounds<CB>(K, splits));
  if (!configured[scan]) {
    cudaFuncAttributes fa;
    cudaError_t err = cudaFuncGetAttributes(&fa, kernel);   // the static shared memory
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 232448 - (int)fa.sharedSizeBytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    configured[scan] = true;
  }
  cudaLaunchConfig_t cfg = {};
  const int cta_channels = kGemvChannels * tiles;
  cfg.gridDim = dim3((unsigned)splits, (unsigned)((N + cta_channels - 1) / cta_channels),
                     (unsigned)E);
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
  const int xscan = (K * sizeof(T)) % 16 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, x, packed, scale, y, E, M, N, K, kp,
                                       splits, tiles, gemv_wvec(packed, kp), gemv_xvec(x, K),
                                       xscan, sstride);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_gemv(const void* x, const void* packed, const void* scale, void* y, int E,
                        int M, int N, int K, int kp, int bits, int splits, int tiles,
                        long long sstride, bool scan, cudaStream_t stream) {
  const T* xx = static_cast<const T*>(x);
  const uint8_t* pp = static_cast<const uint8_t*>(packed);
  const float* ss = static_cast<const float*>(scale);
  T* yy = static_cast<T*>(y);
  switch (gemv_cb(bits)) {
    case 2:
      return launch_gemv_cb<2, T>(xx, pp, ss, yy, E, M, N, K, kp, splits, tiles, sstride,
                                     scan, stream);
    case 4:
      return launch_gemv_cb<4, T>(xx, pp, ss, yy, E, M, N, K, kp, splits, tiles, sstride,
                                     scan, stream);
    default:
      return launch_gemv_cb<8, T>(xx, pp, ss, yy, E, M, N, K, kp, splits, tiles, sstride,
                                     scan, stream);
  }
}

}  // namespace rq

// Both entry points: E experts of x (E, M, K) against packed (E, N, kp), the
// scale of expert e at scale + e * sstride (sstride 0 or N).
static int gemv_entry(const void* x, const void* packed, const void* scale, void* y, int E,
                      int M, int N, int K, int kp, int bits, int dtype, int splits, int tiles,
                      long long sstride, bool scan, void* stream) {
  if (E < 1 || E > 65535 || M < 1 || M > rq::kGemvMaxM || N < 1 || K < 1 ||
      rq::bad_gemv_bits(bits) || kp != (K + rq::lanes_of(bits) - 1) / rq::lanes_of(bits) ||
      rq::bad_gemv_split(K, splits) || tiles < 1 || tiles > rq::kGemvMaxTiles ||
      (sstride != 0 && sstride != N))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rq::kF32)
    return (int)rq::launch_gemv<float>(x, packed, scale, y, E, M, N, K, kp, bits, splits, tiles,
                                       sstride, scan, s);
  if (dtype == rq::kBF16)
    return (int)rq::launch_gemv<__nv_bfloat16>(x, packed, scale, y, E, M, N, K, kp, bits, splits,
                                               tiles, sstride, scan, s);
  return (int)cudaErrorInvalidValue;
}

// y (M, N) in x's type; x (M, K); packed (N, kp) int8; scale (N,) f32;
// splits the K ranges (kernels/quant_gemv/kernel.py plan: a function of K),
// tiles the 16-row tiles of each warp (128 * tiles channels a CTA).
extern "C" int rq_quant_gemv(const void* x, const void* packed, const void* scale, void* y,
                             int M, int N, int K, int kp, int bits, int dtype, int splits,
                             int tiles, void* stream) {
  return gemv_entry(x, packed, scale, y, 1, M, N, K, kp, bits, dtype, splits, tiles, 0, false,
                    stream);
}

// The expert stack: y (E, M, N); x (E, M, K); packed (E, N, kp); the scale
// (N,) shared (sstride 0) or (E, N) (sstride N); the 2-D plan's splits, the
// stack's own tiles (kernels/quant_gemv/kernel.py plan).
extern "C" int rq_quant_gemv_experts(const void* x, const void* packed, const void* scale,
                                     void* y, int E, int M, int N, int K, int kp, int bits,
                                     int dtype, int splits, int tiles, long long sstride,
                                     void* stream) {
  return gemv_entry(x, packed, scale, y, E, M, N, K, kp, bits, dtype, splits, tiles, sstride,
                    true, stream);
}
