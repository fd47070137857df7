// quant_matmul: y[m, n] = scale[n] * sum_k x[m, k] * level[n, k], for M > 8.
//
// Replaces the TPU kernel quant_matmul_pallas (repro/kernels/quant_matmul/
// kernel.py:68, pallas_call at :99): the prefill, chunk and verify linear.
//
// Bound on the H100 (one gemma-2b layer's four fused linears, 4-bit weights,
// bf16 x): at M = 32 the bytes, 55 MB of packed weights, 0.0165 ms at 3.35
// TB/s; at M = 128 and 2560 the operations, 28.2 and 564 GFLOP, 0.0285 and
// 0.570 ms at 989 TFLOP/s.
//
// Design, against the five faults of the CUDA-core body it replaces:
//  * Tensor cores.  wgmma.mma_async on bf16 operands with f32 accumulators,
//    "swap AB": y.T = W . x.T, so the output channels fill wgmma's 64-row M
//    side (64 per warpgroup) and the token rows are its N, the token tile
//    NT in {32, 64, 128, 256}: M = 32 costs a 32-wide instruction, not a
//    64-row tile half of zeros.
//  * Levels, not weights.  Integer levels lie in [-128, 127] and are exact
//    in bf16; each thread unpacks its A fragment straight from the packed
//    bytes in shared memory into bf16 registers (2 and 4 bits by the bf16
//    128 + u trick, 6 and 8 bits by 2^23 + u in f32), one load per row and
//    k16 step whatever the width.  scale[n] multiplies the f32 sum once, in
//    the epilogue, as the GEMV does (quant_gemv.cuh).  f32 x is split into
//    three bf16 pieces, hi + mid + lo = x exactly for normal values, and
//    runs three exact products: f32 accuracy without TF32.  (The tensor
//    cores' own f32 accumulation loses low bits over a long sum, so f32 x
//    sums one step on them and adds the steps in CUDA-core f32.)
//  * x stays in its type in shared memory: bf16 x lands by TMA in the
//    128-byte-swizzled B tile that wgmma reads; f32 x is staged and split.
//  * Copies overlap the products.  TMA fills a ring of 4-8 x stages, one
//    k-step each, and a ring of 3 packed-weight chunks, 128 bytes of every
//    row each (2-8 k-steps: long DRAM bursts, not one 16-64 byte piece per
//    row and step), each with its mbarrier; the warpgroups unpack step i+1
//    while the MMAs of step i run (A fragments double-buffered, wait_group
//    1).  Shapes whose rows are not 16-byte aligned (K % 8 for bf16, K % 4
//    for f32, kp % 16) fill the same rings by predicated loads.
//  * Enough blocks at small M.  K is cut into `splits` ranges (a function
//    of N and K alone); each range's sum starts from zero and the ranges'
//    sums are added in order.  While output tiles are few, or ranges long,
//    the ranges go to a cluster of CTAs whose partial sums meet in
//    distributed shared memory; else each CTA walks its ranges and folds
//    them in registers, which saves the cluster's exchange (wo from M =
//    2560, wqkv at 6144 and f32 x from 2560: 10-26 % less time on the
//    H100, chip_smoke.py's split-mode lines).
//    Either way the same bits, run to run and whatever M: no atomics, one
//    launch.
//
// Tiles: 128 channels (two warpgroups) x NT tokens for bf16 x, 64 x NT (one)
// for f32 x.  The grid walks channel tiles fastest, so the CTAs in flight
// share their x rows in L2 (w_down's x at M = 2560 is 84 MB, more than L2).
// The epilogue stages the tile in shared memory and writes four channels a
// store.
//
// The expert stack (rq_quant_matmul_experts) is the same kernel over x
// (E, C, K) and packed (E, N, kp): the TPU kernel under jax.vmap in the MoE
// layer's qt_matmul (repro/kernels/quant_matmul/ops.py:66-94), C > 8 (the
// prefill).  The experts are folded into grid y (E x the token tiles), since
// the cluster holds z; the tensor maps run over the flattened stacks, (E C,
// K) and (E N, kp), and a tile starts at its expert's row.  A tile that
// reaches past C tokens or N channels reads the next expert's rows into
// outputs it never stores (the epilogue masks token >= C and channel >= N),
// and past the last expert TMA fills zeros.  The split is the 2-D plan's, so
// an expert's outputs are the 2-D kernel's on its slice, bit for bit.
//
// What holds it back (timed on the H100 with parts of the kernel cut out,
// PERF.md section 6): one CTA per SM, so its launch, first copies and
// epilogue stall the tensor cores, and one CTA's MMA chain does not keep
// them busy at 128 tokens; at M in the thousands the copies from L2 come
// close to the products' time too.  A persistent CTA that overlaps a tile's epilogue
// with the next tile's loop is the next step.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cudaTypedefs.h>

#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace cg = cooperative_groups;

namespace rq {

constexpr int kBK = 64;           // K values per step: one 128-byte swizzled bf16 row
constexpr int kWChunk = 128;      // bytes of each packed row per weight chunk
constexpr int kWSlots = 3;        // weight chunks in flight

template <int CB> struct WTile {
  static constexpr int kLanes = 8 / CB;
  static constexpr int kRowBytes = kBK / kLanes;                // per step: 16, 32, 64
  static constexpr int kStepBytes = kRowBytes / 4;              // per k16 step: 4, 8, 16
  static constexpr int kSteps = kWChunk / kRowBytes;            // steps per chunk: 8, 4, 2
};

// Warpgroups per block: two (128 channels, so x is read from L2 once per
// 128 output channels) for bf16 x; one for f32 x, whose split pieces take
// the shared memory.
template <bool XF32> __host__ __device__ constexpr int wgs_of() { return XF32 ? 1 : 2; }

// x ring depth: as deep as a block's shared memory allows.
template <bool XF32, int NT> __host__ __device__ constexpr int stages_of() {
  return XF32 ? 4 : (NT == 256 ? 5 : (NT == 128 ? 8 : 6));
}

template <bool XF32, int NT>
struct Layout {
  static constexpr int kCh = 64 * wgs_of<XF32>();
  static constexpr int kStages = stages_of<XF32, NT>();
  static constexpr int kXRow = XF32 ? kBK * 4 : kBK * 2;         // bytes of one x row
  static constexpr int kX = NT * kXRow;                          // one x stage
  static constexpr int kW = kCh * kWChunk;                       // one weight chunk
  static constexpr int kPiece = NT * kBK * 2;                    // one bf16 B tile
  static constexpr int kPieces = XF32 ? 2 * 3 * kPiece : 0;      // hi, mid, lo, twice
  static constexpr int kWOff = kStages * kX;
  static constexpr int kPOff = kWOff + kWSlots * kW;
  static constexpr int kBOff = kPOff + kPieces;
  static constexpr int kBytes = 1024 + kBOff + 8 * (kStages + kWSlots);
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

// The A fragment of k16 step j of chunk step q for this thread: channel
// rows r0 (g) and r1 (g + 8) of its warp, values 2t, 2t+1 (regs 0, 1) and
// 2t+8, 2t+9 (regs 2, 3) of the step.  The chunk's rows are 128 bytes in
// the 128-byte swizzle (16-byte unit u of row r at u ^ (r % 8)).
template <int CB>
__device__ __forceinline__ void load_a(const uint8_t* chunk, int r0, int q, int j, int t,
                                       uint32_t (&a)[4]) {
  const int o = q * WTile<CB>::kRowBytes + j * WTile<CB>::kStepBytes;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    const uint8_t* p = chunk + row * kWChunk + ((((o >> 4) ^ row) & 7) << 4) + (o & 15);
    uint32_t p0, p1;
    if constexpr (CB == 8) {        // 16 bytes: value v at byte v
      const uint4 w = *reinterpret_cast<const uint4*>(p);
      const int sh = 16 * (t & 1);
      p0 = ((t >> 1) ? w.y : w.x) >> sh;
      p1 = ((t >> 1) ? w.w : w.z) >> sh;
    } else if constexpr (CB == 4) { // 8 bytes: values 2t, 2t+1 at byte t
      const uint2 w = *reinterpret_cast<const uint2*>(p);
      p0 = w.x >> (8 * t);
      p1 = w.y >> (8 * t);
    } else {                        // 4 bytes: values 2t, 2t+1 at nibble t
      const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
      p0 = w >> (4 * t);
      p1 = w >> (16 + 4 * t);
    }
    a[h] = levels_bf16x2<CB>(p0);
    a[2 + h] = levels_bf16x2<CB>(p1);
  }
}

// The path for rows that are not 16-byte aligned: predicated loads, zeros
// outside, in the layouts the TMA path leaves.  x step `it` (K values 64 it
// ..) of rows tok0.. into an x stage:
template <bool XF32, int NT, typename T>
__device__ void load_x_any(uint8_t* stage, const T* __restrict__ x, int M, int K, int tok0, int it) {
  constexpr int CHUNKS = Layout<XF32, NT>::kXRow / 16, PER = 16 / sizeof(T);
  const int k0 = it * kBK;
  for (int id = threadIdx.x; id < NT * CHUNKS; id += blockDim.x) {
    const int r = id / CHUNKS, c = id % CHUNKS;
    const int tok = tok0 + r, k = k0 + c * PER;
    // bf16: the swizzled B tile (unit c of row r at c ^ (r % 8)); f32: plain rows
    uint8_t* dst = stage + (XF32 ? r * Layout<XF32, NT>::kXRow + c * 16 : r * 128 + ((c ^ (r & 7)) << 4));
    alignas(16) T v[PER];
#pragma unroll
    for (int e = 0; e < PER; ++e)
      v[e] = (tok < M && k + e < K) ? x[(size_t)tok * K + k + e] : from_f<T>(0.f);
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
  }
}
// and the packed chunk from byte b0 of rows ch0.. into a weight slot.
__device__ __forceinline__ void load_w_any(uint8_t* slot, const uint8_t* __restrict__ packed,
                                           int N, int kp, int ch0, int rows, int b0) {
  for (int id = threadIdx.x; id < rows * (kWChunk / 16); id += blockDim.x) {
    const int r = id / (kWChunk / 16), c = id % (kWChunk / 16);
    const int n = ch0 + r, b = b0 + c * 16;
    alignas(16) uint8_t v[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) v[e] = (n < N && b + e < kp) ? packed[(size_t)n * kp + b + e] : 0;
    *reinterpret_cast<uint4*>(slot + r * kWChunk + (((c ^ r) & 7) << 4)) =
        *reinterpret_cast<const uint4*>(v);
  }
}

// f32 x: split a staged step into hi, mid and lo bf16 B tiles (swizzled),
// by the `threads` consumer threads.
template <int NT>
__device__ void split_f32(const uint8_t* staged, uint8_t* pieces, int threads) {
  constexpr int PIECE = NT * kBK * 2;
  for (int id = threadIdx.x; id < NT * 8; id += threads) {
    const int r = id / 8, c = id % 8;
    const float4* src = reinterpret_cast<const float4*>(staged + r * (kBK * 4) + c * 32);
    const float4 u = src[0], w = src[1];
    const float v[8] = {u.x, u.y, u.z, u.w, w.x, w.y, w.z, w.w};
    uint32_t hi[4], mid[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float h[2], m[2], l[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float xv = v[2 * e + q];
        h[q] = __bfloat162float(__float2bfloat16_rn(xv));
        const float r1 = __fsub_rn(xv, h[q]);
        m[q] = __bfloat162float(__float2bfloat16_rn(r1));
        l[q] = __fsub_rn(r1, m[q]);
      }
      hi[e] = bf16x2_bits(h[0], h[1]);
      mid[e] = bf16x2_bits(m[0], m[1]);
      lo[e] = bf16x2_bits(l[0], l[1]);
    }
    const int off = r * 128 + ((c ^ (r & 7)) << 4);
    *reinterpret_cast<uint4*>(pieces + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(pieces + PIECE + off) = make_uint4(mid[0], mid[1], mid[2], mid[3]);
    *reinterpret_cast<uint4*>(pieces + 2 * PIECE + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// K is cut into `splits` ranges of steps, range r = [r nk / splits, (r+1) nk
// / splits) of nk = ceil(K / 64).  grid (ceil(N / ch), E x mtiles (mtiles =
// ceil(M / NT); E = 1 for a 2-D weight), cluster): with cluster = splits, rank r sums range r and the ranks meet in
// distributed shared memory; with cluster = 1 the block walks the ranges
// itself, folding each into a running sum in registers (NT <= 128).
template <int CB, bool XF32, int NT, typename T>
__global__ void __launch_bounds__(128 * wgs_of<XF32>(), 1)
quant_matmul_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap wmap, const T* __restrict__ x,
                    const uint8_t* __restrict__ packed, const float* __restrict__ scale,
                    T* __restrict__ y, int M, int N, int K, int kp, int splits, int vec,
                    int mtiles, long long sstride) {
  using L = Layout<XF32, NT>;
  constexpr int CH = L::kCh, S = L::kStages, RB = WTile<CB>::kRowBytes, WK = WTile<CB>::kSteps;
  constexpr int R = NT / 2;                       // accumulators per thread
  constexpr int PIECES = XF32 ? 3 : 1;
  constexpr bool FOLD = NT <= 128;                // a running sum fits in registers
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* wring = smem + L::kWOff;
  uint8_t* pieces = smem + L::kPOff;
  uint64_t* xfull = reinterpret_cast<uint64_t*>(smem + L::kBOff);
  uint64_t* wfull = xfull + S;
  cg::cluster_group cluster = cg::this_cluster();

  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = wg * 64 + warp * 16 + g;       // this thread's first channel row
  const int ex = blockIdx.y / mtiles;             // the expert (0 for a 2-D weight)
  const int tok0 = (blockIdx.y - ex * mtiles) * NT, ch0 = blockIdx.x * CH;
  x += (size_t)ex * M * K;
  packed += (size_t)ex * N * kp;
  y += (size_t)ex * M * N;
  scale += ex * sstride;
  const int csize = gridDim.z;
  const int rank = csize > 1 ? (int)cluster.block_rank() : 0;
  const int nk = (K + kBK - 1) / kBK;
  int r = csize > 1 ? rank : 0;                   // the range being summed
  const int r_end = csize > 1 ? rank + 1 : splits;
  const int kb = r * nk / splits, n_it = r_end * nk / splits - kb;
  const int n_chunks = (n_it + WK - 1) / WK;
  int r_last = (r + 1) * nk / splits - kb - 1;    // its last step, counted from kb
  int r_first = 0;                                // its first step
  bool folded = false;

  auto xstage = [&](int i) { return smem + (i % S) * L::kX; };
  auto wslot = [&](int c) { return wring + (c % kWSlots) * L::kW; };
  auto load_x = [&](int i) {
    if (!vec) {
      load_x_any<XF32, NT, T>(xstage(i), x, M, K, tok0, kb + i);
    } else if (threadIdx.x == 0) {
      mbar_expect_tx(xfull + i % S, L::kX);
      tma_load_2d(xstage(i), &xmap, (kb + i) * kBK, ex * M + tok0, xfull + i % S);
    }
  };
  auto load_w = [&](int c) {
    const int b0 = (kb + c * WK) * RB;
    if (!vec) {
      load_w_any(wslot(c), packed, N, kp, ch0, CH, b0);
    } else if (threadIdx.x == 0) {
      mbar_expect_tx(wfull + c % kWSlots, L::kW);
      tma_load_2d(wslot(c), &wmap, b0, ex * N + ch0, wfull + c % kWSlots);
    }
  };

  float acc[R], run[FOLD ? R : 1], racc[XF32 ? R : 1];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.f;
  uint32_t a[2][4][4];

  // Unpack step i's A fragments into a[P] (f32 x: split its x first).
  auto prepare = [&](int i, auto P) {
    const int c = i / WK;
    if (vec && i % WK == 0) mbar_wait(wfull + c % kWSlots, (c / kWSlots) & 1);
    if constexpr (XF32) {
      split_f32<NT>(xstage(i), pieces + (i & 1) * 3 * L::kPiece, blockDim.x);
      fence_async_smem();
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) load_a<CB>(wslot(c), row0, i % WK, j, t, a[decltype(P)::value][j]);
  };
  auto issue = [&](int i, auto P) {
    const uint32_t base = smem_u32(XF32 ? pieces + (i & 1) * 3 * L::kPiece : xstage(i));
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int p = 0; p < PIECES; ++p)
        wgmma_rs(acc, a[decltype(P)::value][j], sw128_desc(base + p * L::kPiece + j * 32));
    wgmma_commit();
    fence_operands(acc);
  };
  // One step: the MMAs of i, then (while they run) the copies that reuse
  // what step i-1 and chunk i/WK held, and the unpacking of i+1.  At a
  // range's last step, wait for all and fold the range's sum.
  auto step = [&](int i, auto P, auto Q) {
    issue(i, P);
    if constexpr (XF32) {
      // f32 x: each step's 192 exact products are summed on the tensor cores
      // from zero, and the steps' sums in f32 adds (each rounded to nearest)
      // into the range's sum, so the tensor cores' accumulation never carries
      // a whole range: f32 error near a CUDA-core f32 GEMM's
      wgmma_wait<0>();
      fence_operands(acc);
      const bool last = i == r_last;
#pragma unroll
      for (int e = 0; e < (XF32 ? R : 1); ++e) {
        racc[e] = i == r_first ? acc[e] : racc[e] + acc[e];
        acc[e] = 0.f;
        if (last) run[e] = folded ? run[e] + racc[e] : racc[e];
      }
      if (last) {
        folded = true;
        ++r;
        r_first = i + 1;
        r_last = (r + 1) * nk / splits - kb - 1;
      }
    } else if (FOLD && i == r_last) {
      wgmma_wait<0>();
      fence_operands(acc);
#pragma unroll
      for (int e = 0; e < (FOLD ? R : 1); ++e) {
        run[e] = folded ? run[e] + acc[e] : acc[e];
        acc[e] = 0.f;
      }
      folded = true;
      ++r;
      r_last = (r + 1) * nk / splits - kb - 1;
    } else {
      wgmma_wait<1>();               // step i-1's MMAs are done with their x stage
    }
    fence_operands(acc);
    if (i + 1 < n_it) {
      if (vec) mbar_wait(xfull + (i + 1) % S, ((i + 1) / S) & 1);
      fence_async_smem();
      __syncthreads();
      if (i + S - 1 < n_it) load_x(i + S - 1);
      if (i % WK == WK - 1 && i / WK + kWSlots < n_chunks) load_w(i / WK + kWSlots);
      prepare(i + 1, Q);
    }
  };

  if (vec && threadIdx.x == 0) {
    for (int s = 0; s < S + kWSlots; ++s) mbar_init(xfull + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  using P0 = std::integral_constant<int, 0>;
  using P1 = std::integral_constant<int, 1>;
  if (n_it > 0) {
    load_w(0);                      // what the first unpacking needs, first
    for (int s = 0; s < S - 1 && s < n_it; ++s) load_x(s);
    for (int c = 1; c < kWSlots && c < n_chunks; ++c) load_w(c);
    if (vec && XF32) mbar_wait(xfull, 0);
    fence_async_smem();
    __syncthreads();
    prepare(0, P0{});
    if (vec && !XF32) mbar_wait(xfull, 0);
#pragma unroll 1
    for (int i = 0; i < n_it; i += 2) {
      step(i, P0{}, P1{});
      if (i + 1 < n_it) step(i + 1, P1{}, P0{});
    }
    wgmma_wait<0>();
    fence_operands(acc);
  }
  __syncthreads();    // every stage consumed: the rings are free for the epilogue

  // Epilogue: the unscaled sums into shared memory, channel-fastest rows of
  // CH + 4 floats; then each rank takes its share of the tile, sums it over
  // the ranks in order 0, 1, ... (distributed shared memory), scales and
  // writes it.
  float* red = reinterpret_cast<float*>(smem);
  constexpr int RS = CH + 4;
  auto stash = [&](const auto& v) {
#pragma unroll
    for (int i = 0; i < NT / 8; ++i) {
      const int tk = 8 * i + 2 * t;
      red[tk * RS + row0] = v[4 * i];
      red[(tk + 1) * RS + row0] = v[4 * i + 1];
      red[tk * RS + row0 + 8] = v[4 * i + 2];
      red[(tk + 1) * RS + row0 + 8] = v[4 * i + 3];
    }
  };
  if constexpr (FOLD) stash(run); else stash(acc);
  if (csize > 1) cluster.sync(); else __syncthreads();
  constexpr int Q4 = CH / 4, TOTAL4 = NT * Q4;
  // rows of y and scale 16-byte aligned at every fourth channel
  const bool wide = N % 4 == 0 && (reinterpret_cast<uintptr_t>(scale) & 15) == 0 &&
                    (reinterpret_cast<uintptr_t>(y) & 15) == 0;
  for (int e = rank * TOTAL4 / csize + (int)threadIdx.x; e < (rank + 1) * TOTAL4 / csize;
       e += blockDim.x) {
    const int tk = e / Q4, c = (e % Q4) * 4;
    const int tok = tok0 + tk;
    if (tok >= M) continue;
    float* own = red + tk * RS + c;
    float4 v;
    if (csize == 1) {
      v = *reinterpret_cast<const float4*>(own);
    } else {
      float4 part[8];                  // all ranks' loads in flight, then the sum in order
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (q < csize) part[q] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(own, q));
      v = part[0];
#pragma unroll
      for (int q = 1; q < 8; ++q)
        if (q < csize) {
          v.x += part[q].x; v.y += part[q].y; v.z += part[q].z; v.w += part[q].w;
        }
    }
    const int n = ch0 + c;
    T* out = y + (size_t)tok * N + n;
    if (wide && n + 3 < N) {        // four channels in one store
      const float4 sc = *reinterpret_cast<const float4*>(scale + n);
      store4(out, v.x * sc.x, v.y * sc.y, v.z * sc.z, v.w * sc.w);
    } else {
      const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int l = 0; l < 4; ++l)
        if (n + l < N) out[l] = from_f<T>(vs[l] * scale[n + l]);
    }
  }
  if (csize > 1) cluster.sync();   // keep every rank's partials alive until read
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
  int type, rows, cols, box_rows, box_cols, swizzle;
  bool operator==(const MapKey& o) const {
    return base == o.base && type == o.type && rows == o.rows && cols == o.cols &&
           box_rows == o.box_rows && box_cols == o.box_cols && swizzle == o.swizzle;
  }
};

// A row-major (rows, cols) tensor of `elem`-byte values as boxes of
// (box_rows, box_cols).  Encoding costs host time on every launch, so the
// maps are kept in a direct-mapped cache: a layer's weights give the same
// key on every call, and x often does (the allocator reuses its buffers).
inline bool encode_2d(CUtensorMap* map, CUtensorMapDataType type, int elem, const void* base,
                      int rows, int cols, int box_rows, int box_cols, CUtensorMapSwizzle swizzle) {
  constexpr int kSlots = 512;
  struct Slot { MapKey key; CUtensorMap map; bool full; };
  thread_local Slot cache[kSlots] = {};
  const MapKey key{base, (int)type, rows, cols, box_rows, box_cols, (int)swizzle};
  Slot& slot = cache[(reinterpret_cast<uintptr_t>(base) >> 4 ^ (uintptr_t)rows * 31 ^
                      (uintptr_t)box_rows * 7) % kSlots];
  if (slot.full && slot.key == key) {
    *map = slot.map;
    return true;
  }
  auto encode = tensor_map_encoder();
  if (!encode) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  if (encode(map, type, 2, const_cast<void*>(base), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  slot = Slot{key, *map, true};
  return true;
}

template <int CB, bool XF32, int NT, typename T>
cudaError_t launch_nt(const void* x, const void* packed, const void* scale, void* y, int E,
                      int M, int N, int K, int kp, int wgs, int splits, int csize, int vec,
                      long long sstride, cudaStream_t stream) {
  using L = Layout<XF32, NT>;
  static_assert(L::kBytes <= 232448, "a block's shared memory");
  static_assert(NT * (L::kCh + 4) * 4 <= L::kPOff,
                "the epilogue's partial sums fit in the ring");
  // a block sums one range, or (cluster 1) walks them all with a running sum
  if (wgs != wgs_of<XF32>() || (csize != 1 && csize != splits) ||
      (csize == 1 && splits > 1 && NT > 128))
    return cudaErrorInvalidValue;
  auto kernel = quant_matmul_kernel<CB, XF32, NT, T>;
  static bool sized = false;        // set once per kernel
  cudaError_t err;
  if (!sized) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  CUtensorMap xmap = {}, wmap = {};
  if (vec) {
    // x: boxes of NT rows x 64 values (bf16 in the 128-byte swizzle wgmma
    // reads); packed: boxes of 128 (64) rows x 128 bytes, swizzled the same way;
    // an expert stack as its E M and E N rows
    if (!encode_2d(&xmap, XF32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                   sizeof(T), x, E * M, K, NT, kBK,
                   XF32 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B) ||
        !encode_2d(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, packed, E * N, kp, L::kCh, kWChunk,
                   CU_TENSOR_MAP_SWIZZLE_128B))
      return cudaErrorInvalidValue;
  }
  cudaLaunchConfig_t cfg = {};
  const int mtiles = (M + NT - 1) / NT;
  cfg.gridDim = dim3((unsigned)((N + L::kCh - 1) / L::kCh), (unsigned)(E * mtiles),
                     (unsigned)csize);
  cfg.blockDim = dim3(128 * wgs_of<XF32>());
  cfg.dynamicSmemBytes = L::kBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = (unsigned)csize;
  cfg.attrs = attr;
  cfg.numAttrs = csize > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, xmap, wmap, static_cast<const T*>(x),
                           static_cast<const uint8_t*>(packed), static_cast<const float*>(scale),
                           static_cast<T*>(y), M, N, K, kp, splits, vec, mtiles, sstride);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int CB>
cudaError_t launch_cb(const void* x, const void* packed, const void* scale, void* y, int E, int M,
                      int N, int K, int kp, int dtype, int nt, int wgs, int splits, int csize,
                      int vec, long long ss, cudaStream_t s) {
  using B = __nv_bfloat16;
#define RQ_NT(XF, NTV, TT) \
  launch_nt<CB, XF, NTV, TT>(x, packed, scale, y, E, M, N, K, kp, wgs, splits, csize, vec, ss, s)
  if (dtype == kF32) {
    if (nt == 32) return RQ_NT(true, 32, float);
    if (nt == 64) return RQ_NT(true, 64, float);
    return cudaErrorInvalidValue;
  }
  if (nt == 32) return RQ_NT(false, 32, B);
  if (nt == 64) return RQ_NT(false, 64, B);
  if (nt == 128) return RQ_NT(false, 128, B);
  if (nt == 256) return RQ_NT(false, 256, B);
#undef RQ_NT
  return cudaErrorInvalidValue;
}

}  // namespace rq

// Both entry points: E experts of x (E, M, K) against packed (E, N, kp), the
// scale of expert e at scale + e * sstride (sstride 0 or N).  The launch
// plan (token tile nt, warpgroups wgs, K ranges splits, cluster size csize: 1
// or splits) comes from the wrapper; TMA is taken where every row start is
// 16-byte aligned.
static int matmul_entry(const void* x, const void* packed, const void* scale, void* y, int E,
                        int M, int N, int K, int kp, int bits, int dtype, int nt, int wgs,
                        int splits, int csize, long long sstride, void* stream) {
  if (E < 1 || M < 1 || N < 1 || K < 1 || (bits != 2 && bits != 4 && bits != 6 && bits != 8) ||
      kp != (K + rq::lanes_of(bits) - 1) / rq::lanes_of(bits) || wgs < 1 || wgs > 2 ||
      splits < 1 || splits > 8 || splits > (K + 63) / 64 ||
      (dtype != rq::kF32 && dtype != rq::kBF16) || (sstride != 0 && sstride != N) ||
      (long long)E * ((M + nt - 1) / (nt < 1 ? 1 : nt)) > 65535)
    return (int)cudaErrorInvalidValue;
  const int xalign = dtype == rq::kF32 ? 4 : 8;
  const int vec = K % xalign == 0 && kp % 16 == 0 &&
                  (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                  (reinterpret_cast<uintptr_t>(packed) & 15) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 2: return (int)rq::launch_cb<2>(x, packed, scale, y, E, M, N, K, kp, dtype, nt, wgs, splits, csize, vec, sstride, s);
    case 4: return (int)rq::launch_cb<4>(x, packed, scale, y, E, M, N, K, kp, dtype, nt, wgs, splits, csize, vec, sstride, s);
    default: return (int)rq::launch_cb<8>(x, packed, scale, y, E, M, N, K, kp, dtype, nt, wgs, splits, csize, vec, sstride, s);
  }
}

// y (M, N) in x's type; x (M, K); packed (N, kp) int8; scale (N,) f32.
extern "C" int rq_quant_matmul(const void* x, const void* packed, const void* scale, void* y,
                               int M, int N, int K, int kp, int bits, int dtype, int nt, int wgs,
                               int splits, int csize, void* stream) {
  return matmul_entry(x, packed, scale, y, 1, M, N, K, kp, bits, dtype, nt, wgs, splits, csize,
                      0, stream);
}

// The expert stack: y (E, M, N); x (E, M, K); packed (E, N, kp); the scale
// (N,) shared (sstride 0) or (E, N) (sstride N); the 2-D plan's splits.
extern "C" int rq_quant_matmul_experts(const void* x, const void* packed, const void* scale,
                                       void* y, int E, int M, int N, int K, int kp, int bits,
                                       int dtype, int nt, int wgs, int splits, int csize,
                                       long long sstride, void* stream) {
  return matmul_entry(x, packed, scale, y, E, M, N, K, kp, bits, dtype, nt, wgs, splits, csize,
                      sstride, stream);
}
