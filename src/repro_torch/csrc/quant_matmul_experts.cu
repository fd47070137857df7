// quant_matmul_experts: the expert stack's GEMM (row 2e), for C > 8:
// y[e, c, n] = scale[e, n] * sum_k x[e, c, k] * level[e, n, k].
//
// Replaces the TPU kernel quant_matmul_pallas (repro/kernels/quant_matmul/
// kernel.py:68) under jax.vmap over the experts, as the MoE layer's
// qt_matmul maps it (repro/kernels/quant_matmul/ops.py:66-94), C > 8: the
// expert linears of an MoE prefill, admission or verify pass.
//
// Which body serves which dtype: bf16 x runs the persistent kernel below;
// f32 x (three bf16 pieces a value) runs the 2-D GEMM's tiled kernel with the
// experts folded into its grid (quant_matmul.cu, matmul_entry), as before.
//
// Bound on the H100 (deepseek-moe-16b's three expert linears of a layer, 64
// experts, 4-bit weights, bf16 x): at C 16 the bytes, 0.089 ms for the
// packed stacks at 3.35 TB/s; from C 128 on the operations, 0.143 ms at C
// 128 and 1.43 ms at C 1280 at 989 TFLOP/s.
//
// The contract: an expert's outputs are the 2-D kernel's on its slice, byte
// for byte, at every C.  So the arithmetic is the 2-D kernel's: the K ranges
// of split_of(N, K), each summed from zero on the tensor cores in k16 order
// (wgmma with the levels as the A operand in registers, x as B), the ranges'
// sums added in f32 in order 0, 1, ..., scale[n] applied once at the end,
// the levels' bf16 bits levels_bf16x2's (quant_matmul.cuh; 4 and 8 bits in
// fewer instructions, below).  No atomics: the same bits run to run and
// whatever the CTA count.
//
// Design (the shape of hopper-kernels section 1):
//  * Persistent CTAs over a tile list.  A tile is (expert, token tile,
//    channel tile), channel tiles fastest within an expert's token tile, so
//    the CTAs in flight share that x in L2.  The grid is at most one CTA an
//    SM; CTA b walks tiles b, b + grid, ...
//  * Warp specialization.  Warpgroup 0 is the producer (setmaxnreg down to
//    40): thread 0 keeps TMA loads of x stages (NT tokens x 64 K values, the
//    128-byte-swizzled B tile) in flight, thread 32 those of packed-weight
//    chunks (128 bytes of each row of the tile), each on its own full/empty
//    mbarrier ring that runs across tile boundaries, so the next tile's
//    loads start while this tile's MMAs and epilogue run.  Warpgroups 1 and
//    2 are the consumers (setmaxnreg up to 232), half the tile's channels
//    each: they unpack A from the weight chunk into registers (three buffers:
//    step i+1 is unpacked while steps i and i-1 run) and issue wgmma RS, and
//    free each stage once the MMAs that read it are done.  Rows that are not
//    16-byte aligned (K % 8, kp % 16) are filled by the producer warpgroup's
//    128 threads with predicated loads instead.
//  * An epilogue that does not stop the stream: each consumer warpgroup
//    scales its sums, stages them as bf16 in a buffer of its own (not the
//    rings) and writes 8 channels a store; only its own 128 threads sync.
//  * A token tile fitted to C: NT 16 (wgmma m64n16k16) for C <= 16, so an
//    admission's tile reads only its own expert's x; 32, 64, then 128 (C
//    above 128 walks token tiles of 128).  The tensor maps are 3-D (K or
//    kp, rows, experts), so a tile never reads the next expert's rows: past
//    C tokens TMA fills zeros.  Up to 32 tokens a tile is 256 channels (two
//    64-channel blocks a warpgroup): the same waits and frees for twice the
//    MMAs, 23 % less time at C 16 on the H100.
//  * The fold: after a range's steps the consumer waits for its MMAs
//    (wgmma_wait 0), adds the range's sum into the running sum and starts
//    the next range from zero, outside the K loop (folding inside it, under
//    the tile loop, made ptxas serialize every wgmma).  Both warpgroups
//    drain together, once a range (4 ranges of 8 steps for w_gate/w_up, 2
//    of 11 for w_down): 12 % of the time at C 1280.  A second accumulator
//    set would need more registers than 232 at NT 128.
//
// What holds it back at C 1280 (PERF.md section 6: timing-only variants,
// tools/gemm_variants.py): the x tiles' stream from L2 into 11 (16)
// channel tiles alone takes 0.78 of torch.bmm's time, and the unpack, the
// MMAs and that stream add up rather than overlap: 1.38x torch.bmm.
//
// Empty experts are not skipped (row 1e skips them): an admission's capacity
// buffer holds a token in nearly every expert (60-128 tokens x 6 over 64),
// and from C 128 on, proving an expert's x all zero costs more bytes (C x K
// x 2) than its packed weights.
#include <type_traits>

#include "common.cuh"
#include "quant_matmul.cuh"
#include "wgmma.cuh"

namespace rq {
namespace experts {

constexpr int kConsumers = 2;                    // consumer warpgroups
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

// 64-channel wgmma blocks a consumer warpgroup takes: two at the narrow
// token tiles (a tile of 256 channels, whose steps carry twice the MMAs for
// the same waits and frees), one from 64 tokens on (the registers).
__host__ __device__ constexpr int blocks_of(int nt) { return nt <= 32 ? 2 : 1; }

// Shared memory: the x ring, the weight ring, each consumer's epilogue
// buffer, then the mbarriers.  Narrow tiles are memory-bound: more weight
// bytes in flight.
template <int NT>
struct Ring {
  static constexpr int kCh = 64 * kConsumers * blocks_of(NT);   // channels a tile
  static constexpr int kStages = NT == 128 ? 8 : (NT == 64 ? 10 : (NT == 32 ? 12 : 16));
  static constexpr int kWSlots = NT == 128 ? 3 : 4;
  static constexpr int kX = NT * kBK * 2;                        // one x stage (bf16)
  static constexpr int kW = kCh * kWChunk;                       // one weight chunk
  static constexpr int kERow = kCh / kConsumers + 8;             // a staged token row (bf16)
  static constexpr int kE = NT * kERow * 2;                      // one consumer's epilogue
  static constexpr int kWOff = kStages * kX;
  static constexpr int kEOff = kWOff + kWSlots * kW;
  static constexpr int kBOff = kEOff + kConsumers * kE;
  static constexpr int kBytes = 1024 + kBOff + 8 * 2 * (kStages + kWSlots);
};

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}
// One arrival for the warp, once all its lanes are done with the slot.
__device__ __forceinline__ void warp_arrive(uint64_t* bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}
// One warpgroup's barrier (ids 1 and 2; 0 is __syncthreads).
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}
__device__ __forceinline__ uint32_t and_xor(uint32_t a, uint32_t m, uint32_t x) {   // (a & m) ^ x
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0x6A;\n" : "=r"(d) : "r"(a), "r"(m), "r"(x));
  return d;
}

// levels_bf16x2 (quant_matmul.cuh) in fewer instructions, the same bits:
// 4-bit levels from a byte alone in the low bits (a prmt picked it), the
// mask and the bias in one lop3;
__device__ __forceinline__ uint32_t levels4(uint32_t byte) {
  const uint32_t w = and_xor(byte * 0x1001u, 0x000F000Fu, 0x43084308u);
  const __nv_bfloat162 v = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&w),
                                   __halves2bfloat162(__ushort_as_bfloat16((unsigned short)0x4308),
                                                      __ushort_as_bfloat16((unsigned short)0x4308)));
  return *reinterpret_cast<const uint32_t*>(&v);
}
// 8-bit levels from two bytes in the low half: 2^23 + (byte ^ 0x80) built by prmt.
__device__ __forceinline__ uint32_t levels8(uint32_t pair) {
  const uint32_t u = pair ^ 0x8080u;
  const float lo = __uint_as_float(prmt(u, 0x4B000000u, 0x7440)) - 8388736.f;
  const float hi = __uint_as_float(prmt(u, 0x4B000000u, 0x7441)) - 8388736.f;
  return bf16x2_bits(lo, hi);
}

// The A fragments of step q of a weight chunk for this thread, all four k16
// steps j at once (quant_matmul.cu's load_a, one j a call): `rowp` is its
// first row (g) in the chunk, the second 8 rows on; both rows' 16-byte units
// sit at u ^ g (the 128-byte swizzle), so a row's bytes of the step come in
// RowBytes / 16 loads.
template <int CB>
__device__ __forceinline__ void unpack_step(const uint8_t* rowp, int q, int g, int t,
                                            uint32_t (&a)[4][4]) {
  constexpr int U = WTile<CB>::kRowBytes / 16;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint4 u[U];
#pragma unroll
    for (int v = 0; v < U; ++v)
      u[v] = *reinterpret_cast<const uint4*>(rowp + h * 8 * kWChunk + (((q * U + v) ^ g) << 4));
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if constexpr (CB == 8) {       // unit j: values 2t, 2t+1 at bytes 2t, 2t+1 of (x, y)
        const uint32_t sel = (2 * t) | ((2 * t + 1) << 4);
        a[j][h] = levels8(prmt(u[j].x, u[j].y, sel));
        a[j][2 + h] = levels8(prmt(u[j].z, u[j].w, sel));
      } else if constexpr (CB == 4) {  // 8 bytes at 8 (j % 2) of unit j / 2: byte t
        const uint32_t w0 = j & 1 ? u[j >> 1].z : u[j >> 1].x;
        const uint32_t w1 = j & 1 ? u[j >> 1].w : u[j >> 1].y;
        a[j][h] = levels4(prmt(w0, 0, 0x4440 | t));
        a[j][2 + h] = levels4(prmt(w1, 0, 0x4440 | t));
      } else {                         // 4 bytes at 4 j: nibble t
        const uint32_t w = j == 0 ? u[0].x : (j == 1 ? u[0].y : (j == 2 ? u[0].z : u[0].w));
        a[j][h] = levels_bf16x2<CB>(w >> (4 * t));
        a[j][2 + h] = levels_bf16x2<CB>(w >> (16 + 4 * t));
      }
    }
  }
}

// Tile t of the list: expert, first token, first channel.
struct Tile {
  int ex, tok0, ch0;
};
__device__ __forceinline__ Tile tile_of(int t, int mtiles, int ctiles, int nt, int ch) {
  const int rest = t / ctiles;
  return Tile{rest / mtiles, (rest % mtiles) * nt, (t % ctiles) * ch};
}

template <int CB, int NT>
__global__ void __launch_bounds__(kThreads, 1)
quant_matmul_experts_kernel(const __grid_constant__ CUtensorMap xmap,
                            const __grid_constant__ CUtensorMap wmap,
                            const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ packed,
                            const float* __restrict__ scale, __nv_bfloat16* __restrict__ y,
                            int E, int M, int N, int K, int kp, int splits, int vec,
                            long long sstride) {
  using L = Ring<NT>;
  constexpr int S = L::kStages, WS = L::kWSlots, WK = WTile<CB>::kSteps, CH = L::kCh;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* wring = smem + L::kWOff;
  uint64_t* xfull = reinterpret_cast<uint64_t*>(smem + L::kBOff);
  uint64_t* xempty = xfull + S;
  uint64_t* wfull = xempty + S;
  uint64_t* wempty = wfull + WS;
  const int mtiles = (M + NT - 1) / NT, ctiles = (N + CH - 1) / CH;
  const int tiles = E * mtiles * ctiles;
  const int nk = (K + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    // full: TMA's one arrival and its bytes, or one a producer warp; empty:
    // one a consumer warp
    const int fills = vec ? 1 : 4;
    for (int s = 0; s < S; ++s) {
      mbar_init(xfull + s, fills);
      mbar_init(xempty + s, 4 * kConsumers);
    }
    for (int s = 0; s < WS; ++s) {
      mbar_init(wfull + s, fills);
      mbar_init(wempty + s, 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: the rings' next slots, tile after tile ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int tid = threadIdx.x;
    // TMA: thread 0 fills the x ring, thread 32 (another warp) the weight
    // ring, each as far ahead as its ring allows; the predicated loads: all
    // 128 threads fill both in step order.
    const bool fills_x = !vec || tid == 0, fills_w = !vec || tid == 32;
    if (!fills_x && !fills_w) return;
    int xs = 0, ws = 0;
    uint32_t xph = 0, wph = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const Tile tl = tile_of(t, mtiles, ctiles, NT, CH);
      for (int i = 0; i < nk; ++i) {
        if (fills_w && i % WK == 0) {       // the chunk of steps i .. i + WK - 1
          mbar_wait(wempty + ws, wph ^ 1);
          uint8_t* slot = wring + ws * L::kW;
          if (vec) {
            mbar_expect_tx(wfull + ws, L::kW);
            tma_load_3d(slot, &wmap, i / WK * kWChunk, tl.ch0, tl.ex, wfull + ws);
          } else {
            load_w_any(slot, packed + (size_t)tl.ex * N * kp, N, kp, tl.ch0, CH, i / WK * kWChunk,
                       tid, 128);
            warp_arrive(wfull + ws);
          }
          if (++ws == WS) {
            ws = 0;
            wph ^= 1;
          }
        }
        if (!fills_x) continue;
        mbar_wait(xempty + xs, xph ^ 1);
        uint8_t* stage = smem + xs * L::kX;
        if (vec) {
          mbar_expect_tx(xfull + xs, L::kX);
          tma_load_3d(stage, &xmap, i * kBK, tl.tok0, tl.ex, xfull + xs);
        } else {
          load_x_any<NT>(stage, x + (size_t)tl.ex * M * K, M, K, tl.tok0, i, tid, 128);
          fence_async_smem();       // wgmma reads the stage through the async proxy
          warp_arrive(xfull + xs);
        }
        if (++xs == S) {
          xs = 0;
          xph ^= 1;
        }
      }
    }
  } else {
    // ---- consumers: half the channels each (MB blocks of 64) of every tile ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    constexpr int R = NT / 2, MB = blocks_of(NT), WCH = 64 * MB;
    const int cw = wg - 1, ltid = threadIdx.x - 128 * wg;
    const int warp = ltid / 32, lane = ltid % 32, g = lane >> 2, t4 = lane & 3;
    const int lrow = warp * 16 + g;                // the thread's first channel of a block
    const int row0 = cw * WCH + lrow;              // ... of its first block in the tile
    __nv_bfloat16* staged = reinterpret_cast<__nv_bfloat16*>(smem + L::kEOff + cw * L::kE);
    const bool wide = N % 8 == 0 && (reinterpret_cast<uintptr_t>(y) & 15) == 0;
    int xs = 0, ws = 0, freed = 0;
    uint32_t xph = 0, wph = 0;
    float acc[MB][R], run[MB][R];
    uint32_t a[3][MB][4][4];                     // A fragments of three steps

    // Unpack step i's A fragments into a[P]; the chunk is freed at its last step.
    const uint8_t* rowp = wring + row0 * kWChunk;
    auto prepare = [&](int i, auto P) {
      const int q = i & (WK - 1);
      if (q == 0) mbar_wait(wfull + ws, wph);
#pragma unroll
      for (int b = 0; b < MB; ++b)
        unpack_step<CB>(rowp + ws * L::kW + b * 64 * kWChunk, q, g, t4,
                        a[decltype(P)::value][b]);
      if (q == WK - 1 || i == nk - 1) {
        warp_arrive(wempty + ws);
        if (++ws == WS) {
          ws = 0;
          wph ^= 1;
        }
      }
    };
    // Free the oldest x stage (its MMAs are done).
    auto free_x = [&]() {
      warp_arrive(xempty + freed);
      if (++freed == S) freed = 0;
    };
    auto fence_acc = [&]() {
#pragma unroll
      for (int b = 0; b < MB; ++b) fence_operands(acc[b]);
    };

    // One step: wait for its x stage and issue its MMAs; then, while they
    // and step i-1's run, free the stage of step i-2 (`older`: the range has
    // it) and unpack step i+1 into the fragments step i-2 used.
    auto step = [&](int i, bool older, auto P, auto Q) {
      mbar_wait(xfull + xs, xph);
      const uint64_t desc = sw128_desc(smem_u32(smem + xs * L::kX));
      if (++xs == S) {
        xs = 0;
        xph ^= 1;
      }
      fence_acc();
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int b = 0; b < MB; ++b) wgmma_rs(acc[b], a[decltype(P)::value][b][j], desc + 2 * j);
      wgmma_commit();
      fence_acc();
      wgmma_wait<2>();                // step i-2's MMAs are done with their stage
      fence_acc();
      if (older) free_x();
      if (i + 1 < nk) prepare(i + 1, Q);
    };
    using P0 = std::integral_constant<int, 0>;
    using P1 = std::integral_constant<int, 1>;
    using P2 = std::integral_constant<int, 2>;

    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const Tile tl = tile_of(t, mtiles, ctiles, NT, CH);
      prepare(0, P0{});
      // Each K range from zero, then (its MMAs waited for) folded into the
      // running sum; the fold reads the accumulators only after the range's
      // loop, as ptxas needs to keep the MMAs of a loop in flight together.
      for (int r = 0; r < splits; ++r) {
        const int i0 = r * nk / splits, i1 = (r + 1) * nk / splits;
        int i = i0;
#pragma unroll
        for (int b = 0; b < MB; ++b)
#pragma unroll
          for (int e = 0; e < R; ++e) acc[b][e] = 0.f;
#pragma unroll 1
        for (; i + 2 < i1; i += 3) {
          step(i, i >= i0 + 2, P0{}, P1{});
          step(i + 1, i >= i0 + 1, P1{}, P2{});
          step(i + 2, true, P2{}, P0{});
        }
        const int rest = i1 - i;      // 0, 1 or 2 steps
        if (rest > 0) step(i, i >= i0 + 2, P0{}, P1{});
        if (rest > 1) step(i + 1, i >= i0 + 1, P1{}, P2{});
        wgmma_wait<0>();
        fence_acc();
        free_x();                     // the range's last stage
        if (i1 - i0 > 1) free_x();    // and the one before
#pragma unroll
        for (int b = 0; b < MB; ++b) {
#pragma unroll
          for (int j = 0; j < 4; ++j)   // the next range starts from a[0]
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              if (rest == 1) a[0][b][j][q] = a[1][b][j][q];
              if (rest == 2) a[0][b][j][q] = a[2][b][j][q];
            }
#pragma unroll
          for (int e = 0; e < R; ++e) run[b][e] = r == 0 ? acc[b][e] : run[b][e] + acc[b][e];
        }
      }

      // Epilogue: scale, stage as bf16 (token rows of the consumer's WCH
      // channels), then 8 channels a store; the producer meanwhile fills the
      // next tile's stages.
      const float* sc = scale + tl.ex * sstride;
#pragma unroll
      for (int b = 0; b < MB; ++b) {
        const int na = tl.ch0 + row0 + 64 * b, nb = na + 8, col = lrow + 64 * b;
        const float sa = na < N ? sc[na] : 0.f, sb = nb < N ? sc[nb] : 0.f;
#pragma unroll
        for (int i = 0; i < NT / 8; ++i) {
          const int tk = 8 * i + 2 * t4;
          staged[tk * L::kERow + col] = from_f<__nv_bfloat16>(run[b][4 * i] * sa);
          staged[(tk + 1) * L::kERow + col] = from_f<__nv_bfloat16>(run[b][4 * i + 1] * sa);
          staged[tk * L::kERow + col + 8] = from_f<__nv_bfloat16>(run[b][4 * i + 2] * sb);
          staged[(tk + 1) * L::kERow + col + 8] = from_f<__nv_bfloat16>(run[b][4 * i + 3] * sb);
        }
      }
      warpgroup_sync(1 + cw);
      for (int u = ltid; u < NT * (WCH / 8); u += 128) {
        const int tk = u / (WCH / 8), part = u % (WCH / 8);
        const int tok = tl.tok0 + tk, n = tl.ch0 + cw * WCH + part * 8;
        if (tok >= M || n >= N) continue;
        const __nv_bfloat16* src = staged + tk * L::kERow + part * 8;
        __nv_bfloat16* out = y + ((size_t)tl.ex * M + tok) * N + n;
        if (wide && n + 8 <= N) {
          *reinterpret_cast<uint4*>(out) = *reinterpret_cast<const uint4*>(src);
        } else {
          for (int l = 0; l < 8 && n + l < N; ++l) out[l] = src[l];
        }
      }
      warpgroup_sync(1 + cw);         // the buffer is free for the next tile
    }
  }
}

template <int CB, int NT>
cudaError_t launch(const void* x, const void* packed, const void* scale, void* y, int E, int M,
                   int N, int K, int kp, int splits, int ctas, int vec, long long sstride,
                   cudaStream_t stream) {
  using L = Ring<NT>;
  static_assert(L::kBytes <= 232448, "a block's shared memory");
  auto kernel = quant_matmul_experts_kernel<CB, NT>;
  static bool sized = false;        // set once per kernel
  cudaError_t err;
  if (!sized) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  CUtensorMap xmap = {}, wmap = {};
  // x (E, M, K): boxes of NT rows x 64 values in the 128-byte swizzle wgmma
  // reads; packed (E, N, kp): boxes of 128 rows x 128 bytes, swizzled alike
  if (vec && (!encode_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, M, K, NT, kBK,
                          CU_TENSOR_MAP_SWIZZLE_128B, E) ||
              !encode_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, packed, N, kp, L::kCh, kWChunk,
                          CU_TENSOR_MAP_SWIZZLE_128B, E)))
    return cudaErrorInvalidValue;
  kernel<<<ctas, kThreads, L::kBytes, stream>>>(
      xmap, wmap, static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(y), E, M, N, K, kp, splits,
      vec, sstride);
  return cudaGetLastError();
}

template <int CB>
cudaError_t launch_cb(const void* x, const void* packed, const void* scale, void* y, int E, int M,
                      int N, int K, int kp, int nt, int splits, int ctas, int vec,
                      long long sstride, cudaStream_t s) {
#define RQ_NT(NTV) \
  launch<CB, NTV>(x, packed, scale, y, E, M, N, K, kp, splits, ctas, vec, sstride, s)
  switch (nt) {
    case 16: return RQ_NT(16);
    case 32: return RQ_NT(32);
    case 64: return RQ_NT(64);
    case 128: return RQ_NT(128);
    default: return cudaErrorInvalidValue;
  }
#undef RQ_NT
}

}  // namespace experts
}  // namespace rq

// The expert stack: y (E, M, N) in x's type; x (E, M, K); packed (E, N, kp)
// int8; the scale (N,) shared (sstride 0) or (E, N) (sstride N); the 2-D
// plan's splits.  bf16 x: the persistent kernel on `ctas` CTAs, token tile nt
// (16, 32, 64, 128), wgs the 64-channel blocks of a tile (4 at nt <= 32, else
// 2) and csize 1.  f32 x: the 2-D GEMM's kernel on the plan (nt, wgs, splits,
// csize); `ctas` unread.
extern "C" int rq_quant_matmul_experts(const void* x, const void* packed, const void* scale,
                                       void* y, int E, int M, int N, int K, int kp, int bits,
                                       int dtype, int nt, int wgs, int splits, int csize,
                                       int ctas, long long sstride, void* stream) {
  if (dtype == rq::kF32)
    return rq::matmul_entry(x, packed, scale, y, E, M, N, K, kp, bits, dtype, nt, wgs, splits,
                            csize, sstride, stream);
  const int nk = (K + rq::kBK - 1) / rq::kBK, ch = 64 * wgs;
  if (dtype != rq::kBF16 || E < 1 || M < 1 || N < 1 || K < 1 ||
      (bits != 2 && bits != 4 && bits != 6 && bits != 8) ||
      kp != (K + rq::lanes_of(bits) - 1) / rq::lanes_of(bits) ||
      (nt != 16 && nt != 32 && nt != 64 && nt != 128) ||
      wgs != rq::experts::kConsumers * rq::experts::blocks_of(nt) || csize != 1 || splits < 1 ||
      splits > 8 || splits > nk || ctas < 1 || (sstride != 0 && sstride != N) ||
      (long long)E * ((M + nt - 1) / nt) * ((N + ch - 1) / ch) > 0x7FFFFFFF)
    return (int)cudaErrorInvalidValue;
  const int vec = K % 8 == 0 && kp % 16 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                  (reinterpret_cast<uintptr_t>(packed) & 15) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using namespace rq::experts;
#define RQ_CB(CBV) (int)launch_cb<CBV>(x, packed, scale, y, E, M, N, K, kp, nt, splits, ctas, vec, \
                                       sstride, s)
  switch (bits) {
    case 2: return RQ_CB(2);
    case 4: return RQ_CB(4);
    default: return RQ_CB(8);
  }
#undef RQ_CB
}
