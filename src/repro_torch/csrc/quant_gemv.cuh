// The GEMV's arithmetic on the tensor cores, shared by quant_gemv.cu and
// quant_kv_proj.cu so that a channel projected inside the fused decode step
// is the GEMV kernel's value for that row and channel bit for bit.
//
// A warp owns 16 output channels (the rows of one mma.sync m16n8k16 A
// tile) and sums them over one K range against up to 8 rows of x (the mma's
// 8 columns; rows past M are zero).  Lane l is (g, q) = (l / 4, l % 4):
// it loads 16 packed bytes of rows g and g + 8 at byte 16 q of each 64-byte
// round of the range (64 bytes is 512 / CB values, whatever the width), so
// a warp load is 16 rows x 64 contiguous bytes.  The levels of a 4-byte word
// become bf16 pairs (v_i, v_{i + NV/2}) by bit tricks, no int -> float
// instruction (level_pair: 2- and 4-bit fields as 128 + u in bf16, 6- and
// 8-bit bytes as 2^23 + u in f32, u the level offset to unsigned, each
// minus its offset; exact).  Pairs 2T and 2T + 1 of the lane's chunk feed
// tile T's A columns {2q, 2q + 1} and {2q + 8, 2q + 9}; the B operand holds
// x at the same real k (the mma sums over a permutation of k, fixed by this layout,
// so every channel sees the same one).  x is staged once per CTA in shared
// memory (gemv_stage_x) in that pair order, bf16 as it is and f32 x as
// three bf16 pieces hi + mid + lo == x (exact products, f32 accuracy
// without TF32).  The k16 steps of a range go round-robin to kGemvChains
// accumulators, so that many mma are in flight and not one chain of
// dependent ones; bf16 x chains each accumulator on the tensor cores, f32 x
// runs each step's three products from zero and adds the step's sum in
// CUDA-core f32 (the tensor cores' own accumulation drops low bits over a
// long sum); at the range's end the accumulators are added in a fixed order,
// (c0 + c1) + (c2 + c3).
//
// A channel's value is therefore a function of K, the bits and the data:
// the K ranges are whole 256-value units cut by K alone
// (kernels/quant_gemv/kernel.py plan), each range's partial starts from
// zero, and the partials are added in range order from zero (gemv_fold)
// whatever CTA, cluster rank or kernel computes them.  Rows past N read
// zeros.  The mma computes each (row, column) of its output from that row
// and column alone, so M and the position of a channel in its tile do not
// move its bits either.
#pragma once

#include "common.cuh"

namespace rq {

constexpr int kGemvMaxM = 8;
constexpr int kGemvThreads = 256;
constexpr int kGemvWarps = kGemvThreads / 32;
constexpr int kGemvTileRows = 16;                            // one mma's A rows
constexpr int kGemvChannels = kGemvWarps * kGemvTileRows;    // one tile's channels
constexpr int kGemvUnit = 256;                               // K values: ranges are whole units
constexpr int kGemvMaxSplit = 16;                            // ranges (a cluster's CTAs)
constexpr int kGemvMaxUnits = 16;                            // units of one range
constexpr int kGemvGroup = 1;                                // rounds a load group (two in flight)
constexpr int kGemvMaxTiles = 8;                             // 16-row tiles of one warp
constexpr int kGemvChains = 4;                               // independent accumulators a tile

// Container bits of one value: 6-bit levels ride in whole int8 bytes.
__host__ __device__ constexpr int gemv_cb(int bits) { return bits >= 6 ? 8 : bits; }

template <int CB> struct GemvShape {
  static constexpr int kNV = 32 / CB;        // values of a 4-byte word
  static constexpr int kRound = 512 / CB;    // K values of one 64-byte round of a row
  static constexpr int kChunk = 128 / CB;    // values of a lane's 16 bytes
  static constexpr int kPieces = 16 / CB;    // 16-byte B pieces of a lane's chunk
};

// Bytes of the x staging of one range of `rounds` rounds for M rows: one
// array per bf16 piece (three for f32 x).
template <int CB>
__host__ __device__ inline int gemv_piece_bytes(int m, int rounds) {
  return 2 * m * rounds * GemvShape<CB>::kRound;
}

__device__ __forceinline__ uint32_t bf16x2_fma(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// (a & b) ^ c in one instruction (b and c in registers, so that ptxas does
// not split the two constants into two instructions).
__device__ __forceinline__ uint32_t and_xor(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0x6A;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// Pair i of a packed word as it was loaded (gemv_word): the levels (v_i,
// v_{i + NV/2}) as bf16x2, v_i in the low half.  2 and 4 bits: the two
// fields masked in place and flipped to unsigned inside a bf16 128 + u (one
// lop3), minus the offset (one bf16x2 fma).  6 and 8 bits (the word already
// flipped to unsigned bytes by gemv_word): each byte inside an f32 2^23 + u,
// minus 2^23 + 128; the bf16 of a level is its f32's high half (exact).
template <int CB>
__device__ __forceinline__ uint32_t level_pair(uint32_t u, int i, uint32_t mask,
                                               uint32_t magic) {
  if constexpr (CB == 8) {
    const float lo = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | i)) - 8388736.0f;
    const float hi = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | (i + 2))) - 8388736.0f;
    return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
  } else {
    constexpr uint32_t kOff = CB == 4 ? 0xC308C308u : 0xC302C302u;   // -136, -130
    return bf16x2_fma(and_xor(u >> (CB * i), mask, magic), 0x3F803F80u, kOff);
  }
}

// The constants level_pair takes, in registers: the fields' mask and the
// bf16 128.0 with the fields' sign bit flipped (u = level + 2^(CB-1)).
template <int CB> __device__ __forceinline__ uint32_t gemv_mask() {
  return CB == 4 ? 0x000F000Fu : 0x00030003u;
}
template <int CB> __device__ __forceinline__ uint32_t gemv_magic() {
  return CB == 4 ? 0x43084308u : 0x43024302u;
}

// A loaded word as level_pair takes it: 6- and 8-bit bytes flipped to unsigned.
template <int CB>
__device__ __forceinline__ uint32_t gemv_word(uint32_t w) {
  return CB == 8 ? w ^ 0x80808080u : w;
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Stage x[m, k0:k1) (m < M, row stride K) for a range of `rounds` rounds
// into xs in the B operand's pair order: the 16-byte piece s of lane
// (g = m, q)'s chunk of round r at ((r * P + s) * M + m) * 4 + q, so a
// warp's piece load is 512 contiguous bytes; values past k1 are zero.
// XF32: three arrays of piece_bytes (hi, mid, lo).  xvec: x rows may be read
// 8 bytes at a time (K % 4 == 0, x 8-byte aligned).
template <int CB, typename T>
__device__ void gemv_stage_x(const T* __restrict__ x, int K, int M, int k0, int k1, int rounds,
                             int xvec, uint8_t* xs, int piece_bytes) {
  using S = GemvShape<CB>;
  constexpr int NV = S::kNV, P = S::kPieces;
  constexpr bool XF32 = sizeof(T) == 4;
  const int items = M * rounds * 16;                     // (m, r, q, word), words fastest
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int w = it & 3, q = (it >> 2) & 3, rest = it >> 4;
    const int r = rest % rounds, m = rest / rounds;
    const int k = k0 + r * S::kRound + q * S::kChunk + w * NV;
    const T* src = x + (size_t)m * K + k;
    float v[NV];
    if (xvec && k + NV <= k1) {
#pragma unroll
      for (int i = 0; i < NV * (int)sizeof(T); i += 8) {
        const uint2 t =
            __ldg(reinterpret_cast<const uint2*>(reinterpret_cast<const char*>(src) + i));
        if constexpr (XF32) {
          v[i / 4] = __uint_as_float(t.x);
          v[i / 4 + 1] = __uint_as_float(t.y);
        } else {
          v[i / 2] = __uint_as_float(t.x << 16);
          v[i / 2 + 1] = __uint_as_float(t.x & 0xFFFF0000u);
          v[i / 2 + 2] = __uint_as_float(t.y << 16);
          v[i / 2 + 3] = __uint_as_float(t.y & 0xFFFF0000u);
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < NV; ++i) v[i] = k + i < k1 ? to_f(src[i]) : 0.f;
    }
    // the pieces: bf16 x is its own (exact); f32 x splits as hi + mid + lo
    uint32_t pr[XF32 ? 3 : 1][NV / 2];
#pragma unroll
    for (int i = 0; i < NV / 2; ++i) {
      float a = v[i], b = v[i + NV / 2];
#pragma unroll
      for (int t = 0; t < (XF32 ? 3 : 1); ++t) {
        const __nv_bfloat16 ha = __float2bfloat16_rn(a), hb = __float2bfloat16_rn(b);
        pr[t][i] = (uint32_t)__bfloat16_as_ushort(ha) |
                   ((uint32_t)__bfloat16_as_ushort(hb) << 16);
        a = a - __bfloat162float(ha);
        b = b - __bfloat162float(hb);
      }
    }
    const int p0 = w * (NV / 2);                           // the chunk's first pair here
#pragma unroll
    for (int t = 0; t < (XF32 ? 3 : 1); ++t) {
      uint8_t* base = xs + t * piece_bytes;
#pragma unroll
      for (int h = 0; h < NV / 2; h += 4 < NV / 2 ? 4 : NV / 2) {
        const int p = p0 + h, s = p / 4;
        uint8_t* dst = base + ((((size_t)r * P + s) * M + m) * 4 + q) * 16 + (p % 4) * 4;
        if constexpr (NV / 2 >= 4) {
          *reinterpret_cast<uint4*>(dst) = make_uint4(pr[t][h], pr[t][h + 1], pr[t][h + 2],
                                                      pr[t][h + 3]);
        } else {
          *reinterpret_cast<uint2*>(dst) = make_uint2(pr[t][h], pr[t][h + 1]);
        }
      }
    }
  }
}

// 16 packed bytes of a row at byte `off` (zeros past kp or for a row past N).
__device__ __forceinline__ uint4 gemv_load16(const uint8_t* __restrict__ row, int off, int kp,
                                             bool live, int wvec) {
  uint4 out = make_uint4(0u, 0u, 0u, 0u);
  if (!live || off >= kp) return out;
  if (wvec) return __ldg(reinterpret_cast<const uint4*>(row + off));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (off + i < kp) w[i / 4] |= (uint32_t)row[off + i] << (8 * (i % 4));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Where a warp's tile t starts: row0 + t * tile_stride (the GEMV).  Row 8
// passes its own map (quant_kv_proj.cu ProjTiles): a rank's tiles of one kv
// head's rows, which lie in three slices of wqkv.
struct StridedTiles {
  __device__ __forceinline__ int operator()(int row0, int tile_stride, int t) const {
    return row0 + t * tile_stride;
  }
};

// One warp's tiles of 16 rows, each summed over one K range against the
// staged x into a C fragment (rows g, g + 8 x columns 2q, 2q + 1) from
// zero.  Tile t's rows start at tile_rows(row0, tile_stride, t) (rows at or
// past N read zeros); the range starts at byte kb0 of each row and is
// `rounds` rounds long.  The (tile, round) pairs form one stream, kGemvGroup rounds
// a load group: a lane keeps two groups in flight, the next one loading
// while one is summed, across tile boundaries, so a warp that walks many
// tiles never waits for a tile's first bytes.  prime() asks for the first
// group, so a CTA can stage x while it comes; run() sums and hands each
// finished tile's fragment to sink(t, acc).
template <int CB, bool XF32, typename TileRows = StridedTiles>
struct GemvWarp {
  static constexpr int G = kGemvGroup;
  const uint8_t* __restrict__ packed;
  int kp, wvec, kb0, rounds, lane;
  int row0, tile_stride, N, tiles;
  TileRows tile_rows;
  uint4 wa[2][G], wb[2][G];

  template <int B>
  __device__ __forceinline__ void load(int j0) {
    const int g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int j = j0 + i;
      const int t = j / rounds, r = j - t * rounds;
      const int row = tile_rows(row0, tile_stride, t) + g;
      const int off = kb0 + r * 64 + q * 16;
      const bool in = j < tiles * rounds;
      wa[B][i] = gemv_load16(packed + (size_t)row * kp, off, kp, in && row < N, wvec);
      wb[B][i] = gemv_load16(packed + (size_t)(row + 8) * kp, off, kp, in && row + 8 < N, wvec);
    }
  }

  template <int B, typename Sink>
  __device__ __forceinline__ void sum(int j0, const uint8_t* __restrict__ xs, int piece_bytes,
                                     int M, float (&acc)[kGemvChains][4], Sink& sink) const {
    using S = GemvShape<CB>;
    constexpr int P = S::kPieces, TPW = 8 / CB, NP = XF32 ? 3 : 1;   // tiles per word
    const int g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int j = j0 + i;
      if (j >= tiles * rounds) break;
      const int t = j / rounds, r = j - t * rounds;
      if (r == 0) {
#pragma unroll
        for (int c = 0; c < kGemvChains; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
      }
      const uint32_t ua[4] = {gemv_word<CB>(wa[B][i].x), gemv_word<CB>(wa[B][i].y),
                              gemv_word<CB>(wa[B][i].z), gemv_word<CB>(wa[B][i].w)};
      const uint32_t ub[4] = {gemv_word<CB>(wb[B][i].x), gemv_word<CB>(wb[B][i].y),
                              gemv_word<CB>(wb[B][i].z), gemv_word<CB>(wb[B][i].w)};
      const uint32_t mask = gemv_mask<CB>(), magic = gemv_magic<CB>();
#pragma unroll
      for (int p = 0; p < P; ++p) {
        uint4 xb[NP];
        const uint8_t* src = xs + ((((size_t)r * P + p) * M + g) * 4 + q) * 16;
#pragma unroll
        for (int u = 0; u < NP; ++u)
          xb[u] = g < M ? *reinterpret_cast<const uint4*>(src + u * piece_bytes)
                        : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int T = 2 * p + h, w = T / TPW, jj = T % TPW;
          const uint32_t a0 = level_pair<CB>(ua[w], 2 * jj, mask, magic);
          const uint32_t a2 = level_pair<CB>(ua[w], 2 * jj + 1, mask, magic);
          const uint32_t a1 = level_pair<CB>(ub[w], 2 * jj, mask, magic);
          const uint32_t a3 = level_pair<CB>(ub[w], 2 * jj + 1, mask, magic);
          float (&ch)[4] = acc[T % kGemvChains];
          if constexpr (XF32) {
            float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int u = 0; u < 3; ++u)
              mma_bf16(d, a0, a1, a2, a3, h ? xb[u].z : xb[u].x, h ? xb[u].w : xb[u].y);
#pragma unroll
            for (int e = 0; e < 4; ++e) ch[e] = __fadd_rn(ch[e], d[e]);
          } else {
            mma_bf16(ch, a0, a1, a2, a3, h ? xb[0].z : xb[0].x, h ? xb[0].w : xb[0].y);
          }
        }
      }
      if (r == rounds - 1) {   // the chains' sums, in a fixed order
        float out[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          out[e] = __fadd_rn(__fadd_rn(acc[0][e], acc[1][e]), __fadd_rn(acc[2][e], acc[3][e]));
        sink(t, out);
      }
    }
  }

  __device__ __forceinline__ void prime() { load<0>(0); }

  template <typename Sink>
  __device__ __forceinline__ void run(const uint8_t* __restrict__ xs, int piece_bytes, int M,
                                      Sink sink) {
    float acc[kGemvChains][4];
    for (int j0 = 0; j0 < tiles * rounds; j0 += 2 * G) {
      load<1>(j0 + G);
      sum<0>(j0, xs, piece_bytes, M, acc, sink);
      load<0>(j0 + 2 * G);
      sum<1>(j0 + G, xs, piece_bytes, M, acc, sink);
    }
  }
};

// The running sum of a channel's range partials: from zero, in range order.
__device__ __forceinline__ float gemv_fold(float total, float partial) {
  return __fadd_rn(total, partial);
}

// The K range [k0, k1) of range s of `splits` over K (whole units).
__host__ __device__ inline void gemv_range(int K, int splits, int s, int& k0, int& k1) {
  const int units = (K + kGemvUnit - 1) / kGemvUnit;
  k0 = s * units / splits * kGemvUnit;
  k1 = (s + 1) * units / splits * kGemvUnit;
  k0 = k0 < K ? k0 : K;
  k1 = k1 < K ? k1 : K;
}

// Rounds of the longest range (the staging's size).
template <int CB>
__host__ __device__ inline int gemv_max_rounds(int K, int splits) {
  const int units = (K + kGemvUnit - 1) / kGemvUnit;
  const int most = (units + splits - 1) / splits;
  return most * kGemvUnit / GemvShape<CB>::kRound;
}

inline bool bad_gemv_bits(int bits) { return bits != 2 && bits != 4 && bits != 6 && bits != 8; }

// A split the kernels take for K: 1 .. 16 ranges of at most 16 units, none empty.
inline bool bad_gemv_split(int K, int splits) {
  const int units = (K + kGemvUnit - 1) / kGemvUnit;
  return splits < 1 || splits > kGemvMaxSplit || splits > units ||
         (units + splits - 1) / splits > kGemvMaxUnits;
}

// The packed rows may be read 16 bytes at a time; x 8 bytes at a time.
inline int gemv_wvec(const void* packed, int kp) {
  return kp % 16 == 0 && (reinterpret_cast<uintptr_t>(packed) & 15) == 0;
}
inline int gemv_xvec(const void* x, int K) {
  return K % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 7) == 0;
}

}  // namespace rq
