// Device code shared by the quantized-KV kernels (quant_kv_decode_step.cu,
// quant_kv_dense.cu, quant_kv_paged.cu, quant_kv_proj.cu): the in-place
// requantization of one touched block and the attention of one (slot, kv
// head), split over S.
//
// Both take the cache through a ROW LOCATOR, so the dense and the paged
// kernels run the same arithmetic in the same order:
//   DenseRows  (slot, head) rows of a (B, H, S, hdp) cache, scale per block;
//   PagedRows  table[slot][s / block] -> rows of a (P, H, block, hdp) pool;
//              an entry < 0 reads as zero levels at the init scale 1e-12.
// A pool and a dense cache with the same contents therefore give the same
// attention output bit for bit (the paged engine's tokens equal the dense
// engine's on the card for that reason).
//
// The split (flash decoding).  S is cut into chunks of kChunk positions from
// position 0.  Each chunk's partial (m, l, acc) is a fresh online softmax over
// its 32-position tiles, and the partials are folded into (M, L, O) ONE AT A
// TIME IN CHUNK ORDER (fold_chunk; an empty chunk is skipped), then out =
// O / max(L, 1e-30).  The chunks of one (slot, kv head) run either on the
// CTAs of a thread-block cluster (rank r takes chunks r, r + csize, ...; a
// round of csize chunks is folded by every rank for its slice of the output,
// reading the others' partials through distributed shared memory in rank
// order) or all on one CTA ("walk", csize 1).  Both apply the same fold to
// the same partials in the same order, so the bits depend on the chunking
// (S, kChunk), the valid positions and the data alone: not on the mode, the
// cluster size, B, or dense against paged.  Every product and sum that
// matters is written with __fmaf_rn / __fmul_rn, so nvcc cannot contract
// one instantiation differently from another (kernels/quant_kv/ref.py
// attend_mirror repeats this arithmetic on the CPU).
//
// kChunk is 64: two tiles a chunk, and at gemma-2b's max_seq 1024 sixteen
// chunks, one cluster of 16 a slot.  On the H100 (tools/attend_variants.py,
// PERF.md section 6) 128 was slower at every shape timed; 32 was faster at
// S 512 but slower at 1024, where its 32 chunks take two rounds of a
// cluster, and 1024 is the paged engines' max_seq, which launch the most.
#pragma once

#include <cooperative_groups.h>
#include <math.h>

#include "common.cuh"

namespace rq {

namespace cg = cooperative_groups;

constexpr int kKvThreads = 256;
constexpr int kTile = 32;        // one warp lane per tile position in the softmax step
constexpr int kChunk = 64;       // positions per chunk: a multiple of kTile
constexpr int kMaxCluster = 16;  // CTAs of one cluster (above 8: non-portable)
constexpr int kRed = 34;         // floats of block-reduction scratch
constexpr int kFetch = 8;        // loads of the prologue a thread has in flight
constexpr int kFoldBatch = 8;    // ranks whose partials a thread reads at once
constexpr int kWarps = kKvThreads / 32;
constexpr int kRowsPerWarp = kTile / kWarps;  // rows of a tile a warp loads
constexpr int kLaneWords = 2;                 // words of a row a lane loads in one pass
constexpr int kPassWords = 32 * kLaneWords;   // a row's words in one pass (hd 256 at 8 bits)
constexpr int kQueryGroup = 8;                // query rows a thread carries in the PV step

static_assert(kChunk % kTile == 0, "a tile never straddles two chunks");
static_assert(kTile % kWarps == 0, "every warp loads whole rows of a tile");

struct KvSmem {
  float *q, *acc, *tot, *kf, *vf, *p, *mk, *m, *l, *corr, *tm, *tl, *red;
  uint8_t *kblk, *vblk;
};

// The dequantized K and V tiles.
__host__ __device__ inline size_t kv_work_floats(int hd) {
  return (size_t)kTile * (hd + 1) + (size_t)kTile * hd;
}

__host__ __device__ inline size_t round16(size_t bytes) { return (bytes + 15) / 16 * 16; }

__host__ __device__ inline size_t kv_smem_floats(int g, int hd) {
  return 3 * (size_t)g * hd + kv_work_floats(hd) + (size_t)g * kTile + kChunk + 5 * (size_t)g +
         kRed;
}

// The floats, then the touched blocks' packed copies, each 16-byte aligned
// (requantize_kv stores them a vector at a time).
__host__ __device__ inline size_t kv_smem_bytes(int g, int hd, int block, int hdp_k, int hdp_v) {
  return round16(kv_smem_floats(g, hd) * sizeof(float)) + round16((size_t)block * hdp_k) +
         (size_t)block * hdp_v;
}

__device__ inline KvSmem carve_kv_smem(float* smem, int g, int hd, int block, int hdp_k) {
  KvSmem sm;
  sm.q = smem;
  sm.acc = sm.q + g * hd;
  sm.tot = sm.acc + g * hd;
  sm.kf = sm.tot + g * hd;
  sm.vf = sm.kf + kTile * (hd + 1);
  sm.p = sm.kf + kv_work_floats(hd);
  sm.mk = sm.p + g * kTile;
  sm.m = sm.mk + kChunk;
  sm.l = sm.m + g;
  sm.corr = sm.l + g;
  sm.tm = sm.corr + g;
  sm.tl = sm.tm + g;
  sm.red = sm.tl + g;
  sm.kblk = reinterpret_cast<uint8_t*>(smem) + round16(kv_smem_floats(g, hd) * sizeof(float));
  sm.vblk = sm.kblk + round16((size_t)block * hdp_k);
  return sm;
}

// Packed rows of one (slot, head) in the dense cache: words (S, wpr), one
// scale per sequence block.
struct DenseRows {
  const uint32_t* words;
  const float* scale;
  int wpr, block;
  __device__ __forceinline__ bool row(int s, const uint32_t*& p, float& sc) const {
    p = words + (size_t)s * wpr;
    sc = __ldg(scale + s / block);
    return true;
  }
};

// Packed rows of one (slot, head) through the slot's block-table row: pool
// words (P, n_kv, block, wpr), scales (P, n_kv).  False where unmapped.
struct PagedRows {
  const uint32_t* pool;
  const float* scale;
  const int* table;
  int n_kv, h, wpr, block;
  __device__ __forceinline__ bool row(int s, const uint32_t*& p, float& sc) const {
    const int e = __ldg(table + s / block);
    if (e < 0) return false;
    const size_t blk = (size_t)e * n_kv + h;
    p = pool + (blk * block + s % block) * wpr;
    sc = __ldg(scale + blk);
    return true;
  }
};

// One side of the tile t0 .. t0 + kTile - 1: wpr words per packed row, vpw
// values per word of cb bits, into dst (row stride ld floats).  Rows of
// sequence block bidx come from its shared-memory copy blk_words at scale
// sc_new (bidx -1: none); a row the locator does not map is zero levels at
// scale 1e-12, exactly what a dense cache holds where nothing was written.
struct TileSide {
  const uint32_t* blk_words;
  float sc_new;
  int wpr, vpw, cb, ld;
  float* dst;
};

// A warp's share of one side of a tile: rows warp, warp + kWarps, ... of
// the tile, and of each row the words [col0, col0 + kPassWords), lane l on
// words col0 + l + 32 u (neighbouring lanes on neighbouring words).  The row
// locator runs once per row; every load of the pass is in flight at once.
struct SideRegs {
  uint32_t w[kRowsPerWarp][kLaneWords];
  float sc[kRowsPerWarp];
};

template <typename Rows>
__device__ __forceinline__ void fetch_side(const Rows& rows, const TileSide& sd, int t0, int S,
                                           int block, int bidx, int col0, SideRegs& r) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kRowsPerWarp; ++k) {
    const int s = t0 + warp + k * kWarps;
    const uint32_t* p = nullptr;
    bool from_smem = false;
    float sc = 0.f;
    if (s < S) {
      if (s / block == bidx) {
        p = sd.blk_words + (s - bidx * block) * sd.wpr;
        sc = sd.sc_new;
        from_smem = true;
      } else if (!rows.row(s, p, sc)) {
        p = nullptr;
        sc = 1e-12f;
      }
    }
    r.sc[k] = sc;
#pragma unroll
    for (int u = 0; u < kLaneWords; ++u) {
      const int j = col0 + lane + 32 * u;
      uint32_t w = 0u;
      if (p != nullptr && j < sd.wpr) w = from_smem ? p[j] : __ldg(p + j);
      r.w[k][u] = w;
    }
  }
}

__device__ __forceinline__ void store_side(const TileSide& sd, int col0, const SideRegs& r) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kRowsPerWarp; ++k) {
    const int t = warp + k * kWarps;
#pragma unroll
    for (int u = 0; u < kLaneWords; ++u) {
      const int j = col0 + lane + 32 * u;
      if (j >= sd.wpr) continue;
      float* d = sd.dst + t * sd.ld + j * sd.vpw;
      for (int v = 0; v < sd.vpw; ++v) d[v] = (float)word_lane(r.w[k][u], sd.cb, v) * r.sc[k];
    }
  }
}

// A thread's first pass of packed words of the K and V tiles at t0, held in
// registers from fetch_tile to store_tile, so that the loads of the next
// tile are in flight while this one is computed.
struct TileRegs {
  SideRegs k, v;
};

template <typename Rows>
__device__ __forceinline__ void fetch_tile(const Rows& krows, const Rows& vrows,
                                           const TileSide& ks, const TileSide& vs, int t0,
                                           int S, int block, int bidx, TileRegs& r) {
  fetch_side(krows, ks, t0, S, block, bidx, 0, r.k);
  fetch_side(vrows, vs, t0, S, block, bidx, 0, r.v);
}

// Dequantize the K and V tiles at t0 into shared memory: the fetched pass,
// then (rows of more than kPassWords words) the rest, pass by pass.
template <typename Rows>
__device__ __forceinline__ void store_tile(const Rows& krows, const Rows& vrows,
                                           const TileSide& ks, const TileSide& vs, int t0,
                                           int S, int block, int bidx, TileRegs& r) {
  const int wmax = ks.wpr > vs.wpr ? ks.wpr : vs.wpr;
  for (int col0 = 0;;) {
    store_side(ks, col0, r.k);
    store_side(vs, col0, r.v);
    col0 += kPassWords;
    if (col0 >= wmax) break;
    fetch_side(krows, ks, t0, S, block, bidx, col0, r.k);
    fetch_side(vrows, vs, t0, S, block, bidx, col0, r.v);
  }
}

// The requantization of a touched block (one side: K or V), the plain
// version's arithmetic: rows before the write offset `off` dequantized as
// level * old scale, row off the new row, rows past it zero; the new scale
// amax / qmax and the levels rintf(x / scale) (half to even) clamped to
// +-qmax, both divisions IEEE (__fdiv_rn), in common.cuh's lane layout, so
// the bytes equal the plain version's bit for bit.
//
// The block (block x hd values, hd % 16 == 0) is cut into groups of 16
// consecutive values of one row, 16 / lanes packed bytes each; group i is
// thread i's (then i + blockDim.x, ...), at most kReqGroups a thread.  A
// thread loads each of its groups' old bytes with one vector load, keeps
// them in registers (`raw`), and unpacks, requantizes and packs them there,
// with one division by hd a group and none a value; the block's amax is
// one warp shuffle reduction and one shared-memory exchange, for K and V at
// once where both sides are requantized.  The same thread owns the same
// groups at every step, so a burst (quant_kv_append_burst) keeps a block's
// bytes in `raw` from one position to the next.
constexpr int kReqGroups = 4;                       // block * hd <= 16384 values
constexpr int kReqValues = 16;                      // values of a group

__host__ __device__ inline bool bad_req_block(int hd, int block, int threads) {
  return (size_t)block * hd > (size_t)kReqGroups * kReqValues * threads;
}

// Levels of a group's packed words (container bits cb: 2, 4 or 8), in order.
__device__ __forceinline__ void unpack_group(const uint32_t (&w)[4], int cb, float (&lev)[16]) {
  if (cb == 8) {
#pragma unroll
    for (int e = 0; e < 16; ++e) lev[e] = (float)word_lane(w[e >> 2], 8, e & 3);
  } else if (cb == 4) {
#pragma unroll
    for (int e = 0; e < 16; ++e) lev[e] = (float)word_lane(w[e >> 3], 4, e & 7);
  } else {
#pragma unroll
    for (int e = 0; e < 16; ++e) lev[e] = (float)word_lane(w[0], 2, e);
  }
}

// A group's levels packed into words (common.cuh's layout: value e at byte
// e / lanes, field e % lanes, low bits first).
__device__ __forceinline__ void pack_group(const int (&t)[16], int cb, uint32_t (&w)[4]) {
  w[0] = w[1] = w[2] = w[3] = 0u;
  if (cb == 8) {
#pragma unroll
    for (int e = 0; e < 16; ++e) w[e >> 2] |= (uint32_t)(t[e] & 0xFF) << (8 * (e & 3));
  } else if (cb == 4) {
#pragma unroll
    for (int e = 0; e < 16; ++e) w[e >> 3] |= (uint32_t)(t[e] & 0xF) << (4 * (e & 7));
  } else {
#pragma unroll
    for (int e = 0; e < 16; ++e) w[0] |= (uint32_t)(t[e] & 0x3) << (2 * e);
  }
}

template <typename T>
struct BlockSide {
  uint32_t raw[kReqGroups][4];   // the thread's groups' packed bytes (16 / lanes a group)
  int bits;
  float amax;

  __device__ __forceinline__ int cb() const { return 8 / lanes_of(bits); }

  // group i's 16 / lanes bytes at src into raw[j], or raw[j] to dst
  __device__ __forceinline__ void read(const uint8_t* src, int i, int j) {
    const int nb = 2 * cb();
    const uint8_t* p = src + (size_t)i * nb;
    if (nb == 16) {
      const uint4 t = *reinterpret_cast<const uint4*>(p);
      raw[j][0] = t.x; raw[j][1] = t.y; raw[j][2] = t.z; raw[j][3] = t.w;
    } else if (nb == 8) {
      const uint2 t = *reinterpret_cast<const uint2*>(p);
      raw[j][0] = t.x; raw[j][1] = t.y;
    } else {
      raw[j][0] = *reinterpret_cast<const uint32_t*>(p);
    }
  }
  __device__ __forceinline__ void write(uint8_t* dst, int i, int j) const {
    const int nb = 2 * cb();
    uint8_t* p = dst + (size_t)i * nb;
    if (nb == 16)
      *reinterpret_cast<uint4*>(p) = make_uint4(raw[j][0], raw[j][1], raw[j][2], raw[j][3]);
    else if (nb == 8) *reinterpret_cast<uint2*>(p) = make_uint2(raw[j][0], raw[j][1]);
    else *reinterpret_cast<uint32_t*>(p) = raw[j][0];
  }

  // Group j's values before the requantization (row r, columns c0..c0+15).
  __device__ __forceinline__ void values(int j, int r, int c0, int off, float sc_old,
                                         const T* __restrict__ new_row, float (&v)[16]) const {
    if (r < off) {
      unpack_group(raw[j], cb(), v);
#pragma unroll
      for (int e = 0; e < 16; ++e) v[e] = v[e] * sc_old;
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e) v[e] = r == off ? to_f(new_row[c0 + e]) : 0.f;
    }
  }

  // The old bytes of the thread's groups that lie before row off, into raw:
  // every load in flight before any is used.
  __device__ void fetch(const uint8_t* src, int hd, int block, int off) {
    const int per_row = hd / kReqValues, n = block * per_row;
#pragma unroll
    for (int j = 0; j < kReqGroups; ++j) {
      const int i = threadIdx.x + j * blockDim.x;
      if (i < n && i / per_row < off) read(src, i, j);
    }
  }

  // Pass 1: the largest |value| over the thread's groups, from the bytes in
  // raw (fetch, or the previous position of a burst).
  __device__ void scan(int hd, int block, int off, float sc_old, const T* __restrict__ new_row) {
    const int per_row = hd / kReqValues, n = block * per_row;
    amax = 0.f;
#pragma unroll
    for (int j = 0; j < kReqGroups; ++j) {
      const int i = threadIdx.x + j * blockDim.x;
      if (i >= n) break;
      const int r = i / per_row, c0 = (i - r * per_row) * kReqValues;
      float v[16];
      values(j, r, c0, off, sc_old, new_row, v);
#pragma unroll
      for (int e = 0; e < 16; ++e) amax = fmaxf(amax, fabsf(v[e]));
    }
  }

  // Pass 2: requantize at scale sc into raw, and write the groups to dst
  // and to dst2 (each where not null).
  __device__ void requantize(float sc, int hd, int block, int off, float sc_old,
                             const T* __restrict__ new_row, uint8_t* dst, uint8_t* dst2) {
    const int per_row = hd / kReqValues, n = block * per_row;
    const float qm = (float)((1 << (bits - 1)) - 1);
#pragma unroll
    for (int j = 0; j < kReqGroups; ++j) {
      const int i = threadIdx.x + j * blockDim.x;
      if (i >= n) break;
      const int r = i / per_row, c0 = (i - r * per_row) * kReqValues;
      float v[16];
      values(j, r, c0, off, sc_old, new_row, v);
      int t[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) t[e] = (int)fminf(fmaxf(rintf(__fdiv_rn(v[e], sc)), -qm), qm);
      pack_group(t, cb(), raw[j]);
      if (dst) write(dst, i, j);
      if (dst2) write(dst2, i, j);
    }
  }

  // The thread's groups' bytes to dst (a block the burst leaves).
  __device__ void store_all(uint8_t* dst, int hd, int block) const {
    const int n = block * (hd / kReqValues);
#pragma unroll
    for (int j = 0; j < kReqGroups; ++j) {
      const int i = threadIdx.x + j * blockDim.x;
      if (i < n) write(dst, i, j);
    }
  }
};

// The new scale of a block whose largest |value| is amax.
__device__ __forceinline__ float req_scale(float amax, int bits) {
  return __fdiv_rn(fmaxf(amax, 1e-12f), (float)((1 << (bits - 1)) - 1));
}

// Block-wide max of a and b at once: one shuffle reduction each and one
// exchange through red (2 * warps floats, which the caller must not reuse
// before a further __syncthreads).
__device__ __forceinline__ void block_max2(float& a, float& b, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  a = warp_max(a);
  b = warp_max(b);
  if (lane == 0) {
    red[warp] = a;
    red[nw + warp] = b;
  }
  __syncthreads();
  a = red[0];
  b = red[nw];
  for (int w = 1; w < nw; ++w) {
    a = fmaxf(a, red[w]);
    b = fmaxf(b, red[nw + w]);
  }
}

// Requantize the K and V blocks touched at offset off in place (kbase /
// vbase their packed bytes, ksc_ptr / vsc_ptr their scales) with the new
// rows inserted, copies of the new blocks to kblk / vblk (shared memory,
// 16-byte aligned) for the attention; the new scales into ksc / vsc.
template <typename T>
__device__ void requantize_kv(uint8_t* kbase, float* ksc_ptr, const T* __restrict__ knew,
                              uint8_t* kblk, int k_bits, uint8_t* vbase, float* vsc_ptr,
                              const T* __restrict__ vnew, uint8_t* vblk, int v_bits, int hd,
                              int block, int off, float* red, float& ksc, float& vsc) {
  BlockSide<T> k, v;
  k.bits = k_bits;
  v.bits = v_bits;
  const float kold = *ksc_ptr, vold = *vsc_ptr;
  k.fetch(kbase, hd, block, off);   // both sides' loads in flight together
  v.fetch(vbase, hd, block, off);
  k.scan(hd, block, off, kold, knew);
  v.scan(hd, block, off, vold, vnew);
  float ka = k.amax, va = v.amax;
  block_max2(ka, va, red);   // also orders every read above before the writes below
  ksc = req_scale(ka, k_bits);
  vsc = req_scale(va, v_bits);
  k.requantize(ksc, hd, block, off, kold, knew, kbase, kblk);
  v.requantize(vsc, hd, block, off, vold, vnew, vbase, vblk);
  if (threadIdx.x == 0) {
    *ksc_ptr = ksc;
    *vsc_ptr = vsc;
  }
  __syncthreads();
}

// The burst append of one (head, slot, side): positions start + j for j =
// 0 .. min(acc, J - 1), row j at rows + j * row_stride, each requantizing
// the bytes the previous one left.  block_of(p, base, sc) finds p's packed
// block and its scale (false: p writes nothing).  The block being written
// stays in registers (BlockSide's raw) and goes back to the cache when the
// burst moves on and at the end; nothing else reads it meanwhile.
template <typename T, typename Locate>
__device__ void append_burst(const T* __restrict__ rows, size_t row_stride, int start, int acc,
                             int J, int bits, int hd, int block, float* red, Locate block_of) {
  BlockSide<T> blk;
  blk.bits = bits;
  uint8_t* cur = nullptr;      // the block held in registers
  float* cur_sc = nullptr;
  float sc = 0.f;
  int calls = 0;
  for (int j = 0; j < J && j <= acc; ++j) {
    const int p = start + j;
    uint8_t* base;
    float* sc_ptr;
    if (!block_of(p, base, sc_ptr)) continue;   // block-uniform
    if (base != cur) {
      if (cur) {
        blk.store_all(cur, hd, block);
        if (threadIdx.x == 0) *cur_sc = sc;
      }
      blk.fetch(base, hd, block, p % block);   // positions only grow within a block
      sc = *sc_ptr;
      cur = base;
      cur_sc = sc_ptr;
    }
    const T* row = rows + (size_t)j * row_stride;
    const int off = p % block;
    blk.scan(hd, block, off, sc, row);
    float a = blk.amax, unused = 0.f;
    block_max2(a, unused, red + (calls++ & 1) * kRed);   // halves alternate: no reuse race
    const float ns = req_scale(a, bits);
    blk.requantize(ns, hd, block, off, sc, row, nullptr, nullptr);
    sc = ns;
  }
  if (cur) {
    blk.store_all(cur, hd, block);
    if (threadIdx.x == 0) *cur_sc = sc;
  }
}

// One chunk's partial into sm.m, sm.l, sm.acc: a fresh online softmax over
// the tiles of positions [c0, c1) (c1 <= S; c0 >= S: an empty chunk).  Scores
// are q.k * hd^-0.5 plus the additive mask (-1e30 on invalid positions).
// Where the slot has a valid position (any_valid), a tile with none is
// skipped (its probabilities are exactly 0), so a chunk with none keeps
// m = -inf, l = 0, acc = 0.  Where it has none, no tile is skipped: every
// score is then -1e30 exactly, and the softmax is uniform over all S
// positions, as the reference's is.  The first tile's words are asked for
// with the chunk's mask (unless the caller already did both: staged, the
// words in regs and the mask in sm.mk), and each next tile's before this
// one is computed.  Every dot product and the PV sums run in position
// order, one fused multiply-add at a time.
template <typename Rows>
__device__ void chunk_partial(const float* __restrict__ mrow, const Rows& krows,
                              const Rows& vrows, const TileSide& ks, const TileSide& vs,
                              const KvSmem& sm, int bidx, int c0, int c1, int g, int S, int hd,
                              int block, float inv_sqrt, bool any_valid, TileRegs& regs,
                              bool staged) {
  constexpr int kTiles = kChunk / kTile;
  if (!staged && c0 < c1) fetch_tile(krows, vrows, ks, vs, c0, S, block, bidx, regs);
  for (int i = threadIdx.x; i < g * hd; i += blockDim.x) sm.acc[i] = 0.f;
  for (int i = threadIdx.x; i < g; i += blockDim.x) {
    sm.m[i] = -INFINITY;
    sm.l[i] = 0.f;
  }
  // the chunk's mask into shared memory, and which of its tiles take part
  const int s_own = c0 + (int)threadIdx.x;
  float mk = -INFINITY;
  if (threadIdx.x < kChunk && s_own < c1) mk = staged ? sm.mk[threadIdx.x] : mrow[s_own];
  if (threadIdx.x < kChunk) sm.mk[threadIdx.x] = mk;
  bool live[kTiles];
#pragma unroll
  for (int j = 0; j < kTiles; ++j) {
    const int any = __syncthreads_or((int)threadIdx.x / kTile == j && mk > -1e29f);
    live[j] = c0 + j * kTile < c1 && (any || !any_valid);  // block-uniform
  }
  int next = 0;
  while (next < kTiles && !live[next]) ++next;
  if (next > 0 && next < kTiles)  // the first tile was skipped: fetch the first live one
    fetch_tile(krows, vrows, ks, vs, c0 + next * kTile, S, block, bidx, regs);

#pragma unroll
  for (int j = 0; j < kTiles; ++j) {
    if (!live[j]) continue;
    const int t0 = c0 + j * kTile;
    store_tile(krows, vrows, ks, vs, t0, S, block, bidx, regs);
    __syncthreads();
    next = j + 1;
    while (next < kTiles && !live[next]) ++next;
    if (next < kTiles) fetch_tile(krows, vrows, ks, vs, c0 + next * kTile, S, block, bidx, regs);

    // scores: one (query row, position) a thread, q read four at a time
    for (int i = threadIdx.x; i < g * kTile; i += blockDim.x) {
      const int gi = i / kTile, t = i % kTile, s = t0 + t;
      const float* qr = sm.q + gi * hd;
      const float* kr = sm.kf + t * (hd + 1);
      float acc = 0.f;
      for (int c = 0; c < hd; c += 8) {  // hd % 16 == 0
        const float4 qa = *reinterpret_cast<const float4*>(qr + c);
        const float4 qb = *reinterpret_cast<const float4*>(qr + c + 4);
        acc = __fmaf_rn(qa.x, kr[c], acc);
        acc = __fmaf_rn(qa.y, kr[c + 1], acc);
        acc = __fmaf_rn(qa.z, kr[c + 2], acc);
        acc = __fmaf_rn(qa.w, kr[c + 3], acc);
        acc = __fmaf_rn(qb.x, kr[c + 4], acc);
        acc = __fmaf_rn(qb.y, kr[c + 5], acc);
        acc = __fmaf_rn(qb.z, kr[c + 6], acc);
        acc = __fmaf_rn(qb.w, kr[c + 7], acc);
      }
      sm.p[i] = s < S ? __fmaf_rn(acc, inv_sqrt, sm.mk[s - c0]) : -INFINITY;
    }
    __syncthreads();

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int gi = warp; gi < g; gi += blockDim.x >> 5) {
      const float s = sm.p[gi * kTile + lane];
      const float m_old = sm.m[gi];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float e = expf(s - m_new);
      const float sum = warp_sum(e);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        sm.corr[gi] = corr;
        sm.l[gi] = __fmaf_rn(sm.l[gi], corr, sum);
        sm.m[gi] = m_new;
      }
      sm.p[gi * kTile + lane] = e;
    }
    __syncthreads();

    // probabilities times V: one column a thread for kQueryGroup query rows,
    // each V value read once, the rows' probabilities four positions at a time
    for (int c = threadIdx.x; c < hd; c += blockDim.x) {
      for (int g0 = 0; g0 < g; g0 += kQueryGroup) {
        float a[kQueryGroup];
#pragma unroll
        for (int u = 0; u < kQueryGroup; ++u)
          if (g0 + u < g) a[u] = __fmul_rn(sm.acc[(g0 + u) * hd + c], sm.corr[g0 + u]);
#pragma unroll 2
        for (int t = 0; t < kTile; t += 4) {
          const float v0 = sm.vf[t * hd + c], v1 = sm.vf[(t + 1) * hd + c];
          const float v2 = sm.vf[(t + 2) * hd + c], v3 = sm.vf[(t + 3) * hd + c];
#pragma unroll
          for (int u = 0; u < kQueryGroup; ++u) {
            if (g0 + u >= g) continue;
            const float4 pp = *reinterpret_cast<const float4*>(sm.p + (g0 + u) * kTile + t);
            a[u] = __fmaf_rn(pp.x, v0, a[u]);
            a[u] = __fmaf_rn(pp.y, v1, a[u]);
            a[u] = __fmaf_rn(pp.z, v2, a[u]);
            a[u] = __fmaf_rn(pp.w, v3, a[u]);
          }
        }
#pragma unroll
        for (int u = 0; u < kQueryGroup; ++u)
          if (g0 + u < g) sm.acc[(g0 + u) * hd + c] = a[u];
      }
    }
    __syncthreads();
  }
}

// Fold one chunk's partial (mc, lc, oc) into the running (M, L, O): the
// one combine of the split, the same in every mode.  An empty chunk (mc =
// -inf) adds nothing; the first non-empty one is copied exactly (M = -inf
// gives a = 0, b = 1).
__device__ __forceinline__ void fold_chunk(float& M, float& L, float& O, float mc, float lc,
                                           float oc) {
  if (mc == -INFINITY) return;
  const float Mn = fmaxf(M, mc);
  const float a = expf(M - Mn), b = expf(mc - Mn);
  L = __fmaf_rn(L, a, __fmul_rn(lc, b));
  O = __fmaf_rn(O, a, __fmul_rn(oc, b));
  M = Mn;
}

// Attend q (g, hd) over the S positions of one (slot, kv head) as the rank
// `rank` of `csize` CTAs (csize 1: walk every chunk here): scores q.k *
// hd^-0.5 plus the additive mask, softmax with a 1e-30 floor on the
// denominator, then the probabilities times V.  Sequence block bidx is read
// from sm.kblk / sm.vblk at scales ksc_new / vsc_new (-1: none).  The rank
// writes out[e0, e1), its slice of the g * hd outputs.  With csize > 1 the
// kernel must be launched in clusters of csize along x, every rank calling
// this (it synchronizes the cluster).
template <typename T, typename Rows>
__device__ void attend(const T* __restrict__ q, const float* __restrict__ mrow,
                       const Rows& krows, const Rows& vrows, const KvSmem& sm, float ksc_new,
                       float vsc_new, int bidx, float* __restrict__ out, int g, int S, int hd,
                       int block, int lk, int lv, int rank, int csize) {
  const int E = g * hd;
  // rows are whole words: hd % 16 == 0
  const TileSide ks{reinterpret_cast<const uint32_t*>(sm.kblk), ksc_new, hd / lk / 4, 4 * lk,
                    8 / lk, hd + 1, sm.kf};
  const TileSide vs{reinterpret_cast<const uint32_t*>(sm.vblk), vsc_new, hd / lv / 4, 4 * lv,
                    8 / lv, hd, sm.vf};
  // the first chunk's first tile is asked for before anything else
  TileRegs regs;
  if (rank * kChunk < S) fetch_tile(krows, vrows, ks, vs, rank * kChunk, S, block, bidx, regs);
  for (int i = threadIdx.x; i < g; i += blockDim.x) {
    sm.tm[i] = -INFINITY;
    sm.tl[i] = 0.f;
  }
  // q into shared memory and the mask scanned for a valid position (the
  // first chunk's mask kept), every load of a batch in flight before any is
  // used
  bool seen = false;
  for (int base = threadIdx.x; base < (E > S ? E : S); base += kFetch * kKvThreads) {
    float qv[kFetch], mv[kFetch];
#pragma unroll
    for (int j = 0; j < kFetch; ++j) {
      const int i = base + j * kKvThreads;
      qv[j] = i < E ? to_f(q[i]) : 0.f;
      mv[j] = i < S ? mrow[i] : -INFINITY;
    }
#pragma unroll
    for (int j = 0; j < kFetch; ++j) {
      const int i = base + j * kKvThreads;
      if (i < E) sm.q[i] = qv[j];
      if (i >= rank * kChunk && i < (rank + 1) * kChunk) sm.mk[i - rank * kChunk] = mv[j];
      seen |= mv[j] > -1e29f;
    }
  }
  const bool any_valid = __syncthreads_or(seen);
  const float inv_sqrt = 1.0f / sqrtf((float)hd);
  const int nc = (S + kChunk - 1) / kChunk, rounds = (nc + csize - 1) / csize;
  const int e0 = rank * E / csize, e1 = (rank + 1) * E / csize;
  cg::cluster_group cluster = cg::this_cluster();

  for (int k = 0; k < rounds; ++k) {
    const int c0 = (k * csize + rank) * kChunk;
    chunk_partial(mrow, krows, vrows, ks, vs, sm, bidx, c0, min(c0 + kChunk, S), g, S, hd,
                  block, inv_sqrt, any_valid, regs, k == 0);
    if (csize > 1) cluster.sync();  // the round's partials are complete

    const int cnt = min(csize, nc - k * csize);  // the round's chunks, in rank order
    const bool last = k == rounds - 1;
    for (int i = e0 + (int)threadIdx.x; i < e1; i += blockDim.x) {
      const int gi = i / hd;
      float M = sm.tm[gi], L = sm.tl[gi], O = k ? sm.tot[i] : 0.f;
      for (int j0 = 0; j0 < cnt; j0 += kFoldBatch) {
        float mc[kFoldBatch], lc[kFoldBatch], oc[kFoldBatch];
#pragma unroll
        for (int j = 0; j < kFoldBatch; ++j) {  // a batch of ranks' loads in flight, then the fold
          if (j0 + j < cnt) {
            const int r = j0 + j;
            const float* pm = csize > 1 ? cluster.map_shared_rank(sm.m, r) : sm.m;
            const float* pl = csize > 1 ? cluster.map_shared_rank(sm.l, r) : sm.l;
            const float* pa = csize > 1 ? cluster.map_shared_rank(sm.acc, r) : sm.acc;
            mc[j] = pm[gi];
            lc[j] = pl[gi];
            oc[j] = pa[i];
          }
        }
#pragma unroll
        for (int j = 0; j < kFoldBatch; ++j)
          if (j0 + j < cnt) fold_chunk(M, L, O, mc[j], lc[j], oc[j]);
      }
      if (last) out[i] = O / fmaxf(L, 1e-30f);
      else sm.tot[i] = O;
    }
    if (!last) {  // carry (M, L) of every query row into the next round
      __syncthreads();
      for (int gi = threadIdx.x; gi < g; gi += blockDim.x) {
        float M = sm.tm[gi], L = sm.tl[gi], O = 0.f;
        for (int j = 0; j < cnt; ++j) {
          const float* pm = csize > 1 ? cluster.map_shared_rank(sm.m, j) : sm.m;
          const float* pl = csize > 1 ? cluster.map_shared_rank(sm.l, j) : sm.l;
          fold_chunk(M, L, O, pm[gi], pl[gi], 0.f);
        }
        sm.tm[gi] = M;
        sm.tl[gi] = L;
      }
    }
    // the partials are read: the next round may overwrite them, a rank may exit
    if (csize > 1) cluster.sync();
    else __syncthreads();
  }
}

// Zeros into this rank's slice of the g * hd outputs: a slot whose write
// position lies outside [0, S) attends to nothing.
__device__ __forceinline__ void zero_slice(float* out, int E, int rank, int csize) {
  for (int i = rank * E / csize + (int)threadIdx.x; i < (rank + 1) * E / csize; i += blockDim.x)
    out[i] = 0.f;
}

// Whether this rank's chunks hold position p (rank r of csize takes chunks
// r, r + csize, ...): the one CTA that requantizes p's block.
__device__ __forceinline__ bool holds_position(int p, int rank, int csize) {
  return (p / kChunk) % csize == rank;
}


inline bool bad_kv_bits(int bits) { return bits != 2 && bits != 4 && bits != 6 && bits != 8; }

// The attention bodies read packed rows as 4-byte words, the requantization
// a touched block's groups as vectors of up to 16 bytes.
inline bool misaligned(const void* p) { return reinterpret_cast<uintptr_t>(p) & 15; }

// Raise the kernel's dynamic shared-memory limit, then launch it.
template <typename Kernel, typename... Args>
cudaError_t launch_kv(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream,
                      Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kKvThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// Launch an attention kernel over (csize, n_kv, B): in clusters of csize
// CTAs along x (csize 1: one CTA walks every chunk, no cluster).
template <typename Kernel, typename... Args>
cudaError_t launch_kv_split(Kernel kernel, int csize, int n_kv, int B, size_t smem,
                            cudaStream_t stream, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (csize > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)csize, (unsigned)n_kv, (unsigned)B);
  cfg.blockDim = dim3(kKvThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = csize > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// A cluster size the split takes for S positions: 1 .. min(chunks,
// kMaxCluster); above 1 a fused step also needs each sequence block inside
// one chunk, so that one CTA alone requantizes it.
inline bool bad_split(int csize, int S, int block, bool fused) {
  const int nc = (S + kChunk - 1) / kChunk;
  return csize < 1 || csize > kMaxCluster || csize > nc ||
         (fused && csize > 1 && kChunk % block);
}

}  // namespace rq
