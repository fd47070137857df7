// Device code shared by the quantized-KV kernels (quant_kv_decode_step.cu,
// quant_kv_dense.cu, quant_kv_paged.cu): the in-place requantization of one touched block and
// the tiled online-softmax attention of one (slot, kv head).
//
// Both take the cache through a ROW LOCATOR, so the dense and the paged
// kernels run the same arithmetic in the same order:
//   DenseRows  (slot, head) rows of a (B, H, S, hdp) cache, scale per block;
//   PagedRows  table[slot][s / block] -> rows of a (P, H, block, hdp) pool;
//              an entry < 0 reads as zero levels at the init scale 1e-12.
// A pool and a dense cache with the same contents therefore give the same
// attention output bit for bit (the paged engine's tokens equal the dense
// engine's on the card for that reason).
#pragma once

#include <math.h>

#include "common.cuh"

namespace rq {

constexpr int kKvThreads = 256;
constexpr int kTile = 32;  // one warp lane per tile position in the softmax step
constexpr int kRed = 34;   // floats of block-reduction scratch

struct KvSmem {
  float *q, *acc, *kf, *vf, *p, *m, *l, *corr, *red, *rq;
  uint8_t *kblk, *vblk;
};

__host__ __device__ inline size_t kv_smem_floats(int g, int hd, int block) {
  return (size_t)2 * g * hd + (size_t)kTile * (hd + 1) + (size_t)kTile * hd +
         (size_t)g * kTile + 3 * (size_t)g + kRed + (size_t)block * hd;
}

__host__ __device__ inline size_t kv_smem_bytes(int g, int hd, int block, int hdp_k, int hdp_v) {
  return kv_smem_floats(g, hd, block) * sizeof(float) + (size_t)block * (hdp_k + hdp_v);
}

__device__ inline KvSmem carve_kv_smem(float* smem, int g, int hd, int block, int hdp_k) {
  KvSmem sm;
  sm.q = smem;
  sm.acc = sm.q + g * hd;
  sm.kf = sm.acc + g * hd;
  sm.vf = sm.kf + kTile * (hd + 1);
  sm.p = sm.vf + kTile * hd;
  sm.m = sm.p + g * kTile;
  sm.l = sm.m + g;
  sm.corr = sm.l + g;
  sm.red = sm.corr + g;
  sm.rq = sm.red + kRed;
  sm.kblk = reinterpret_cast<uint8_t*>(sm.rq + block * hd);
  sm.vblk = sm.kblk + block * hdp_k;
  return sm;
}

__device__ __forceinline__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_max(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
    t = warp_max(t);
    if (lane == 0) red[0] = t;
  }
  __syncthreads();
  const float out = red[0];
  __syncthreads();
  return out;
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

// Dequantize one side of the tile t0 .. t0 + kTile - 1 into dst (row stride
// ld floats): wpr words per packed row, vpw values per word of cb bits.  Rows
// of sequence block bidx come from its shared-memory copy blk_words at scale
// sc_new (bidx -1: none); a row the locator does not map is zero levels at
// scale 1e-12, exactly what a dense cache holds where nothing was written.
template <typename Rows>
__device__ __forceinline__ void load_tile(const Rows& rows, const uint32_t* blk_words,
                                          float sc_new, int t0, int S, int block, int bidx,
                                          int wpr, int vpw, int cb, float* dst, int ld) {
  for (int i = threadIdx.x; i < kTile * wpr; i += blockDim.x) {
    const int t = i / wpr, j = i - t * wpr, s = t0 + t;
    uint32_t w = 0u;
    float sc = 0.f;
    if (s < S) {
      const uint32_t* p;
      if (s / block == bidx) {
        w = blk_words[(s - bidx * block) * wpr + j];
        sc = sc_new;
      } else if (rows.row(s, p, sc)) {
        w = __ldg(p + j);
      } else {
        sc = 1e-12f;
      }
    }
    float* d = dst + t * ld + j * vpw;
    for (int v = 0; v < vpw; ++v) d[v] = (float)word_lane(w, cb, v) * sc;
  }
}

// Requantize one side's touched block in place: base points at its block x
// hdp packed bytes and sc_ptr at its scale.  Rows before off are kept, row
// off is new_row, rows past it are zeroed; the bytes must equal the plain
// version's bit for bit, so: rintf (half to even), IEEE divisions for both
// amax / qmax and x / scale (no fast math), common.cuh's lane layout.  A
// copy of the new block goes to blk_out.  Returns the new scale.
template <typename T>
__device__ float requant_side(uint8_t* __restrict__ base, float* __restrict__ sc_ptr,
                              const T* __restrict__ new_row, uint8_t* __restrict__ blk_out,
                              int bits, int hd, int block, int off, float* rq, float* red) {
  const int lanes = lanes_of(bits);
  const int hdp = (hd + lanes - 1) / lanes;
  const float sc_old = *sc_ptr;
  float local = 0.f;
  for (int i = threadIdx.x; i < block * hd; i += blockDim.x) {
    const int r = i / hd, c = i % hd;
    float v = 0.f;
    if (r < off) {
      v = (float)unpack_lane(base[r * hdp + c / lanes], bits, c % lanes) * sc_old;
    } else if (r == off) {
      v = to_f(new_row[c]);
    }
    rq[i] = v;
    local = fmaxf(local, fabsf(v));
  }
  const float amax = block_max(local, red);  // also orders the reads above before the writes below
  const float qm = (float)((1 << (bits - 1)) - 1);
  const float sc = __fdiv_rn(fmaxf(amax, 1e-12f), qm);
  for (int i = threadIdx.x; i < block * hdp; i += blockDim.x) {
    const int r = i / hdp, j = i % hdp;
    uint32_t word = 0;
    for (int l = 0; l < lanes; ++l) {
      const int c = j * lanes + l;
      if (c >= hd) break;
      const float t = fminf(fmaxf(rintf(__fdiv_rn(rq[r * hd + c], sc)), -qm), qm);
      word |= pack_field((int)t, bits, l);
    }
    blk_out[i] = (uint8_t)word;
    base[r * hdp + j] = (uint8_t)word;
  }
  if (threadIdx.x == 0) *sc_ptr = sc;
  __syncthreads();
  return sc;
}

// Attend q (g, hd) over the S positions of one (slot, kv head): scores q.k *
// hd^-0.5 plus the additive mask (-1e30 on invalid positions), softmax with a
// 1e-30 floor on the denominator, then the probabilities times V.  S is
// tiled in kTile positions with an online softmax; a tile with no valid
// position is skipped (its probabilities are exactly 0).  Sequence block
// bidx is read from sm.kblk / sm.vblk at scales ksc_new / vsc_new.
template <typename T, typename Rows>
__device__ void attend(const T* __restrict__ q, const float* __restrict__ mrow,
                       const Rows& krows, const Rows& vrows, const KvSmem& sm, float ksc_new,
                       float vsc_new, int bidx, float* __restrict__ out, int g, int S, int hd,
                       int block, int lk, int lv) {
  const int wpr_k = hd / lk / 4, wpr_v = hd / lv / 4;  // rows are whole words: hd % 16 == 0
  for (int i = threadIdx.x; i < g * hd; i += blockDim.x) {
    sm.q[i] = to_f(q[i]);
    sm.acc[i] = 0.f;
  }
  for (int i = threadIdx.x; i < g; i += blockDim.x) {
    sm.m[i] = -INFINITY;
    sm.l[i] = 0.f;
  }
  const float inv_sqrt = 1.0f / sqrtf((float)hd);
  __syncthreads();

  for (int t0 = 0; t0 < S; t0 += kTile) {
    const int t_own = t0 + (int)threadIdx.x;
    const bool valid = threadIdx.x < kTile && t_own < S && mrow[t_own] > -1e29f;
    if (!__syncthreads_or(valid)) continue;  // block-uniform

    load_tile(krows, reinterpret_cast<const uint32_t*>(sm.kblk), ksc_new, t0, S, block, bidx,
              wpr_k, 4 * lk, 8 / lk, sm.kf, hd + 1);
    load_tile(vrows, reinterpret_cast<const uint32_t*>(sm.vblk), vsc_new, t0, S, block, bidx,
              wpr_v, 4 * lv, 8 / lv, sm.vf, hd);
    __syncthreads();

    for (int i = threadIdx.x; i < g * kTile; i += blockDim.x) {
      const int gi = i / kTile, t = i % kTile, s = t0 + t;
      float acc = 0.f;
      const float* qr = sm.q + gi * hd;
      const float* kr = sm.kf + t * (hd + 1);
      for (int c = 0; c < hd; ++c) acc += qr[c] * kr[c];
      sm.p[i] = s < S ? acc * inv_sqrt + mrow[s] : -INFINITY;
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
        sm.l[gi] = sm.l[gi] * corr + sum;
        sm.m[gi] = m_new;
      }
      sm.p[gi * kTile + lane] = e;
    }
    __syncthreads();

    for (int i = threadIdx.x; i < g * hd; i += blockDim.x) {
      const int gi = i / hd, c = i % hd;
      const float* pr = sm.p + gi * kTile;
      float a = sm.acc[i] * sm.corr[gi];
      for (int t = 0; t < kTile; ++t) a += pr[t] * sm.vf[t * hd + c];
      sm.acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < g * hd; i += blockDim.x)
    out[i] = sm.acc[i] / fmaxf(sm.l[i / hd], 1e-30f);
}

// Dynamic shared memory of an append kernel: the reduction scratch, the
// block in f32 and one packed copy of it.
inline size_t append_smem_bytes(int hd, int block, int bits) {
  return ((size_t)kRed + (size_t)block * hd) * sizeof(float) +
         (size_t)block * (hd / lanes_of(bits));
}

inline bool bad_kv_bits(int bits) { return bits != 2 && bits != 4 && bits != 6 && bits != 8; }

// The attention bodies read packed rows as 4-byte words.
inline bool misaligned(const void* p) { return reinterpret_cast<uintptr_t>(p) & 3; }

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

}  // namespace rq
