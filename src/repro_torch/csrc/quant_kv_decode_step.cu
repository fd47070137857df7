// quant_kv_decode_step: one decode token per (slot, kv head) over the packed
// quantized KV cache — requantize the touched sequence block with the new
// K/V row, then attend over the post-append view.
//
// Replaces the TPU kernel quant_kv_decode_step_pallas (repro/kernels/
// quant_kv/kernel.py:358, pallas_call at :409): _requant_row (:302) and
// _attn_math (:74) — scores q.k * hd^-0.5 plus an additive mask (-1e30 on
// invalid positions), softmax with a 1e-30 floor on the denominator, then
// the probabilities times V.
//
// Bound on the H100: the packed K and V bytes of the valid positions (plus
// their block scales) at 3.35 TB/s; the arithmetic is small.
//
// Design.  One block per (slot, kv head), as the Pallas grid.
//  * Requantize first.  The touched block (pos / block) is dequantized,
//    rows past the write offset are zeroed, the new row is inserted, and the
//    block is requantized under scale max(amax, 1e-12) / qmax.  The cache
//    bytes must equal the plain version's bit for bit, so: rintf (half to
//    even), IEEE division fp / scale (no fast math, no reciprocal), and the
//    pack / sign-extension of common.cuh.  The new block and its scale are
//    WRITTEN INTO THE CACHE IN PLACE (this replaces the Pallas path's
//    ops.place_block scatter); a copy of the block stays in shared memory.
//  * Then attend.  The Pallas body holds a head's whole cache in VMEM; at
//    hd 256 and S 512 that is 256 KB for K+V, over the 227 KB a block can
//    use, so S is tiled in 32 positions with an online softmax: output
//    agrees within tolerance, cache bytes exactly.  A tile's packed rows
//    are contiguous, so they are read as 4-byte words, neighbouring threads
//    on neighbouring words, and dequantized into shared memory; the touched
//    block is read from the shared-memory copy.  Tiles whose mask has no
//    valid position are skipped (their probabilities are exactly 0).
//  * Occupancy: gemma-2b's MQA gives B x n_kv = 4 blocks on 132 SMs; that is
//    slow but correct.  Splitting S across blocks is later work.
#include <math.h>

#include "common.cuh"

namespace rq {

constexpr int kKvThreads = 256;
constexpr int kTile = 32;  // one warp lane per tile position in the softmax step

struct KvSmem {
  float *q, *acc, *kf, *vf, *p, *m, *l, *corr, *red, *rq;
  uint8_t *kblk, *vblk;
};

__host__ __device__ inline size_t kv_smem_floats(int g, int hd, int block) {
  return (size_t)2 * g * hd + (size_t)kTile * (hd + 1) + (size_t)kTile * hd +
         (size_t)g * kTile + 3 * (size_t)g + 34 + (size_t)block * hd;
}

__host__ __device__ inline size_t kv_smem_bytes(int g, int hd, int block, int hdp_k, int hdp_v) {
  return kv_smem_floats(g, hd, block) * sizeof(float) + (size_t)block * (hdp_k + hdp_v);
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

// Dequantize one side of the tile t0 .. t0 + kTile - 1 into dst (row stride
// ld floats): wpr words per packed row, vpw values per word of cb bits.  Rows
// of the touched block come from its shared-memory copy blk_words.
__device__ __forceinline__ void load_tile(const uint32_t* __restrict__ words,
                                          const uint32_t* blk_words,
                                          const float* __restrict__ scale, float sc_new,
                                          int t0, int S, int block, int bidx, int wpr,
                                          int vpw, int cb, float* dst, int ld) {
  for (int i = threadIdx.x; i < kTile * wpr; i += blockDim.x) {
    const int t = i / wpr, j = i - t * wpr, s = t0 + t;
    uint32_t w = 0u;
    float sc = 0.f;
    if (s < S) {
      const int bi = s / block;
      if (bi == bidx) {
        w = blk_words[(s - bidx * block) * wpr + j];
        sc = sc_new;
      } else {
        w = __ldg(words + (size_t)s * wpr + j);
        sc = __ldg(scale + bi);
      }
    }
    float* d = dst + t * ld + j * vpw;
    for (int v = 0; v < vpw; ++v) d[v] = (float)word_lane(w, cb, v) * sc;
  }
}

// Requantize the touched block of one side in place; returns its new scale.
template <typename T>
__device__ float requant_side(int8_t* __restrict__ packed, float* __restrict__ scale,
                              const T* __restrict__ new_row, uint8_t* __restrict__ blk_out,
                              int bits, int hd, int block, int bidx, int off, float* rq,
                              float* red) {
  const int lanes = lanes_of(bits);
  const int hdp = (hd + lanes - 1) / lanes;
  uint8_t* base = reinterpret_cast<uint8_t*>(packed) + (size_t)bidx * block * hdp;
  const float sc_old = scale[bidx];
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
  if (threadIdx.x == 0) scale[bidx] = sc;
  __syncthreads();
  return sc;
}

template <typename T>
__global__ void __launch_bounds__(kKvThreads)
quant_kv_decode_step_kernel(const int* __restrict__ pos, const T* __restrict__ q,
                            const T* __restrict__ k_new, const T* __restrict__ v_new,
                            int8_t* k_packed, float* k_scale, int8_t* v_packed, float* v_scale,
                            const float* __restrict__ mask, float* __restrict__ out,
                            int n_kv, int g, int S, int hd, int block, int k_bits, int v_bits) {
  extern __shared__ float smem[];
  const int h = blockIdx.x, b = blockIdx.y, bh = b * n_kv + h;
  const int nb = S / block;
  const int lk = lanes_of(k_bits), lv = lanes_of(v_bits);
  const int hdp_k = (hd + lk - 1) / lk, hdp_v = (hd + lv - 1) / lv;

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
  sm.rq = sm.red + 34;
  sm.kblk = reinterpret_cast<uint8_t*>(sm.rq + block * hd);
  sm.vblk = sm.kblk + block * hdp_k;

  int8_t* kp = k_packed + (size_t)bh * S * hdp_k;
  int8_t* vp = v_packed + (size_t)bh * S * hdp_v;
  float* ks = k_scale + (size_t)bh * nb;
  float* vs = v_scale + (size_t)bh * nb;
  const int p = pos[b];
  if (p < 0 || p >= S) {  // no block to write: leave the cache alone, attend to nothing
    for (int i = threadIdx.x; i < g * hd; i += blockDim.x) out[(size_t)bh * g * hd + i] = 0.f;
    return;
  }
  const int bidx = p / block, off = p % block;

  // --- 1. requantize the touched block (K, then V), in place ---------------
  const float ksc_new = requant_side(kp, ks, k_new + (size_t)bh * hd, sm.kblk, k_bits, hd,
                                     block, bidx, off, sm.rq, sm.red);
  const float vsc_new = requant_side(vp, vs, v_new + (size_t)bh * hd, sm.vblk, v_bits, hd,
                                     block, bidx, off, sm.rq, sm.red);

  // --- 2. attend over the post-append view, S tiled, online softmax --------
  for (int i = threadIdx.x; i < g * hd; i += blockDim.x) {
    sm.q[i] = to_f(q[(size_t)bh * g * hd + i]);
    sm.acc[i] = 0.f;
  }
  for (int i = threadIdx.x; i < g; i += blockDim.x) {
    sm.m[i] = -INFINITY;
    sm.l[i] = 0.f;
  }
  const float inv_sqrt = 1.0f / sqrtf((float)hd);
  const float* mrow = mask + (size_t)b * S;
  const uint32_t* kw = reinterpret_cast<const uint32_t*>(kp);  // rows are whole words:
  const uint32_t* vw = reinterpret_cast<const uint32_t*>(vp);  // hd % 16 == 0
  __syncthreads();

  for (int t0 = 0; t0 < S; t0 += kTile) {
    const int t_own = t0 + (int)threadIdx.x;
    const bool valid = threadIdx.x < kTile && t_own < S && mrow[t_own] > -1e29f;
    if (!__syncthreads_or(valid)) continue;  // block-uniform

    load_tile(kw, reinterpret_cast<const uint32_t*>(sm.kblk), ks, ksc_new, t0, S, block, bidx,
              hdp_k / 4, 4 * lk, 8 / lk, sm.kf, hd + 1);
    load_tile(vw, reinterpret_cast<const uint32_t*>(sm.vblk), vs, vsc_new, t0, S, block, bidx,
              hdp_v / 4, 4 * lv, 8 / lv, sm.vf, hd);
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
    out[(size_t)bh * g * hd + i] = sm.acc[i] / fmaxf(sm.l[i / hd], 1e-30f);
}

template <typename T>
cudaError_t launch_decode_step(const void* pos, const void* q, const void* k_new,
                               const void* v_new, void* k_packed, void* k_scale,
                               void* v_packed, void* v_scale, const void* mask, void* out,
                               int B, int n_kv, int g, int S, int hd, int block, int k_bits,
                               int v_bits, cudaStream_t stream) {
  const int hdp_k = (hd + lanes_of(k_bits) - 1) / lanes_of(k_bits);
  const int hdp_v = (hd + lanes_of(v_bits) - 1) / lanes_of(v_bits);
  const size_t smem = kv_smem_bytes(g, hd, block, hdp_k, hdp_v);
  auto kernel = quant_kv_decode_step_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)n_kv, (unsigned)B);
  kernel<<<grid, kKvThreads, smem, stream>>>(
      static_cast<const int*>(pos), static_cast<const T*>(q), static_cast<const T*>(k_new),
      static_cast<const T*>(v_new), static_cast<int8_t*>(k_packed),
      static_cast<float*>(k_scale), static_cast<int8_t*>(v_packed),
      static_cast<float*>(v_scale), static_cast<const float*>(mask),
      static_cast<float*>(out), n_kv, g, S, hd, block, k_bits, v_bits);
  return cudaGetLastError();
}

}  // namespace rq

// pos (B,) i32; q (B, n_kv, g, hd) with hd % 16 == 0; k_new / v_new
// (B, n_kv, hd), all in one activation type; packed (B, n_kv, S, hdp) int8 and scales (B, n_kv, S/block)
// f32, updated in place; mask (B, S) f32 additive; out (B, n_kv, g, hd) f32.
extern "C" int rq_quant_kv_decode_step(const void* pos, const void* q, const void* k_new,
                                       const void* v_new, void* k_packed, void* k_scale,
                                       void* v_packed, void* v_scale, const void* mask,
                                       void* out, int B, int n_kv, int g, int S, int hd,
                                       int block, int k_bits, int v_bits, int dtype,
                                       void* stream) {
  auto bad_bits = [](int bits) { return bits != 2 && bits != 4 && bits != 6 && bits != 8; };
  if (B < 1 || n_kv < 1 || g < 1 || hd < 16 || hd % 16 || block < 1 || S % block ||
      bad_bits(k_bits) || bad_bits(v_bits) ||
      (reinterpret_cast<uintptr_t>(k_packed) & 3) || (reinterpret_cast<uintptr_t>(v_packed) & 3))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rq::kF32)
    return (int)rq::launch_decode_step<float>(pos, q, k_new, v_new, k_packed, k_scale, v_packed,
                                              v_scale, mask, out, B, n_kv, g, S, hd, block,
                                              k_bits, v_bits, s);
  if (dtype == rq::kBF16)
    return (int)rq::launch_decode_step<__nv_bfloat16>(pos, q, k_new, v_new, k_packed, k_scale,
                                                      v_packed, v_scale, mask, out, B, n_kv, g,
                                                      S, hd, block, k_bits, v_bits, s);
  return (int)cudaErrorInvalidValue;
}
