// quant_kv_decode_step: one decode token per (slot, kv head) over the dense
// packed quantized KV cache: requantize the touched sequence block with the
// new K/V row, then attend over the post-append view.
//
// Replaces the TPU kernel quant_kv_decode_step_pallas (repro/kernels/
// quant_kv/kernel.py:358, pallas_call at :409): _requant_row (:302) and
// _attn_math (:74).
//
// Bound on the H100: the packed K and V bytes of the valid positions (plus
// their block scales) at 3.35 TB/s; the arithmetic is small.
//
// Design.  quant_kv.cuh's split body, shared with rows 4, 6, 7 and 8.
//  * Grid (csize, n_kv, B): the kChunk-position chunks of one (slot, kv
//    head) on the csize CTAs of a thread-block cluster (at most 16; more
//    chunks than that are taken in rounds), or all on one CTA (csize 1,
//    "walk"); kernels/quant_kv/kernel.py's attend_plan picks csize by shape,
//    and both give the same bits.  gemma-2b's MQA at max_seq 1024 and 8
//    slots: 8 clusters of 16.
//  * Requantize first (requantize_kv), in the one CTA whose chunks hold pos:
//    the new block and its scale are WRITTEN INTO THE CACHE IN PLACE (this
//    replaces the Pallas path's ops.place_block scatter) and a copy of the
//    block stays in that CTA's shared memory, from which it attends to
//    those rows; no other CTA reads the block (a cluster needs each block
//    inside one chunk: kChunk % block == 0), so nothing races.
//  * Then attend: the Pallas body holds a head's whole cache in VMEM; at hd
//    256 and S 512 that is 256 KB for K+V, over the 227 KB a block can use,
//    so each chunk is tiled in 32 positions with an online softmax: output
//    agrees within tolerance, cache bytes exactly.  A tile's packed rows
//    are read as 4-byte words, neighbouring threads on neighbouring words,
//    all of a thread's words of both sides in flight, and dequantized into
//    shared memory.
#include "quant_kv.cuh"

namespace rq {

template <typename T>
__global__ void __launch_bounds__(kKvThreads, 2)
quant_kv_decode_step_kernel(const int* __restrict__ pos, const T* __restrict__ q,
                            const T* __restrict__ k_new, const T* __restrict__ v_new,
                            int8_t* k_packed, float* k_scale, int8_t* v_packed, float* v_scale,
                            const float* __restrict__ mask, float* __restrict__ out,
                            int n_kv, int g, int S, int hd, int block, int k_bits, int v_bits) {
  extern __shared__ __align__(16) float smem[];
  const int rank = blockIdx.x, csize = gridDim.x;
  const int h = blockIdx.y, b = blockIdx.z, bh = b * n_kv + h;
  const int nb = S / block;
  const int lk = lanes_of(k_bits), lv = lanes_of(v_bits);
  const int hdp_k = hd / lk, hdp_v = hd / lv;
  const KvSmem sm = carve_kv_smem(smem, g, hd, block, hdp_k);

  uint8_t* kp = reinterpret_cast<uint8_t*>(k_packed) + (size_t)bh * S * hdp_k;
  uint8_t* vp = reinterpret_cast<uint8_t*>(v_packed) + (size_t)bh * S * hdp_v;
  float* ks = k_scale + (size_t)bh * nb;
  float* vs = v_scale + (size_t)bh * nb;
  float* o = out + (size_t)bh * g * hd;
  const int p = pos[b];
  if (p < 0 || p >= S) {  // no block to write: leave the cache alone, attend to nothing
    zero_slice(o, g * hd, rank, csize);
    return;
  }
  int bidx = -1;  // sequence block read from shared memory; -1 = none
  float ksc = 0.f, vsc = 0.f;
  if (holds_position(p, rank, csize)) {  // block-uniform
    bidx = p / block;
    const int off = p % block;
    requantize_kv(kp + (size_t)bidx * block * hdp_k, ks + bidx, k_new + (size_t)bh * hd,
                  sm.kblk, k_bits, vp + (size_t)bidx * block * hdp_v, vs + bidx,
                  v_new + (size_t)bh * hd, sm.vblk, v_bits, hd, block, off, sm.red, ksc, vsc);
  }
  const DenseRows krows{reinterpret_cast<const uint32_t*>(kp), ks, hdp_k / 4, block};
  const DenseRows vrows{reinterpret_cast<const uint32_t*>(vp), vs, hdp_v / 4, block};
  attend(q + (size_t)bh * g * hd, mask + (size_t)b * S, krows, vrows, sm, ksc, vsc, bidx, o, g,
         S, hd, block, lk, lv, rank, csize);
}

template <typename T>
cudaError_t launch_decode_step(const void* pos, const void* q, const void* k_new,
                               const void* v_new, void* k_packed, void* k_scale,
                               void* v_packed, void* v_scale, const void* mask, void* out,
                               int B, int n_kv, int g, int S, int hd, int block, int k_bits,
                               int v_bits, int csize, cudaStream_t stream) {
  const size_t smem = kv_smem_bytes(g, hd, block, hd / lanes_of(k_bits), hd / lanes_of(v_bits));
  return launch_kv_split(quant_kv_decode_step_kernel<T>, csize, n_kv, B, smem, stream,
                         static_cast<const int*>(pos), static_cast<const T*>(q),
                         static_cast<const T*>(k_new), static_cast<const T*>(v_new),
                         static_cast<int8_t*>(k_packed), static_cast<float*>(k_scale),
                         static_cast<int8_t*>(v_packed), static_cast<float*>(v_scale),
                         static_cast<const float*>(mask), static_cast<float*>(out), n_kv, g, S,
                         hd, block, k_bits, v_bits);
}

}  // namespace rq

// pos (B,) i32; q (B, n_kv, g, hd) with hd % 16 == 0; k_new / v_new
// (B, n_kv, hd), all in one activation type; packed (B, n_kv, S, hdp) int8 and scales (B, n_kv, S/block)
// f32, updated in place; mask (B, S) f32 additive; out (B, n_kv, g, hd) f32;
// csize the CTAs a (slot, kv head) takes (1: one CTA walks every chunk).
extern "C" int rq_quant_kv_decode_step(const void* pos, const void* q, const void* k_new,
                                       const void* v_new, void* k_packed, void* k_scale,
                                       void* v_packed, void* v_scale, const void* mask,
                                       void* out, int B, int n_kv, int g, int S, int hd,
                                       int block, int k_bits, int v_bits, int csize, int dtype,
                                       void* stream) {
  if (B < 1 || n_kv < 1 || g < 1 || hd < 16 || hd % 16 || block < 1 || S % block ||
      rq::bad_kv_bits(k_bits) || rq::bad_kv_bits(v_bits) ||
      rq::bad_split(csize, S, block, true) || rq::bad_req_block(hd, block, rq::kKvThreads) ||
      rq::misaligned(k_packed) || rq::misaligned(v_packed))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rq::kF32)
    return (int)rq::launch_decode_step<float>(pos, q, k_new, v_new, k_packed, k_scale, v_packed,
                                              v_scale, mask, out, B, n_kv, g, S, hd, block,
                                              k_bits, v_bits, csize, s);
  if (dtype == rq::kBF16)
    return (int)rq::launch_decode_step<__nv_bfloat16>(pos, q, k_new, v_new, k_packed, k_scale,
                                                      v_packed, v_scale, mask, out, B, n_kv, g,
                                                      S, hd, block, k_bits, v_bits, csize, s);
  return (int)cudaErrorInvalidValue;
}
