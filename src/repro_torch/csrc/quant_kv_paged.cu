// The paged quantized-KV kernels: the same requantize and attention bodies
// as the dense decode step (quant_kv.cuh), reading the cache through a
// block table into a pool of physical blocks.
//
// Replaces three TPU kernels of repro/kernels/quant_kv/kernel.py:
//   quant_kv_decode_step_paged   <- quant_kv_decode_step_paged_pallas (:491,
//                                   pallas_call at :568)
//   quant_kv_attention_paged     <- quant_kv_attention_paged_pallas (:237,
//                                   pallas_call at :285)
//   quant_kv_append_paged        <- quant_kv_append_paged_pallas (:737,
//                                   pallas_call at :772)
//
// Bound on the H100: bytes.  The packed K and V rows of the mapped blocks a
// slot attends to, their scales and the table rows are read once, the
// touched blocks written once, at 3.35 TB/s; the arithmetic is small.
//
// Design.
//  * The attention kernels run quant_kv.cuh's split body on the dense
//    kernels' grid, (csize, n_kv, B): the chunks of one (slot, kv head) on a
//    cluster of csize CTAs, or walked by one (kernels/quant_kv/kernel.py
//    attend_plan).  A 32-position tile spans two 16-position blocks that may
//    lie far apart in the pool:
//    the tile loader resolves every row through PagedRows (table[slot][s /
//    block]), and an entry < 0 reads as zero levels at scale 1e-12, which
//    is what to_dense gives the plain version.  Dense and paged share the
//    arithmetic and its order, so a pool and a dense cache with the same
//    contents give the same output bit for bit.
//  * The Pallas kernels emit the touched block and the caller scatters it
//    (ops.place_paged_block); here the kernel writes the block and its
//    scale into the pool IN PLACE.  Idle slots (entry < 0 at pos / block)
//    would all clamp to the trash block 0, and in-place writes from several
//    blocks would race there, so the kernels write NOTHING for an unmapped
//    touched entry: block 0 is never written on the card.  Its bytes are no
//    part of the contract (the JAX scatter leaves duplicates unspecified).
//  * The fused step relies on the engine's copy-on-write: a live slot's
//    touched block is mapped by that slot alone, so no other slot's CTAs
//    read the bytes this one rewrites; within the slot only the CTA whose
//    chunks hold pos requantizes the block and reads it, from its
//    shared-memory copy, and only where the table maps it.
//  * The appends keep one block per (head, slot).
#include "quant_kv.cuh"

namespace rq {

template <typename T>
__global__ void __launch_bounds__(kKvThreads, 2)
quant_kv_decode_step_paged_kernel(const int* __restrict__ pos, const int* __restrict__ table,
                                  const T* __restrict__ q, const T* __restrict__ k_new,
                                  const T* __restrict__ v_new, int8_t* k_pool, float* k_scale,
                                  int8_t* v_pool, float* v_scale,
                                  const float* __restrict__ mask, float* __restrict__ out,
                                  int n_kv, int g, int nb, int hd, int block, int k_bits,
                                  int v_bits) {
  extern __shared__ float smem[];
  const int rank = blockIdx.x, csize = gridDim.x;
  const int h = blockIdx.y, b = blockIdx.z, bh = b * n_kv + h;
  const int S = nb * block;
  const int lk = lanes_of(k_bits), lv = lanes_of(v_bits);
  const int hdp_k = hd / lk, hdp_v = hd / lv;
  const KvSmem sm = carve_kv_smem(smem, g, hd, block, hdp_k);
  const int* trow = table + (size_t)b * nb;
  float* o = out + (size_t)bh * g * hd;
  const int p = pos[b];
  if (p < 0 || p >= S) {  // no block to write: leave the pool alone, attend to nothing
    zero_slice(o, g * hd, rank, csize);
    return;
  }
  const int e = trow[p / block];
  int bidx = -1;  // sequence block read from shared memory; -1 = none
  float ksc = 0.f, vsc = 0.f;
  if (e >= 0 && holds_position(p, rank, csize)) {  // block-uniform
    const size_t blk = (size_t)e * n_kv + h;
    const int off = p % block;
    ksc = requant_side(reinterpret_cast<uint8_t*>(k_pool) + blk * block * hdp_k, k_scale + blk,
                       k_new + (size_t)bh * hd, sm.kblk, k_bits, hd, block, off, sm.rq,
                       sm.red);
    vsc = requant_side(reinterpret_cast<uint8_t*>(v_pool) + blk * block * hdp_v, v_scale + blk,
                       v_new + (size_t)bh * hd, sm.vblk, v_bits, hd, block, off, sm.rq,
                       sm.red);
    bidx = p / block;
  }
  const PagedRows krows{reinterpret_cast<const uint32_t*>(k_pool), k_scale, trow, n_kv, h,
                        hdp_k / 4, block};
  const PagedRows vrows{reinterpret_cast<const uint32_t*>(v_pool), v_scale, trow, n_kv, h,
                        hdp_v / 4, block};
  attend(q + (size_t)bh * g * hd, mask + (size_t)b * S, krows, vrows, sm, ksc, vsc, bidx, o, g,
         S, hd, block, lk, lv, rank, csize);
}

template <typename T>
__global__ void __launch_bounds__(kKvThreads, 2)
quant_kv_attention_paged_kernel(const int* __restrict__ table, const T* __restrict__ q,
                                const int8_t* __restrict__ k_pool,
                                const float* __restrict__ k_scale,
                                const int8_t* __restrict__ v_pool,
                                const float* __restrict__ v_scale,
                                const float* __restrict__ mask, float* __restrict__ out,
                                int n_kv, int g, int nb, int hd, int block, int k_bits,
                                int v_bits) {
  extern __shared__ float smem[];
  const int h = blockIdx.y, b = blockIdx.z, bh = b * n_kv + h;
  const int lk = lanes_of(k_bits), lv = lanes_of(v_bits);
  const KvSmem sm = carve_kv_smem(smem, g, hd, block, hd / lk);
  const int* trow = table + (size_t)b * nb;
  const PagedRows krows{reinterpret_cast<const uint32_t*>(k_pool), k_scale, trow, n_kv, h,
                        hd / lk / 4, block};
  const PagedRows vrows{reinterpret_cast<const uint32_t*>(v_pool), v_scale, trow, n_kv, h,
                        hd / lv / 4, block};
  attend(q + (size_t)bh * g * hd, mask + (size_t)b * nb * block, krows, vrows, sm, 0.f, 0.f, -1,
         out + (size_t)bh * g * hd, g, nb * block, hd, block, lk, lv, (int)blockIdx.x,
         (int)gridDim.x);
}

template <typename T>
__global__ void __launch_bounds__(kKvThreads)
quant_kv_append_paged_kernel(const int* __restrict__ pos, const int* __restrict__ table,
                             const T* __restrict__ new_rows, int8_t* pool, float* scale, int H,
                             int nb, int hd, int block, int bits) {
  extern __shared__ float smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int p = pos[b];
  if (p < 0 || p >= nb * block) return;
  const int e = table[(size_t)b * nb + p / block];
  if (e < 0) return;  // idle slot: nothing to write (see the note above)
  float* red = smem;
  float* rq = red + kRed;
  uint8_t* blk_copy = reinterpret_cast<uint8_t*>(rq + block * hd);
  const size_t blk = (size_t)e * H + h;
  const int hdp = hd / lanes_of(bits);
  requant_side(reinterpret_cast<uint8_t*>(pool) + blk * block * hdp, scale + blk,
               new_rows + ((size_t)b * H + h) * hd, blk_copy, bits, hd, block, p % block, rq,
               red);
}

template <typename T>
cudaError_t launch_step_paged(const void* pos, const void* table, const void* q,
                              const void* k_new, const void* v_new, void* k_pool, void* k_scale,
                              void* v_pool, void* v_scale, const void* mask, void* out, int B,
                              int n_kv, int g, int nb, int hd, int block, int k_bits,
                              int v_bits, int csize, cudaStream_t stream) {
  const size_t smem = kv_smem_bytes(g, hd, block, hd / lanes_of(k_bits), hd / lanes_of(v_bits));
  return launch_kv_split(quant_kv_decode_step_paged_kernel<T>, csize, n_kv, B, smem, stream,
                         static_cast<const int*>(pos), static_cast<const int*>(table),
                         static_cast<const T*>(q), static_cast<const T*>(k_new),
                         static_cast<const T*>(v_new), static_cast<int8_t*>(k_pool),
                         static_cast<float*>(k_scale), static_cast<int8_t*>(v_pool),
                         static_cast<float*>(v_scale), static_cast<const float*>(mask),
                         static_cast<float*>(out), n_kv, g, nb, hd, block, k_bits, v_bits);
}

template <typename T>
cudaError_t launch_attention_paged(const void* table, const void* q, const void* k_pool,
                                   const void* k_scale, const void* v_pool, const void* v_scale,
                                   const void* mask, void* out, int B, int n_kv, int g, int nb,
                                   int hd, int block, int k_bits, int v_bits, int csize,
                                   cudaStream_t stream) {
  const size_t smem = kv_smem_bytes(g, hd, block, hd / lanes_of(k_bits), hd / lanes_of(v_bits));
  return launch_kv_split(quant_kv_attention_paged_kernel<T>, csize, n_kv, B, smem, stream,
                         static_cast<const int*>(table), static_cast<const T*>(q),
                         static_cast<const int8_t*>(k_pool), static_cast<const float*>(k_scale),
                         static_cast<const int8_t*>(v_pool), static_cast<const float*>(v_scale),
                         static_cast<const float*>(mask), static_cast<float*>(out), n_kv, g, nb,
                         hd, block, k_bits, v_bits);
}

template <typename T>
cudaError_t launch_append_paged(const void* pos, const void* table, const void* new_rows,
                                void* pool, void* scale, int B, int H, int nb, int hd, int block,
                                int bits, cudaStream_t stream) {
  return launch_kv(quant_kv_append_paged_kernel<T>, dim3((unsigned)H, (unsigned)B),
                   append_smem_bytes(hd, block, bits), stream, static_cast<const int*>(pos),
                   static_cast<const int*>(table), static_cast<const T*>(new_rows),
                   static_cast<int8_t*>(pool), static_cast<float*>(scale), H, nb, hd, block,
                   bits);
}

inline bool bad_paged_shape(int B, int n_kv, int nb, int hd, int block) {
  return B < 1 || n_kv < 1 || nb < 1 || hd < 16 || hd % 16 || block < 1;
}

}  // namespace rq

// pos (B,) i32; table (B, nb) i32, -1 = unmapped; q (B, n_kv, g, hd) with
// hd % 16 == 0; k_new / v_new (B, n_kv, hd) in q's type; pools (P, n_kv,
// block, hdp) int8 and scales (P, n_kv) f32, written in place at each slot's
// mapped touched block; mask (B, nb * block) f32 additive; out (B, n_kv, g,
// hd) f32; csize the CTAs a (slot, kv head) takes (1: one walks every chunk).
extern "C" int rq_quant_kv_decode_step_paged(const void* pos, const void* table, const void* q,
                                             const void* k_new, const void* v_new, void* k_pool,
                                             void* k_scale, void* v_pool, void* v_scale,
                                             const void* mask, void* out, int B, int n_kv, int g,
                                             int nb, int hd, int block, int k_bits, int v_bits,
                                             int csize, int dtype, void* stream) {
  if (rq::bad_paged_shape(B, n_kv, nb, hd, block) || g < 1 || rq::bad_kv_bits(k_bits) ||
      rq::bad_kv_bits(v_bits) || rq::bad_split(csize, nb * block, block, true) ||
      rq::misaligned(k_pool) || rq::misaligned(v_pool))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rq::kF32)
    return (int)rq::launch_step_paged<float>(pos, table, q, k_new, v_new, k_pool, k_scale,
                                             v_pool, v_scale, mask, out, B, n_kv, g, nb, hd,
                                             block, k_bits, v_bits, csize, s);
  if (dtype == rq::kBF16)
    return (int)rq::launch_step_paged<__nv_bfloat16>(pos, table, q, k_new, v_new, k_pool,
                                                     k_scale, v_pool, v_scale, mask, out, B,
                                                     n_kv, g, nb, hd, block, k_bits, v_bits,
                                                     csize, s);
  return (int)cudaErrorInvalidValue;
}

// As above without the append: the pools are only read.
extern "C" int rq_quant_kv_attention_paged(const void* table, const void* q, const void* k_pool,
                                           const void* k_scale, const void* v_pool,
                                           const void* v_scale, const void* mask, void* out,
                                           int B, int n_kv, int g, int nb, int hd, int block,
                                           int k_bits, int v_bits, int csize, int dtype,
                                           void* stream) {
  if (rq::bad_paged_shape(B, n_kv, nb, hd, block) || g < 1 || rq::bad_kv_bits(k_bits) ||
      rq::bad_kv_bits(v_bits) || rq::bad_split(csize, nb * block, block, false) ||
      rq::misaligned(k_pool) || rq::misaligned(v_pool))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rq::kF32)
    return (int)rq::launch_attention_paged<float>(table, q, k_pool, k_scale, v_pool, v_scale,
                                                  mask, out, B, n_kv, g, nb, hd, block, k_bits,
                                                  v_bits, csize, s);
  if (dtype == rq::kBF16)
    return (int)rq::launch_attention_paged<__nv_bfloat16>(table, q, k_pool, k_scale, v_pool,
                                                          v_scale, mask, out, B, n_kv, g, nb,
                                                          hd, block, k_bits, v_bits, csize, s);
  return (int)cudaErrorInvalidValue;
}

// One side's append: pos (B,) i32; table (B, nb) i32; new_rows (B, H, hd);
// pool (P, H, block, hdp) int8 and scale (P, H) f32, written in place.
extern "C" int rq_quant_kv_append_paged(const void* pos, const void* table,
                                        const void* new_rows, void* pool, void* scale, int B,
                                        int H, int nb, int hd, int block, int bits, int dtype,
                                        void* stream) {
  if (rq::bad_paged_shape(B, H, nb, hd, block) || rq::bad_kv_bits(bits))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rq::kF32)
    return (int)rq::launch_append_paged<float>(pos, table, new_rows, pool, scale, B, H, nb, hd,
                                               block, bits, s);
  if (dtype == rq::kBF16)
    return (int)rq::launch_append_paged<__nv_bfloat16>(pos, table, new_rows, pool, scale, B, H,
                                                       nb, hd, block, bits, s);
  return (int)cudaErrorInvalidValue;
}
