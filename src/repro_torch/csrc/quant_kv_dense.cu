// The dense quantized-KV kernels alone: the append and the attention halves
// of the fused decode step (quant_kv_decode_step.cu), each its own launch.
//
// Replaces two TPU kernels of repro/kernels/quant_kv/kernel.py:
//   quant_kv_append     <- quant_kv_append_pallas (:165, pallas_call at :199)
//   quant_kv_attention  <- quant_kv_attention_pallas (:103, pallas_call at :121)
//
// Bound on the H100: bytes.  The append reads the touched block's rows before
// the write offset, one scale and the new row, and writes one block and its
// scale; the attention reads the packed K and V rows of the valid positions
// and their block scales.  Both do little arithmetic.
//
// Design.
//  * quant_kv_append is the dense counterpart of quant_kv_append_paged: one
//    side per launch, one block per (head, slot), the block at pos / block
//    found through the dense row layout and requantized IN PLACE by
//    quant_kv.cuh's requant_side (the Pallas kernel emits the block and the
//    caller scatters it).  A slot whose pos lies outside [0, S) writes
//    nothing: that is how the speculative commit's masked rows are expressed
//    on the card (spec/loop.py passes pos -1), and it matches the reference's
//    append, whose block select matches no block there.
//  * quant_kv_attention runs quant_kv.cuh's split attend over DenseRows on
//    the fused step's grid, (csize, n_kv, B) with the chunks of a (slot, kv
//    head) on a cluster of csize CTAs or walked by one.  It is the fused
//    step's attend half with the same arithmetic in the same order, so the
//    fused step equals this append followed by this attention bit for bit
//    (chip_smoke.py holds that on the card).
#include "quant_kv.cuh"

namespace rq {

template <typename T>
__global__ void __launch_bounds__(kKvThreads)
quant_kv_append_kernel(const int* __restrict__ pos, const T* __restrict__ new_rows,
                       int8_t* packed, float* scale, int H, int S, int hd, int block, int bits) {
  extern __shared__ float smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int p = pos[b];
  if (p < 0 || p >= S) return;  // a masked or out-of-range row: nothing to write
  float* red = smem;
  float* rq = red + kRed;
  uint8_t* blk_copy = reinterpret_cast<uint8_t*>(rq + block * hd);
  const size_t bh = (size_t)b * H + h;
  const int hdp = hd / lanes_of(bits), bidx = p / block;
  requant_side(reinterpret_cast<uint8_t*>(packed) + (bh * S + (size_t)bidx * block) * hdp,
               scale + bh * (S / block) + bidx, new_rows + bh * hd, blk_copy, bits, hd, block,
               p % block, rq, red);
}

template <typename T>
__global__ void __launch_bounds__(kKvThreads, 2)
quant_kv_attention_kernel(const T* __restrict__ q, const int8_t* __restrict__ k_packed,
                          const float* __restrict__ k_scale, const int8_t* __restrict__ v_packed,
                          const float* __restrict__ v_scale, const float* __restrict__ mask,
                          float* __restrict__ out, int n_kv, int g, int S, int hd, int block,
                          int k_bits, int v_bits) {
  extern __shared__ float smem[];
  const int h = blockIdx.y, b = blockIdx.z, bh = b * n_kv + h;
  const int nb = S / block;
  const int lk = lanes_of(k_bits), lv = lanes_of(v_bits);
  const int hdp_k = hd / lk, hdp_v = hd / lv;
  const KvSmem sm = carve_kv_smem(smem, g, hd, block, hdp_k);
  const DenseRows krows{reinterpret_cast<const uint32_t*>(k_packed + (size_t)bh * S * hdp_k),
                        k_scale + (size_t)bh * nb, hdp_k / 4, block};
  const DenseRows vrows{reinterpret_cast<const uint32_t*>(v_packed + (size_t)bh * S * hdp_v),
                        v_scale + (size_t)bh * nb, hdp_v / 4, block};
  attend(q + (size_t)bh * g * hd, mask + (size_t)b * S, krows, vrows, sm, 0.f, 0.f, -1,
         out + (size_t)bh * g * hd, g, S, hd, block, lk, lv, (int)blockIdx.x, (int)gridDim.x);
}

template <typename T>
cudaError_t launch_append(const void* pos, const void* new_rows, void* packed, void* scale, int B,
                          int H, int S, int hd, int block, int bits, cudaStream_t stream) {
  return launch_kv(quant_kv_append_kernel<T>, dim3((unsigned)H, (unsigned)B),
                   append_smem_bytes(hd, block, bits), stream, static_cast<const int*>(pos),
                   static_cast<const T*>(new_rows), static_cast<int8_t*>(packed),
                   static_cast<float*>(scale), H, S, hd, block, bits);
}

template <typename T>
cudaError_t launch_attention(const void* q, const void* k_packed, const void* k_scale,
                             const void* v_packed, const void* v_scale, const void* mask,
                             void* out, int B, int n_kv, int g, int S, int hd, int block,
                             int k_bits, int v_bits, int csize, cudaStream_t stream) {
  const size_t smem = kv_smem_bytes(g, hd, block, hd / lanes_of(k_bits), hd / lanes_of(v_bits));
  return launch_kv_split(quant_kv_attention_kernel<T>, csize, n_kv, B, smem, stream,
                         static_cast<const T*>(q), static_cast<const int8_t*>(k_packed),
                         static_cast<const float*>(k_scale),
                         static_cast<const int8_t*>(v_packed),
                         static_cast<const float*>(v_scale), static_cast<const float*>(mask),
                         static_cast<float*>(out), n_kv, g, S, hd, block, k_bits, v_bits);
}

inline bool bad_dense_shape(int B, int H, int S, int hd, int block) {
  return B < 1 || H < 1 || hd < 16 || hd % 16 || block < 1 || S < block || S % block;
}

}  // namespace rq

// One side's append: pos (B,) i32, a row outside [0, S) writes nothing;
// new_rows (B, H, hd) in the activation type; packed (B, H, S, hdp) int8 and
// scale (B, H, S / block) f32, written in place at each slot's touched block.
extern "C" int rq_quant_kv_append(const void* pos, const void* new_rows, void* packed,
                                  void* scale, int B, int H, int S, int hd, int block, int bits,
                                  int dtype, void* stream) {
  if (rq::bad_dense_shape(B, H, S, hd, block) || rq::bad_kv_bits(bits))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rq::kF32)
    return (int)rq::launch_append<float>(pos, new_rows, packed, scale, B, H, S, hd, block, bits,
                                         s);
  if (dtype == rq::kBF16)
    return (int)rq::launch_append<__nv_bfloat16>(pos, new_rows, packed, scale, B, H, S, hd, block,
                                                 bits, s);
  return (int)cudaErrorInvalidValue;
}

// q (B, n_kv, g, hd) with hd % 16 == 0; packed (B, n_kv, S, hdp) int8 and
// scales (B, n_kv, S / block) f32, only read; mask (B, S) f32 additive; out
// (B, n_kv, g, hd) f32; csize the CTAs a (slot, kv head) takes.
extern "C" int rq_quant_kv_attention(const void* q, const void* k_packed, const void* k_scale,
                                     const void* v_packed, const void* v_scale, const void* mask,
                                     void* out, int B, int n_kv, int g, int S, int hd, int block,
                                     int k_bits, int v_bits, int csize, int dtype, void* stream) {
  if (rq::bad_dense_shape(B, n_kv, S, hd, block) || g < 1 || rq::bad_kv_bits(k_bits) ||
      rq::bad_kv_bits(v_bits) || rq::bad_split(csize, S, block, false) ||
      rq::misaligned(k_packed) || rq::misaligned(v_packed))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rq::kF32)
    return (int)rq::launch_attention<float>(q, k_packed, k_scale, v_packed, v_scale, mask, out, B,
                                            n_kv, g, S, hd, block, k_bits, v_bits, csize, s);
  if (dtype == rq::kBF16)
    return (int)rq::launch_attention<__nv_bfloat16>(q, k_packed, k_scale, v_packed, v_scale, mask,
                                                    out, B, n_kv, g, S, hd, block, k_bits, v_bits,
                                                    csize, s);
  return (int)cudaErrorInvalidValue;
}
