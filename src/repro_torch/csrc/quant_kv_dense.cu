// The dense quantized-KV kernels alone: the append and the attention halves
// of the fused decode step (quant_kv_decode_step.cu), each its own launch.
// The append takes a burst of positions, the speculative commit's replay.
//
// Replaces two TPU kernels of repro/kernels/quant_kv/kernel.py:
//   quant_kv_append_burst  <- quant_kv_append_pallas (:165, pallas_call at
//                             :199), and the sequence of its calls that the
//                             JAX package's spec.loop.commit_state makes
//   quant_kv_attention     <- quant_kv_attention_pallas (:103, pallas_call at :121)
//
// Bound on the H100: bytes.  The append reads each touched block's rows
// before its first write offset, its scale and the new rows, and writes the
// block and its scale; the attention reads the packed K and V rows of the
// valid positions and their block scales.  Both do little arithmetic.
//
// Design.
//  * quant_kv_append_burst appends burst positions start[b] + j, j = 0 ..
//    acc[b], of every slot in one launch, both sides, one CTA per (head,
//    slot, side), the block found through the dense row layout and
//    requantized IN PLACE by quant_kv.cuh's BlockSide (one vector load a
//    thread, the values in registers; the Pallas kernel emits the block and
//    the caller scatters it).  The touched block's bytes stay in the CTA's
//    registers from one position to the next, so each position requantizes
//    exactly the bytes the previous append left, and go back to the cache
//    when the burst moves to the next block and at the end.  One decode
//    append is the burst of one position (J = 1, acc = 0).  A position
//    outside [0, S) writes nothing: that is how a masked row is expressed on
//    the card, and it matches the reference's append, whose block select
//    matches no block there.
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
quant_kv_append_burst_kernel(const int* __restrict__ start, const int* __restrict__ acc,
                             const T* __restrict__ k_burst, const T* __restrict__ v_burst,
                             int8_t* k_packed, float* k_scale, int8_t* v_packed, float* v_scale,
                             int H, int S, int hd, int block, int k_bits, int v_bits, int J) {
  __shared__ float red[2 * kRed];
  const int h = blockIdx.x, b = blockIdx.y, side = blockIdx.z;
  const int bits = side ? v_bits : k_bits;
  const size_t bh = (size_t)b * H + h;
  const int hdp = hd / lanes_of(bits), nb = S / block;
  uint8_t* packed = reinterpret_cast<uint8_t*>(side ? v_packed : k_packed) + bh * S * hdp;
  float* scale = (side ? v_scale : k_scale) + bh * nb;
  const T* rows = (side ? v_burst : k_burst) + ((size_t)b * J * H + h) * hd;
  append_burst(rows, (size_t)H * hd, start[b], acc[b], J, bits, hd, block, red,
               [&](int p, uint8_t*& base, float*& sc) {
                 if (p < 0 || p >= S) return false;
                 base = packed + (size_t)(p / block) * block * hdp;
                 sc = scale + p / block;
                 return true;
               });
}

template <typename T>
__global__ void __launch_bounds__(kKvThreads, 2)
quant_kv_attention_kernel(const T* __restrict__ q, const int8_t* __restrict__ k_packed,
                          const float* __restrict__ k_scale, const int8_t* __restrict__ v_packed,
                          const float* __restrict__ v_scale, const float* __restrict__ mask,
                          float* __restrict__ out, int n_kv, int g, int S, int hd, int block,
                          int k_bits, int v_bits) {
  extern __shared__ __align__(16) float smem[];
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
cudaError_t launch_append_burst(const void* start, const void* acc, const void* k_burst,
                                const void* v_burst, void* k_packed, void* k_scale,
                                void* v_packed, void* v_scale, int B, int H, int S, int hd,
                                int block, int k_bits, int v_bits, int J, cudaStream_t stream) {
  quant_kv_append_burst_kernel<T><<<dim3((unsigned)H, (unsigned)B, 2), kKvThreads, 0, stream>>>(
      static_cast<const int*>(start), static_cast<const int*>(acc),
      static_cast<const T*>(k_burst), static_cast<const T*>(v_burst),
      static_cast<int8_t*>(k_packed), static_cast<float*>(k_scale),
      static_cast<int8_t*>(v_packed), static_cast<float*>(v_scale), H, S, hd, block, k_bits,
      v_bits, J);
  return cudaGetLastError();
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

// Both sides' append of a burst: start / acc (B,) i32 (positions start + j
// for j = 0 .. acc, acc < 0: none; a position outside [0, S) writes
// nothing); k_burst / v_burst (B, J, H, hd) in the activation type; packed
// (B, H, S, hdp) int8 and scales (B, H, S / block) f32, written in place at
// each slot's touched blocks.  One append is the burst J = 1, acc = 0.
extern "C" int rq_quant_kv_append_burst(const void* start, const void* acc, const void* k_burst,
                                        const void* v_burst, void* k_packed, void* k_scale,
                                        void* v_packed, void* v_scale, int B, int H, int S,
                                        int hd, int block, int k_bits, int v_bits, int J,
                                        int dtype, void* stream) {
  if (rq::bad_dense_shape(B, H, S, hd, block) || rq::bad_kv_bits(k_bits) ||
      rq::bad_kv_bits(v_bits) || rq::bad_req_block(hd, block, rq::kKvThreads) || J < 1 ||
      rq::misaligned(k_packed) || rq::misaligned(v_packed))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rq::kF32)
    return (int)rq::launch_append_burst<float>(start, acc, k_burst, v_burst, k_packed, k_scale,
                                               v_packed, v_scale, B, H, S, hd, block, k_bits,
                                               v_bits, J, s);
  if (dtype == rq::kBF16)
    return (int)rq::launch_append_burst<__nv_bfloat16>(start, acc, k_burst, v_burst, k_packed,
                                                       k_scale, v_packed, v_scale, B, H, S, hd,
                                                       block, k_bits, v_bits, J, s);
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
