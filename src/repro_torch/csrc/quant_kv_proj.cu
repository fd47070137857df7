// quant_kv_decode_step_proj: the dense decode step with the fused wqkv GEMV
// and the rotary embedding pulled into the same launch.  Per (slot, kv
// head): project the query group's g * hd rows and one K and one V row-block
// of the packed wqkv from the slot's x row, rotate q and k, then requantize
// the touched K and V blocks in place and attend, exactly as
// quant_kv_decode_step.cu does.
//
// Replaces the TPU kernel quant_kv_decode_step_proj_pallas (repro/kernels/
// quant_kv/kernel.py:640, pallas_call at :708): _fused_step_proj_kernel
// (:597) with _rope_rows (:589), then _requant_row and _attn_math.
//
// Bound on the H100: the bytes, read once: the packed wqkv rows of every
// kv head (all of wqkv), their scales, and the packed K/V rows of the valid
// positions with their block scales, at 3.35 TB/s.
//
// Design.  One block per (slot, kv head), as the Pallas grid.
//  * Projection: the slot's x row is staged in shared memory as the GEMV
//    stages it (three bf16 pieces, every K range), and each warp takes
//    16-row tiles of the block's g * hd + 2 * hd rows (q group h at row h *
//    g * hd, K head h at (n_heads + h) * hd, V head h at (n_heads + n_kv +
//    h) * hd, as the Pallas BlockSpecs slice wqkv; hd % 16 == 0, so a tile
//    never straddles two), sums each K range with quant_gemv.cuh's
//    GemvWarp and adds the ranges from zero in order, then multiplies by the
//    channel's scale: every projected value is the GEMV kernel's value for
//    that row and channel, bit for bit, so the whole step equals the GEMV
//    -> rotary -> decode-step composition bit for bit.  The projection lands
//    in shared memory ((g + 2) * hd floats, 10 KB at gemma-2b's head
//    geometry, beside quant_kv.cuh's ~100 KB).
//  * Rotary: cos / sin come from the caller, computed in torch from the
//    same angle tensor the unfused path builds; the rotation is written
//    with __fmul_rn / __fsub_rn / __fadd_rn so that nvcc does not contract
//    x1 * cos - x2 * sin into an FMA (torch rounds each product).
//  * Then quant_kv.cuh's requantize_kv (K and V, written into the cache in
//    place) and attend, on the shared-memory rows, in its walk mode: this
//    CTA folds every chunk itself, in the order a cluster would, so the
//    output equals row 3's bit for bit (a cluster would multiply the reads
//    of wqkv).  A position outside [0, S) writes nothing and attends to
//    nothing, as the plain step does.
//  * Occupancy: gemma-2b's MQA gives B x 1 blocks (at most 8 on 132 SMs),
//    each reading all of wqkv: slow but correct.  Splitting the projection
//    across blocks is later work.
#include "quant_gemv.cuh"
#include "quant_kv.cuh"

namespace rq {

constexpr int kProjMaxB = 8;   // the GEMV's batch regime, as the reference's gate

// Packed wqkv row of the block's projected row r (kv head h).
__device__ __forceinline__ int proj_row(int r, int h, int n_heads, int n_kv, int g, int hd) {
  const int qr = g * hd;
  if (r < qr) return h * qr + r;
  if (r < qr + hd) return (n_heads + h) * hd + (r - qr);
  return (n_heads + n_kv + h) * hd + (r - qr - hd);
}

// Shared memory: the projection ((g + 2) * hd floats), quant_kv.cuh's
// attention and requantization room, then the x staging (16-byte aligned).
inline __host__ __device__ size_t proj_xs_offset(int g, int hd, int block, int hdp_k, int hdp_v) {
  return round16((size_t)(g + 2) * hd * sizeof(float) + kv_smem_bytes(g, hd, block, hdp_k, hdp_v));
}

template <int CB>
__global__ void __launch_bounds__(kKvThreads)
quant_kv_decode_step_proj_kernel(const int* __restrict__ pos, const float* __restrict__ x,
                                 const uint8_t* __restrict__ w_packed,
                                 const float* __restrict__ w_scale,
                                 const float* __restrict__ cos_t,
                                 const float* __restrict__ sin_t, int8_t* k_packed,
                                 float* k_scale, int8_t* v_packed, float* v_scale,
                                 const float* __restrict__ mask, float* __restrict__ out,
                                 int d, int kp, int wvec, int xvec, int splits, int n_heads,
                                 int n_kv, int S, int hd, int block, int k_bits, int v_bits) {
  extern __shared__ __align__(16) float smem[];
  const int h = blockIdx.x, b = blockIdx.y, bh = b * n_kv + h;
  const int g = n_heads / n_kv;
  const int nb = S / block;
  const int lk = lanes_of(k_bits), lv = lanes_of(v_bits);
  const int hdp_k = hd / lk, hdp_v = hd / lv;
  const int rows = (g + 2) * hd;
  float* proj = smem;                                   // q group, then K, then V
  const KvSmem sm = carve_kv_smem(smem + rows, g, hd, block, hdp_k);

  uint8_t* kp_ = reinterpret_cast<uint8_t*>(k_packed) + (size_t)bh * S * hdp_k;
  uint8_t* vp_ = reinterpret_cast<uint8_t*>(v_packed) + (size_t)bh * S * hdp_v;
  float* ks = k_scale + (size_t)bh * nb;
  float* vs = v_scale + (size_t)bh * nb;
  float* o = out + (size_t)bh * g * hd;
  const int p = pos[b];
  if (p < 0 || p >= S) {  // no block to write: leave the cache alone, attend to nothing
    for (int i = threadIdx.x; i < g * hd; i += blockDim.x) o[i] = 0.f;
    return;
  }
  const int bidx = p / block, off = p % block;

  // 1. project: stage the slot's x row for every K range (M = 1), then each
  // warp sums its 16-row tiles range by range, as the GEMV's CTAs and
  // cluster would
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g8 = lane >> 2;
  const int piece = gemv_piece_bytes<CB>(1, gemv_max_rounds<CB>(d, splits));
  uint8_t* xs = reinterpret_cast<uint8_t*>(smem) + proj_xs_offset(g, hd, block, hdp_k, hdp_v);
  for (int s = 0; s < splits; ++s) {
    int k0, k1;
    gemv_range(d, splits, s, k0, k1);
    gemv_stage_x<CB, float>(x + (size_t)b * d, d, 1, k0, k1,
                            (k1 - k0 + GemvShape<CB>::kRound - 1) / GemvShape<CB>::kRound, xvec,
                            xs + (size_t)s * 3 * piece, piece);
  }
  __syncthreads();
  for (int t = warp; t < rows / kGemvTileRows; t += blockDim.x >> 5) {
    const int n0 = proj_row(t * kGemvTileRows, h, n_heads, n_kv, g, hd);
    float total[4] = {0.f, 0.f, 0.f, 0.f};
    for (int s = 0; s < splits; ++s) {
      int k0, k1;
      gemv_range(d, splits, s, k0, k1);
      const int rounds = (k1 - k0 + GemvShape<CB>::kRound - 1) / GemvShape<CB>::kRound;
      GemvWarp<CB, true> wr{w_packed, kp, wvec, k0 / (8 / CB), rounds, lane, n0, 0, n0 + 16, 1};
      wr.prime();
      float acc[4];
      wr.run(xs + (size_t)s * 3 * piece, piece, 1, [&](int, const float (&a)[4]) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[e] = a[e];
      });
#pragma unroll
      for (int e = 0; e < 4; ++e) total[e] = gemv_fold(total[e], acc[e]);
    }
    if ((lane & 3) == 0) {   // column 0 of the C fragment: rows g8 and g8 + 8
      proj[t * kGemvTileRows + g8] = __fmul_rn(total[0], w_scale[n0 + g8]);
      proj[t * kGemvTileRows + g8 + 8] = __fmul_rn(total[2], w_scale[n0 + g8 + 8]);
    }
  }
  __syncthreads();

  // 2. rotate the g query rows and the K row (half-split, as apply_rope)
  const int half = hd / 2;
  const float* cs = cos_t + (size_t)b * half;
  const float* sn = sin_t + (size_t)b * half;
  for (int i = threadIdx.x; i < (g + 1) * half; i += blockDim.x) {
    const int row = i / half, c = i - row * half;
    float* pr = proj + (size_t)row * hd;
    const float x1 = pr[c], x2 = pr[c + half], cv = cs[c], sv = sn[c];
    pr[c] = __fsub_rn(__fmul_rn(x1, cv), __fmul_rn(x2, sv));
    pr[c + half] = __fadd_rn(__fmul_rn(x2, cv), __fmul_rn(x1, sv));
  }
  __syncthreads();

  // 3. requantize the touched blocks in place, then attend (quant_kv.cuh)
  const float* krow = proj + (size_t)g * hd;
  const float* vrow = krow + hd;
  float ksc, vsc;
  requantize_kv(kp_ + (size_t)bidx * block * hdp_k, ks + bidx, krow, sm.kblk, k_bits,
                vp_ + (size_t)bidx * block * hdp_v, vs + bidx, vrow, sm.vblk, v_bits, hd, block,
                off, sm.red, ksc, vsc);
  const DenseRows krows{reinterpret_cast<const uint32_t*>(kp_), ks, hdp_k / 4, block};
  const DenseRows vrows{reinterpret_cast<const uint32_t*>(vp_), vs, hdp_v / 4, block};
  attend(static_cast<const float*>(proj), mask + (size_t)b * S, krows, vrows, sm, ksc, vsc,
         bidx, o, g, S, hd, block, lk, lv, 0, 1);  // walk: one CTA folds every chunk
}

template <int CB>
cudaError_t launch_proj(const void* pos, const void* x, const void* w_packed,
                        const void* w_scale, const void* cos_t, const void* sin_t,
                        void* k_packed, void* k_scale, void* v_packed, void* v_scale,
                        const void* mask, void* out, int B, int d, int n_heads, int n_kv,
                        int S, int hd, int block, int w_bits, int k_bits, int v_bits,
                        int splits, cudaStream_t stream) {
  const int kp = d / lanes_of(w_bits);
  const int g = n_heads / n_kv, hdp_k = hd / lanes_of(k_bits), hdp_v = hd / lanes_of(v_bits);
  const size_t smem = proj_xs_offset(g, hd, block, hdp_k, hdp_v) +
                      (size_t)splits * 3 * gemv_piece_bytes<CB>(1, gemv_max_rounds<CB>(d, splits));
  return launch_kv(quant_kv_decode_step_proj_kernel<CB>, dim3((unsigned)n_kv, (unsigned)B),
                   smem, stream, static_cast<const int*>(pos), static_cast<const float*>(x),
                   static_cast<const uint8_t*>(w_packed), static_cast<const float*>(w_scale),
                   static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
                   static_cast<int8_t*>(k_packed), static_cast<float*>(k_scale),
                   static_cast<int8_t*>(v_packed), static_cast<float*>(v_scale),
                   static_cast<const float*>(mask), static_cast<float*>(out), d, kp,
                   gemv_wvec(w_packed, kp), gemv_xvec(x, d), splits, n_heads, n_kv, S, hd,
                   block, k_bits, v_bits);
}

}  // namespace rq

// pos (B,) i32, B <= 8; x (B, d) f32 with d % lanes(w_bits) == 0; w_packed
// ((n_heads + 2 n_kv) hd, d / lanes) int8 and w_scale ((n_heads + 2 n_kv) hd)
// f32, the fused wqkv; cos / sin (B, hd / 2) f32; packed (B, n_kv, S, hdp)
// int8 and scales (B, n_kv, S/block) f32, updated in place; mask (B, S) f32
// additive; out (B, n_kv, g, hd) f32; splits the GEMV's K ranges for K = d
// (kernels/quant_gemv/kernel.py plan).  Activations are f32 only.
extern "C" int rq_quant_kv_decode_step_proj(const void* pos, const void* x, const void* w_packed,
                                            const void* w_scale, const void* cos_t,
                                            const void* sin_t, void* k_packed, void* k_scale,
                                            void* v_packed, void* v_scale, const void* mask,
                                            void* out, int B, int d, int n_heads, int n_kv,
                                            int S, int hd, int block, int w_bits, int k_bits,
                                            int v_bits, int splits, int dtype, void* stream) {
  if (dtype != rq::kF32 || B < 1 || B > rq::kProjMaxB || d < 1 || n_kv < 1 ||
      n_heads < n_kv || n_heads % n_kv || hd < 16 || hd % 16 || block < 1 || S % block ||
      rq::bad_kv_bits(w_bits) || d % rq::lanes_of(w_bits) || rq::bad_kv_bits(k_bits) ||
      rq::bad_kv_bits(v_bits) || rq::bad_gemv_split(d, splits) ||
      rq::bad_req_block(hd, block, rq::kKvThreads) || rq::misaligned(k_packed) ||
      rq::misaligned(v_packed))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rq::gemv_cb(w_bits)) {
    case 2: return (int)rq::launch_proj<2>(pos, x, w_packed, w_scale, cos_t, sin_t, k_packed,
                                           k_scale, v_packed, v_scale, mask, out, B, d, n_heads,
                                           n_kv, S, hd, block, w_bits, k_bits, v_bits, splits, s);
    case 4: return (int)rq::launch_proj<4>(pos, x, w_packed, w_scale, cos_t, sin_t, k_packed,
                                           k_scale, v_packed, v_scale, mask, out, B, d, n_heads,
                                           n_kv, S, hd, block, w_bits, k_bits, v_bits, splits, s);
    default: return (int)rq::launch_proj<8>(pos, x, w_packed, w_scale, cos_t, sin_t, k_packed,
                                            k_scale, v_packed, v_scale, mask, out, B, d, n_heads,
                                            n_kv, S, hd, block, w_bits, k_bits, v_bits, splits,
                                            s);
  }
}
