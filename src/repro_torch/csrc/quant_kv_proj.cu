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
// Design.  One thread-block cluster per (slot, kv head), over (csize, n_kv,
// B) as rows 3 and 7 launch (launch_kv_split); kernels/quant_kv/kernel.py's
// attend_plan gives csize by row 3's rule (gemma-2b at S 512: clusters of 8,
// at 1024: of 16; csize 1 is one CTA doing all of it, "walk").
//  * Projection spread over the cluster: the block's g * hd + 2 * hd rows
//    (q group h at row h * g * hd of wqkv, K head h at (n_heads + h) * hd, V
//    head h at (n_heads + n_kv + h) * hd, as the Pallas BlockSpecs slice
//    wqkv; hd % 16 == 0, so a 16-row tile never straddles two) are T tiles,
//    and rank r projects tiles [r T / csize, (r + 1) T / csize)
//    (kernel.py proj_tiles), so a cluster reads wqkv once a slot, as one CTA
//    did.  Each rank stages the slot's x row as the GEMV stages it (three
//    bf16 pieces, every K range), and each warp streams its tiles range by
//    range through quant_gemv.cuh's GemvWarp, folding each range's partial
//    into the channel's sum from zero in range order and multiplying by the
//    channel's scale after the last: only the rows move from one CTA to
//    another, so every projected value is the GEMV kernel's value for that
//    row and channel, bit for bit, and the whole step equals the GEMV ->
//    rotary -> decode-step composition bit for bit.  The rows land in the
//    rank's own copy of the (g + 2) * hd buffer (10 KB at gemma-2b's heads).
//  * Exchange through distributed shared memory: a cluster barrier after
//    the projection, then each rank reads the rows it lacks from their
//    owners: all g * hd query rows (the attention needs them), and the K and
//    V rows too on the rank whose chunks hold pos.  It then arrives at a
//    second cluster barrier and waits on it only before it overwrites its
//    own rows (the rotation of q, in place) and so before it can leave; in
//    between, the holder rotates its K row into a buffer of its own and
//    requantizes, which hides the barrier's latency.
//  * Rotary: cos / sin come from the caller, computed in torch from the
//    same angle tensor the unfused path builds; channel c pairs with c +
//    hd/2, which may have been projected on another rank, so the rotation
//    runs after the exchange, written with __fmul_rn / __fsub_rn / __fadd_rn
//    so that nvcc does not contract x1 * cos - x2 * sin into an FMA (torch
//    rounds each product).
//  * Then quant_kv.cuh as row 3 runs it: the holder's requantize_kv (K and
//    V, written into the cache in place, a copy kept for its attention), and
//    attend on every rank, split over S, the query rows read from shared
//    memory.  A position outside [0, S) writes nothing and attends to
//    nothing, as the plain step does.
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

// GemvWarp's tile map for a warp's share of a rank's tiles: tile t at
// projected row row0 + t * tile_stride, read from its wqkv row.
struct ProjTiles {
  int h, n_heads, n_kv, g, hd;
  __device__ __forceinline__ int operator()(int row0, int tile_stride, int t) const {
    return proj_row(row0 + t * tile_stride, h, n_heads, n_kv, g, hd);
  }
};

// Shared memory: the projection ((g + 2) * hd floats), the rotated K row (hd),
// quant_kv.cuh's attention and requantization room, then the x staging
// (16-byte aligned).
inline __host__ __device__ size_t proj_xs_offset(int g, int hd, int block, int hdp_k, int hdp_v) {
  return round16((size_t)(g + 3) * hd * sizeof(float) +
                 kv_smem_bytes(g, hd, block, hdp_k, hdp_v));
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
  const int rank = blockIdx.x, csize = gridDim.x;
  const int h = blockIdx.y, b = blockIdx.z, bh = b * n_kv + h;
  const int g = n_heads / n_kv;
  const int nb = S / block;
  const int lk = lanes_of(k_bits), lv = lanes_of(v_bits);
  const int hdp_k = hd / lk, hdp_v = hd / lv;
  const int rows = (g + 2) * hd, T = rows / kGemvTileRows;
  float* proj = smem;                                   // q group, then K, then V
  float* krot = smem + rows;                            // the rotated K row
  const KvSmem sm = carve_kv_smem(krot + hd, g, hd, block, hdp_k);

  uint8_t* kp_ = reinterpret_cast<uint8_t*>(k_packed) + (size_t)bh * S * hdp_k;
  uint8_t* vp_ = reinterpret_cast<uint8_t*>(v_packed) + (size_t)bh * S * hdp_v;
  float* ks = k_scale + (size_t)bh * nb;
  float* vs = v_scale + (size_t)bh * nb;
  float* o = out + (size_t)bh * g * hd;
  const int p = pos[b];
  if (p < 0 || p >= S) {  // no block to write: leave the cache alone, attend to nothing
    zero_slice(o, g * hd, rank, csize);
    return;
  }

  // 1. project this rank's tiles: warp w takes the rank's tiles w, w + 8, ...
  // and streams them through each K range in turn (the first range's weights
  // asked for before x is staged), folding the ranges from zero in order
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g8 = lane >> 2;
  const int t0 = rank * T / csize, t1 = (rank + 1) * T / csize;
  const int ntiles = t1 - t0 > warp ? (t1 - t0 - warp + kWarps - 1) / kWarps : 0;
  const int row0 = (t0 + warp) * kGemvTileRows, stride = kWarps * kGemvTileRows;
  const ProjTiles map{h, n_heads, n_kv, g, hd};
  const int n_w = (n_heads + 2 * n_kv) * hd;
  auto range_warp = [&](int s) {
    int k0, k1;
    gemv_range(d, splits, s, k0, k1);
    const int rounds = (k1 - k0 + GemvShape<CB>::kRound - 1) / GemvShape<CB>::kRound;
    return GemvWarp<CB, true, ProjTiles>{w_packed, kp, wvec, k0 / (8 / CB), rounds, lane,
                                          row0, stride, n_w, ntiles, map};
  };
  auto wr = range_warp(0);
  wr.prime();
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
  for (int s = 0; s < splits; ++s) {
    if (s) {
      wr = range_warp(s);
      wr.prime();
    }
    const bool last = s == splits - 1;
    wr.run(xs + (size_t)s * 3 * piece, piece, 1, [&](int t, const float (&acc)[4]) {
      if (lane & 3) return;    // column 0 of the C fragment (x's one row): rows g8, g8 + 8
      const int r = row0 + t * stride + g8, n = map(row0, stride, t) + g8;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float total = gemv_fold(s ? proj[r + 8 * e] : 0.f, acc[2 * e]);
        if (last) total = __fmul_rn(total, w_scale[n + 8 * e]);
        proj[r + 8 * e] = total;
      }
    });
  }

  // 2. exchange: the query rows from their owners, and the K and V rows on
  // the rank that holds pos; then arrive (this rank reads no other's rows
  // any more) and wait only before the rows are overwritten
  const bool holder = holds_position(p, rank, csize);   // csize 1: always
  cg::cluster_group cluster = cg::this_cluster();
  if (csize > 1) {
    cluster.sync();                                     // every rank's rows are written
    const int need = (holder ? rows : g * hd) / 4;
    for (int i = threadIdx.x; i < need; i += blockDim.x) {
      const int owner = ((i * 4 / kGemvTileRows + 1) * csize - 1) / T;
      if (owner != rank)
        reinterpret_cast<float4*>(proj)[i] =
            reinterpret_cast<const float4*>(cluster.map_shared_rank(proj, owner))[i];
    }
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  }
  __syncthreads();

  // 3. the holder rotates its K row (half-split, as apply_rope) and
  // requantizes the touched blocks in place (quant_kv.cuh)
  const int half = hd / 2;
  const float* cs = cos_t + (size_t)b * half;
  const float* sn = sin_t + (size_t)b * half;
  int bidx = -1;  // sequence block read from shared memory; -1 = none
  float ksc = 0.f, vsc = 0.f;
  if (holder) {  // block-uniform
    const float* kr = proj + (size_t)g * hd;
    for (int c = threadIdx.x; c < half; c += blockDim.x) {
      const float x1 = kr[c], x2 = kr[c + half], cv = cs[c], sv = sn[c];
      krot[c] = __fsub_rn(__fmul_rn(x1, cv), __fmul_rn(x2, sv));
      krot[c + half] = __fadd_rn(__fmul_rn(x2, cv), __fmul_rn(x1, sv));
    }
    __syncthreads();
    bidx = p / block;
    requantize_kv(kp_ + (size_t)bidx * block * hdp_k, ks + bidx, static_cast<const float*>(krot),
                  sm.kblk, k_bits, vp_ + (size_t)bidx * block * hdp_v, vs + bidx,
                  static_cast<const float*>(kr + hd), sm.vblk, v_bits, hd, block, p % block,
                  sm.red, ksc, vsc);
  }

  // 4. every rank has read what it needs of the others' rows: rotate the g
  // query rows in place, then attend, split over S as row 3
  if (csize > 1) asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
  for (int i = threadIdx.x; i < g * half; i += blockDim.x) {
    const int row = i / half, c = i - row * half;
    float* pr = proj + (size_t)row * hd;
    const float x1 = pr[c], x2 = pr[c + half], cv = cs[c], sv = sn[c];
    pr[c] = __fsub_rn(__fmul_rn(x1, cv), __fmul_rn(x2, sv));
    pr[c + half] = __fadd_rn(__fmul_rn(x2, cv), __fmul_rn(x1, sv));
  }
  __syncthreads();
  const DenseRows krows{reinterpret_cast<const uint32_t*>(kp_), ks, hdp_k / 4, block};
  const DenseRows vrows{reinterpret_cast<const uint32_t*>(vp_), vs, hdp_v / 4, block};
  attend(static_cast<const float*>(proj), mask + (size_t)b * S, krows, vrows, sm, ksc, vsc,
         bidx, o, g, S, hd, block, lk, lv, rank, csize);
}

template <int CB>
cudaError_t launch_proj(const void* pos, const void* x, const void* w_packed,
                        const void* w_scale, const void* cos_t, const void* sin_t,
                        void* k_packed, void* k_scale, void* v_packed, void* v_scale,
                        const void* mask, void* out, int B, int d, int n_heads, int n_kv,
                        int S, int hd, int block, int w_bits, int k_bits, int v_bits,
                        int splits, int csize, cudaStream_t stream) {
  const int kp = d / lanes_of(w_bits);
  const int g = n_heads / n_kv, hdp_k = hd / lanes_of(k_bits), hdp_v = hd / lanes_of(v_bits);
  const size_t smem = proj_xs_offset(g, hd, block, hdp_k, hdp_v) +
                      (size_t)splits * 3 * gemv_piece_bytes<CB>(1, gemv_max_rounds<CB>(d, splits));
  return launch_kv_split(quant_kv_decode_step_proj_kernel<CB>, csize, n_kv, B, smem, stream,
                         static_cast<const int*>(pos), static_cast<const float*>(x),
                         static_cast<const uint8_t*>(w_packed),
                         static_cast<const float*>(w_scale), static_cast<const float*>(cos_t),
                         static_cast<const float*>(sin_t), static_cast<int8_t*>(k_packed),
                         static_cast<float*>(k_scale), static_cast<int8_t*>(v_packed),
                         static_cast<float*>(v_scale), static_cast<const float*>(mask),
                         static_cast<float*>(out), d, kp, gemv_wvec(w_packed, kp),
                         gemv_xvec(x, d), splits, n_heads, n_kv, S, hd, block, k_bits, v_bits);
}

}  // namespace rq

// pos (B,) i32, B <= 8; x (B, d) f32 with d % lanes(w_bits) == 0; w_packed
// ((n_heads + 2 n_kv) hd, d / lanes) int8 and w_scale ((n_heads + 2 n_kv) hd)
// f32, the fused wqkv; cos / sin (B, hd / 2) f32; packed (B, n_kv, S, hdp)
// int8 and scales (B, n_kv, S/block) f32, updated in place; mask (B, S) f32
// additive; out (B, n_kv, g, hd) f32; splits the GEMV's K ranges for K = d
// (kernels/quant_gemv/kernel.py plan); csize the CTAs a (slot, kv head)
// takes (1: one CTA projects, requantizes and walks every chunk).
// Activations are f32 only.
extern "C" int rq_quant_kv_decode_step_proj(const void* pos, const void* x, const void* w_packed,
                                            const void* w_scale, const void* cos_t,
                                            const void* sin_t, void* k_packed, void* k_scale,
                                            void* v_packed, void* v_scale, const void* mask,
                                            void* out, int B, int d, int n_heads, int n_kv,
                                            int S, int hd, int block, int w_bits, int k_bits,
                                            int v_bits, int splits, int csize, int dtype,
                                            void* stream) {
  if (dtype != rq::kF32 || B < 1 || B > rq::kProjMaxB || d < 1 || n_kv < 1 ||
      n_heads < n_kv || n_heads % n_kv || hd < 16 || hd % 16 || block < 1 || S % block ||
      rq::bad_kv_bits(w_bits) || d % rq::lanes_of(w_bits) || rq::bad_kv_bits(k_bits) ||
      rq::bad_kv_bits(v_bits) || rq::bad_gemv_split(d, splits) ||
      rq::bad_split(csize, S, block, true) || rq::bad_req_block(hd, block, rq::kKvThreads) ||
      rq::misaligned(k_packed) || rq::misaligned(v_packed))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rq::gemv_cb(w_bits)) {
    case 2: return (int)rq::launch_proj<2>(pos, x, w_packed, w_scale, cos_t, sin_t, k_packed,
                                           k_scale, v_packed, v_scale, mask, out, B, d, n_heads,
                                           n_kv, S, hd, block, w_bits, k_bits, v_bits, splits,
                                           csize, s);
    case 4: return (int)rq::launch_proj<4>(pos, x, w_packed, w_scale, cos_t, sin_t, k_packed,
                                           k_scale, v_packed, v_scale, mask, out, B, d, n_heads,
                                           n_kv, S, hd, block, w_bits, k_bits, v_bits, splits,
                                           csize, s);
    default: return (int)rq::launch_proj<8>(pos, x, w_packed, w_scale, cos_t, sin_t, k_packed,
                                            k_scale, v_packed, v_scale, mask, out, B, d, n_heads,
                                            n_kv, S, hd, block, w_bits, k_bits, v_bits, splits,
                                            csize, s);
  }
}
