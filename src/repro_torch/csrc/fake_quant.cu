// Per-channel fake quantization (the QAT forward hot op) and its
// straight-through backward.
//
// Replaces the TPU kernel fake_quant_pallas (repro/kernels/fake_quant/
// kernel.py:30, pallas_call at :48) and the custom_vjp backward of
// repro/kernels/fake_quant/ops.py:28-45:
//   forward   out = clip(round(w / s), -q, q) * s              in w's dtype
//   backward  dw  = g * (|w| <= q * s)                          in g's dtype
// with q = 2^(bits-1) - 1 and s the per-channel scale, computed outside.
//
// Bound on the H100: bytes.  The forward reads w and writes a tensor of its
// size; the backward reads w and g and writes dw; the scales are a row or a
// column of floats.  A handful of flops per element.
//
// Design.
//  * Bit-exact with the plain version (and the JAX package): the division is
//    __fdiv_rn, the rounding rintf (half to even), the product __fmul_rn and
//    the cast __float2bfloat16_rn; this file is built without fast math.
//    The clip compares rather than calls fminf/fmaxf, so a NaN propagates as
//    in jnp.clip and torch.clamp.
//  * q is computed here from `bits` (a float taken by value, 32 while
//    pretraining) the way jnp.exp2 lowers: exp(f32(ln 2) * (bits - 1)), the
//    product rounded to f32 and the exponential taken in f64, then rounded.
//    At 32 bits that is 2^31 - 896, as in the reference, not 2^31.
//  * The backward recomputes the mask from w, so no mask the size of w is
//    kept between the passes; dw's sign of zero and the NaN of inf * 0 are
//    those of the reference's g * inside.
//  * Channel axis: `rowwise` 0 takes one scale per column of the (rows, cols)
//    storage (the scale of a (K, N) weight, or of the (V, d) embedding for
//    the lookup); `rowwise` 1 one scale per row, which fake-quantizes the tied
//    head's emb.T straight from the (V, d) storage without a transposed copy.
//  * A grid-stride loop over 16-byte vectors (4 f32 or 8 bf16 values, all in
//    one row) when the row length and the pointers allow, else one element a
//    thread; offsets are 64-bit (the head has 524 M elements).
#include <cstdint>
#include <initializer_list>

#include "common.cuh"

namespace rq {

constexpr int kFqThreads = 256;
constexpr int kFqMaxBlocks = 4096;

__device__ __forceinline__ float fq_qmax(float bits) {
  const float x = __fmul_rn(0.693147182f, __fsub_rn(bits, 1.0f));
  return __fsub_rn((float)exp((double)x), 1.0f);
}

__device__ __forceinline__ float fq_level(float w, float s, float q) {
  float lev = rintf(__fdiv_rn(w, s));
  lev = lev < -q ? -q : lev;   // jnp.clip: NaN passes through
  lev = lev > q ? q : lev;
  return __fmul_rn(lev, s);
}

template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = to_f(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = to_f(p[i]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) e[i] = from_f<T>(v[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = from_f<T>(v[i]);
  }
}

// The scales of the VEC values starting at element (row, col).
template <int VEC>
__device__ __forceinline__ void load_scales(const float* scale, int64_t row, int64_t col,
                                            int rowwise, float (&s)[VEC]) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) s[i] = rowwise ? scale[row] : scale[col + i];
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kFqThreads)
fake_quant_kernel(const T* __restrict__ w, const float* __restrict__ scale, T* __restrict__ out,
                  int64_t rows, int64_t cols, float bits, int rowwise) {
  const float q = fq_qmax(bits);
  const int64_t n_vec = rows * cols / VEC;
  for (int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; v < n_vec;
       v += (int64_t)gridDim.x * blockDim.x) {
    const int64_t e = v * VEC, row = e / cols, col = e - row * cols;
    float x[VEC], s[VEC];
    load_vec<T, VEC>(w + e, x);
    load_scales<VEC>(scale, row, col, rowwise, s);
#pragma unroll
    for (int i = 0; i < VEC; ++i) x[i] = fq_level(x[i], s[i], q);
    store_vec<T, VEC>(out + e, x);
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kFqThreads)
fake_quant_ste_bwd_kernel(const T* __restrict__ w, const float* __restrict__ scale,
                          const T* __restrict__ g, T* __restrict__ dw, int64_t rows,
                          int64_t cols, float bits, int rowwise) {
  const float q = fq_qmax(bits);
  const int64_t n_vec = rows * cols / VEC;
  for (int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; v < n_vec;
       v += (int64_t)gridDim.x * blockDim.x) {
    const int64_t e = v * VEC, row = e / cols, col = e - row * cols;
    float x[VEC], gv[VEC], s[VEC];
    load_vec<T, VEC>(w + e, x);
    load_vec<T, VEC>(g + e, gv);
    load_scales<VEC>(scale, row, col, rowwise, s);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float inside = fabsf(x[i]) <= __fmul_rn(q, s[i]) ? 1.0f : 0.0f;
      gv[i] = __fmul_rn(gv[i], inside);
    }
    store_vec<T, VEC>(dw + e, gv);
  }
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

inline int fq_blocks(int64_t n_vec) {
  const int64_t b = (n_vec + kFqThreads - 1) / kFqThreads;
  return (int)(b < kFqMaxBlocks ? b : kFqMaxBlocks);
}

// Vector width for this launch: 16 bytes when every row splits into whole
// vectors and every pointer is 16-byte aligned, else one element.
template <typename T>
inline bool use_vec(int64_t cols, int rowwise, std::initializer_list<const void*> ptrs,
                    const float* scale) {
  constexpr int VEC = 16 / sizeof(T);
  if (cols % VEC) return false;
  if (!rowwise && !aligned16(scale)) return false;
  for (const void* p : ptrs)
    if (!aligned16(p)) return false;
  return true;
}

template <typename T>
int launch_forward(const void* w, const float* scale, void* out, int64_t rows, int64_t cols,
                   float bits, int rowwise, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  const int64_t n = rows * cols;
  if (use_vec<T>(cols, rowwise, {w, out}, scale)) {
    fake_quant_kernel<T, VEC><<<fq_blocks(n / VEC), kFqThreads, 0, st>>>(
        static_cast<const T*>(w), scale, static_cast<T*>(out), rows, cols, bits, rowwise);
  } else {
    fake_quant_kernel<T, 1><<<fq_blocks(n), kFqThreads, 0, st>>>(
        static_cast<const T*>(w), scale, static_cast<T*>(out), rows, cols, bits, rowwise);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_backward(const void* w, const float* scale, const void* g, void* dw, int64_t rows,
                    int64_t cols, float bits, int rowwise, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  const int64_t n = rows * cols;
  if (use_vec<T>(cols, rowwise, {w, g, dw}, scale)) {
    fake_quant_ste_bwd_kernel<T, VEC><<<fq_blocks(n / VEC), kFqThreads, 0, st>>>(
        static_cast<const T*>(w), scale, static_cast<const T*>(g), static_cast<T*>(dw), rows,
        cols, bits, rowwise);
  } else {
    fake_quant_ste_bwd_kernel<T, 1><<<fq_blocks(n), kFqThreads, 0, st>>>(
        static_cast<const T*>(w), scale, static_cast<const T*>(g), static_cast<T*>(dw), rows,
        cols, bits, rowwise);
  }
  return (int)cudaGetLastError();
}

}  // namespace rq

extern "C" int rq_fake_quant(const void* w, const void* scale, void* out, long long rows,
                             long long cols, float bits, int rowwise, int dtype, void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  auto s = static_cast<const float*>(scale);
  return dtype == rq::kBF16
             ? rq::launch_forward<__nv_bfloat16>(w, s, out, rows, cols, bits, rowwise, st)
             : rq::launch_forward<float>(w, s, out, rows, cols, bits, rowwise, st);
}

extern "C" int rq_fake_quant_ste_bwd(const void* w, const void* scale, const void* g, void* dw,
                                     long long rows, long long cols, float bits, int rowwise,
                                     int dtype, void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  auto s = static_cast<const float*>(scale);
  return dtype == rq::kBF16
             ? rq::launch_backward<__nv_bfloat16>(w, s, g, dw, rows, cols, bits, rowwise, st)
             : rq::launch_backward<float>(w, s, g, dw, rows, cols, bits, rowwise, st);
}
