// Shared helpers of the port's hand-written Hopper kernels (sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gct {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The 16 bytes at src (16-byte aligned: 4 floats or 8 bf16 values) as floats.
__device__ __forceinline__ void load16(const float* src, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x, out[2 * i + 1] = f.y;
  }
}

// Round a float to the storage type T and back (the "cast P to v's dtype"
// step of the reference kernels).
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// acc[a][b] += sum_k A[tr*4+a][k] * B[tc+16*b][k], k < KD, with A's rows LDA
// floats apart and B's ldb. Thread (tr, tc) of a 16 x 16 grid owns rows
// tr*4..tr*4+3 and columns tc, tc+16, ... (fp32 FMAs from shared memory).
template <int NB, int KD, int LDA>
__device__ __forceinline__ void mm_abt(const float* A, const float* B, int ldb,
                                       int tr, int tc, float acc[4][NB]) {
#pragma unroll 4
  for (int k = 0; k < KD; ++k) {
    float a[4], b[NB];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(tr * 4 + i) * LDA + k];
#pragma unroll
    for (int j = 0; j < NB; ++j) b[j] = B[(tc + 16 * j) * ldb + k];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NB; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// jax.nn.gelu(approximate=True): x * 0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 x^3))),
// in the JAX and plain versions' operation order (no contracted multiply-add).
__device__ __forceinline__ float gelu_tanh(float x) {
  const float x3 = __fmul_rn(__fmul_rn(x, x), x);
  const float inner = __fmul_rn(0.7978845608028654f, __fadd_rn(x, __fmul_rn(0.044715f, x3)));
  const float cdf = __fmul_rn(0.5f, __fadd_rn(1.0f, tanhf(inner)));
  return __fmul_rn(x, cdf);
}

// Opt a kernel into more than 48 KB of dynamic shared memory once per process.
template <typename K> inline cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace gct
