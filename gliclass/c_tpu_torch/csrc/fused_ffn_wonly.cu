// K4: fused weight-only INT8 feed-forward block, y = gelu_tanh(x W_up) W_down.
//
// Replaces the TPU kernel gliclass/c_tpu/ops/fused_ffn.py::_kernel_wonly
// (reached through _fused_ffn_pallas and fused_ffn with act_quant off).
//
//   h = (x . W_up_q) * s_up + b_up       bf16 x, int8 weight upcast, fp32 sums
//   h = bf16(gelu_tanh(h))               the intermediate is rounded to x's type
//   y = (h . W_dn_q) * s_dn + b_dn       -> bf16
//
// What bounds it on the H100: 4*M*H*I operations (bf16 activations times
// int8 weights upcast) against M*H*2*2 bytes of activations plus 2*H*I bytes
// of weights; at M = B*S in the thousands it is bound by arithmetic. The
// composed form (two INT8-weight matmuls) also writes and re-reads the [M, I]
// intermediate, which this kernel removes.
//
// What the design does about it: K2's structure without the activation
// quantization. One block owns 16 rows: it stages them in shared memory as
// fp32, runs the up product, applies scale, bias and gelu, rounds the
// activated row to bf16 and keeps the [16, I] intermediate in dynamic shared
// memory (96 KB at I = 3072; with x's 48 KB the block takes 144 KB, so 32
// rows would not fit under the 227 KB a block may use). The down product
// reads it from there. Each thread owns four output columns: it reads four
// rows of four weight bytes as words (coalesced across the warp), upcasts
// them, and does 256 FMAs per 16-byte broadcast load of x. The product of a
// bf16 value and an int8 value is exact in fp32, so only the sums round.
// This first version runs on CUDA cores; tensor cores (mma/wgmma with the
// weight converted to bf16 in shared memory) are the next step. Epilogue
// arithmetic uses explicit round-to-nearest operations so that no
// multiply-add is contracted, matching the plain version's operation order.

#include "common.cuh"

namespace {

using namespace gct;

constexpr int BM = 16;
constexpr int THREADS = 256;

__device__ __forceinline__ void unpack4(uint32_t w, float f[4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) f[c] = (float)(int8_t)(w >> (8 * c));
}

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits16) {
  return __uint_as_float(bits16 << 16);
}

// acc[r][c] += sum_k A(r, k) * W[k][n0 + c] for r < 16, c < 4, k < K, with
// W int8 [K, N] row-major in device memory and A read by load4(r, k) as four
// consecutive values k..k+3.
template <typename Load4>
__device__ __forceinline__ void gemm16x4(Load4 load4, const int8_t* __restrict__ W, int N,
                                         int K, int n0, float acc[BM][4]) {
  const int8_t* wp = W + n0;
#pragma unroll 1
  for (int k = 0; k < K; k += 4) {
    float w[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u) unpack4(__ldg((const uint32_t*)(wp + (size_t)(k + u) * N)), w[u]);
#pragma unroll
    for (int r = 0; r < BM; ++r) {
      float a[4];
      load4(r, k, a);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[u], w[u][c], acc[r][c]);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
ffn_wonly_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ wu,
                 const float* __restrict__ su, const float* __restrict__ bu,
                 const int8_t* __restrict__ wd, const float* __restrict__ sd,
                 const float* __restrict__ bd, __nv_bfloat16* __restrict__ out, int M,
                 int H, int I) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = (float*)smem;                           // [BM][H] fp32
  __nv_bfloat16* hs = (__nv_bfloat16*)(xs + BM * H);  // [BM][I] bf16

  const int row0 = blockIdx.x * BM;
  const int tid = threadIdx.x;

  // 1. Stage the rows (rows past M are zero).
  for (int e = tid; e < BM * H; e += THREADS) {
    const int r = e / H, c = e - r * H, g = row0 + r;
    xs[e] = g < M ? to_float(x[(size_t)g * H + c]) : 0.f;
  }
  __syncthreads();

  // 2. Up product, scale, bias, gelu, rounded to bf16 into the intermediate.
  auto load_x = [&](int r, int k, float a[4]) {
    const float4 v = *reinterpret_cast<const float4*>(xs + r * H + k);
    a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w;
  };
  for (int n0 = tid * 4; n0 < I; n0 += THREADS * 4) {
    float acc[BM][4];
#pragma unroll
    for (int r = 0; r < BM; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
    gemm16x4(load_x, wu, I, H, n0, acc);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float sc = su[n0 + c], bias = bu[n0 + c];
#pragma unroll
      for (int r = 0; r < BM; ++r)
        hs[r * I + n0 + c] = __float2bfloat16_rn(gelu_tanh(__fadd_rn(__fmul_rn(acc[r][c], sc), bias)));
    }
  }
  __syncthreads();

  // 3. Down product and epilogue.
  auto load_h = [&](int r, int k, float a[4]) {
    const uint2 v = *reinterpret_cast<const uint2*>(hs + r * I + k);
    a[0] = bf16_bits_to_float(v.x & 0xffffu);
    a[1] = bf16_bits_to_float(v.x >> 16);
    a[2] = bf16_bits_to_float(v.y & 0xffffu);
    a[3] = bf16_bits_to_float(v.y >> 16);
  };
  for (int n0 = tid * 4; n0 < H; n0 += THREADS * 4) {
    float acc[BM][4];
#pragma unroll
    for (int r = 0; r < BM; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
    gemm16x4(load_h, wd, H, I, n0, acc);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float sc = sd[n0 + c], bias = bd[n0 + c];
#pragma unroll
      for (int r = 0; r < BM; ++r) {
        const int g = row0 + r;
        if (g < M) out[(size_t)g * H + n0 + c] = __float2bfloat16_rn(__fadd_rn(__fmul_rn(acc[r][c], sc), bias));
      }
    }
  }
}

}  // namespace

// Shared memory the kernel needs for (H, I); the wrapper checks it against
// the device limit before launching.
extern "C" int gct_fused_ffn_wonly_smem(int H, int I) { return BM * H * 4 + BM * I * 2; }

// x: [M, H] bf16; wu: [H, I] int8; su, bu: [I] f32; wd: [I, H] int8;
// sd, bd: [H] f32; out: [M, H] bf16. H and I must be multiples of 4.
extern "C" int gct_fused_ffn_wonly(const void* x, const void* wu, const void* su,
                                   const void* bu, const void* wd, const void* sd,
                                   const void* bd, void* out, int M, int H, int I,
                                   void* stream) {
  if (H % 4 || I % 4) return (int)cudaErrorInvalidValue;
  const int smem = gct_fused_ffn_wonly_smem(H, I);
  cudaError_t attr = allow_smem(ffn_wonly_kernel, smem);
  if (attr != cudaSuccess) return (int)attr;
  ffn_wonly_kernel<<<(M + BM - 1) / BM, THREADS, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const int8_t*)wu, (const float*)su, (const float*)bu,
      (const int8_t*)wd, (const float*)sd, (const float*)bd, (__nv_bfloat16*)out, M, H, I);
  return (int)cudaGetLastError();
}
