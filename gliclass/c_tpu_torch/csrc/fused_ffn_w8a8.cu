// K2: fused w8a8 feed-forward block, y = gelu_tanh(x W_up) W_down, in int8.
//
// Replaces the TPU kernel gliclass/c_tpu/ops/fused_ffn.py::_kernel_w8a8
// (reached through _fused_ffn_pallas and fused_ffn).
//
//   x_q, s_x = row_quant(x)                 per row: s = max|x|/127 (>= 1e-10),
//                                           q = round_half_even(x / s)
//   h = (x_q W_up_q) * s_x * s_up + b_up    int32 accumulate, fp32 epilogue
//   h = gelu_tanh(h)                        fp32
//   h_q, s_h = row_quant(h)
//   y = (h_q W_dn_q) * s_h * s_dn + b_dn    -> bf16
//
// What bounds it on the H100: 4*M*H*I int8 operations against M*H*2*2 bytes
// of activations plus 2*H*I bytes of weights; at M = B*S in the thousands it
// is bound by arithmetic. The composed form also writes and re-reads the
// [M, I] intermediate (4x the activation bytes), which this kernel removes.
//
// What the design does about it: one block owns 16 rows. It quantizes them
// into shared memory, runs the up product, applies scale, bias and gelu, and
// keeps the fp32 [16, I] intermediate in shared memory (192 KB at I = 3072,
// under the 227 KB a block may use). The row absmax needs the whole row, so
// the re-quantization runs after the up product, in place: each chunk of
// fp32 values is read into registers before its int8 bytes are written over
// the front of the same buffer. The down product then reads int8 rows from
// shared memory. The int8 dot products are __dp4a on CUDA cores: each thread
// owns four output columns, reads four rows of four weight bytes as words
// (coalesced across the warp) and transposes them with byte permutes. Moving
// the products to int8 tensor cores (mma.sync s8.s8.s32 / wgmma) is the next
// step. Epilogue arithmetic uses explicit round-to-nearest operations so that
// no multiply-add is contracted, matching the reference's operation order.

#include "common.cuh"

namespace {

using namespace gct;

constexpr int BM = 16;
constexpr int THREADS = 256;
constexpr int QCHUNK = 16;  // values per thread per in-place re-quantization step

__device__ __forceinline__ void transpose4x4(uint32_t r0, uint32_t r1, uint32_t r2,
                                             uint32_t r3, uint32_t col[4]) {
  // r_k holds the bytes of columns 0..3 of row k; col[c] gets rows 0..3 of column c.
  const uint32_t t0 = __byte_perm(r0, r1, 0x5140);
  const uint32_t t1 = __byte_perm(r0, r1, 0x7362);
  const uint32_t t2 = __byte_perm(r2, r3, 0x5140);
  const uint32_t t3 = __byte_perm(r2, r3, 0x7362);
  col[0] = __byte_perm(t0, t2, 0x5410);
  col[1] = __byte_perm(t0, t2, 0x7632);
  col[2] = __byte_perm(t1, t3, 0x5410);
  col[3] = __byte_perm(t1, t3, 0x7632);
}

// acc[r][c] += sum_k A[r][k] * W[k][n0 + c] for r < 16, c < 4. A: int8 rows in
// shared memory with stride lda; W: int8 [K, N] row-major in device memory.
__device__ __forceinline__ void gemm16x4(const int8_t* A, int lda, const int8_t* __restrict__ W,
                                         int N, int K, int n0, int acc[BM][4]) {
  const int8_t* wp = W + n0;
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    const uint32_t r0 = __ldg((const uint32_t*)(wp + (size_t)k * N));
    const uint32_t r1 = __ldg((const uint32_t*)(wp + (size_t)(k + 1) * N));
    const uint32_t r2 = __ldg((const uint32_t*)(wp + (size_t)(k + 2) * N));
    const uint32_t r3 = __ldg((const uint32_t*)(wp + (size_t)(k + 3) * N));
    uint32_t col[4];
    transpose4x4(r0, r1, r2, r3, col);
#pragma unroll
    for (int r = 0; r < BM; ++r) {
      const int a = *(const int*)(A + r * lda + k);
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = __dp4a(a, (int)col[c], acc[r][c]);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
ffn_w8a8_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ wu,
                const float* __restrict__ su, const float* __restrict__ bu,
                const int8_t* __restrict__ wd, const float* __restrict__ sd,
                const float* __restrict__ bd, __nv_bfloat16* __restrict__ out, int M,
                int H, int I) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* xq = (int8_t*)smem;             // [BM][H] int8
  float* hs = (float*)(smem + BM * H);    // [BM][I] fp32, later [BM][I] int8 in place
  int8_t* hq = (int8_t*)hs;
  __shared__ float s_x[BM], s_h[BM];

  const int row0 = blockIdx.x * BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // 1. Per-row quantization of x (rows past M are zero, s = 1e-10, q = 0).
  for (int r = warp; r < BM; r += THREADS / 32) {
    const int g = row0 + r;
    float mx = 0.f;
    if (g < M)
      for (int c = lane; c < H; c += 32) mx = fmaxf(mx, fabsf(to_float(x[(size_t)g * H + c])));
    const float s = fmaxf(__fdiv_rn(warp_max(mx), 127.0f), 1e-10f);
    for (int c = lane; c < H; c += 32) {
      const float val = g < M ? to_float(x[(size_t)g * H + c]) : 0.f;
      xq[r * H + c] = (int8_t)__float2int_rn(__fdiv_rn(val, s));
    }
    if (lane == 0) s_x[r] = s;
  }
  __syncthreads();

  // 2. Up product, scale, bias and gelu into the fp32 intermediate.
  for (int n0 = tid * 4; n0 < I; n0 += THREADS * 4) {
    int acc[BM][4];
#pragma unroll
    for (int r = 0; r < BM; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0;
    gemm16x4(xq, H, wu, I, H, n0, acc);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float sc = su[n0 + c], bias = bu[n0 + c];
#pragma unroll
      for (int r = 0; r < BM; ++r) {
        const float hv = __fadd_rn(__fmul_rn(__fmul_rn((float)acc[r][c], s_x[r]), sc), bias);
        hs[r * I + n0 + c] = gelu_tanh(hv);
      }
    }
  }
  __syncthreads();

  // 3. Row absmax of the activated intermediate.
  for (int r = warp; r < BM; r += THREADS / 32) {
    float mx = 0.f;
    for (int c = lane; c < I; c += 32) mx = fmaxf(mx, fabsf(hs[r * I + c]));
    const float s = fmaxf(__fdiv_rn(warp_max(mx), 127.0f), 1e-10f);
    if (lane == 0) s_h[r] = s;
  }
  __syncthreads();

  // 4. Re-quantize in place. Chunk [base, base + CH) of fp32 values is read
  // into registers before its int8 bytes land on bytes [base, base + CH),
  // which only overlap fp32 values of this or earlier chunks.
  const int total = BM * I;
  for (int base = 0; base < total; base += THREADS * QCHUNK) {
    int8_t vq[QCHUNK];
#pragma unroll
    for (int u = 0; u < QCHUNK; ++u) {
      const int idx = base + u * THREADS + tid;
      vq[u] = idx < total ? (int8_t)__float2int_rn(__fdiv_rn(hs[idx], s_h[idx / I])) : 0;
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < QCHUNK; ++u) {
      const int idx = base + u * THREADS + tid;
      if (idx < total) hq[idx] = vq[u];
    }
    __syncthreads();
  }

  // 5. Down product and epilogue.
  for (int n0 = tid * 4; n0 < H; n0 += THREADS * 4) {
    int acc[BM][4];
#pragma unroll
    for (int r = 0; r < BM; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0;
    gemm16x4(hq, I, wd, H, I, n0, acc);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float sc = sd[n0 + c], bias = bd[n0 + c];
#pragma unroll
      for (int r = 0; r < BM; ++r) {
        const int g = row0 + r;
        if (g < M) {
          const float y = __fadd_rn(__fmul_rn(__fmul_rn((float)acc[r][c], s_h[r]), sc), bias);
          out[(size_t)g * H + n0 + c] = __float2bfloat16_rn(y);
        }
      }
    }
  }
}

}  // namespace

// Shared memory the kernel needs for (H, I); the wrapper checks it against
// the device limit before launching.
extern "C" int gct_fused_ffn_w8a8_smem(int H, int I) { return BM * H + BM * I * 4; }

// x: [M, H] bf16; wu: [H, I] int8; su, bu: [I] f32; wd: [I, H] int8;
// sd, bd: [H] f32; out: [M, H] bf16. H and I must be multiples of 4.
extern "C" int gct_fused_ffn_w8a8(const void* x, const void* wu, const void* su,
                                  const void* bu, const void* wd, const void* sd,
                                  const void* bd, void* out, int M, int H, int I,
                                  void* stream) {
  if (H % 4 || I % 4) return (int)cudaErrorInvalidValue;
  const int smem = gct_fused_ffn_w8a8_smem(H, I);
  cudaError_t attr = allow_smem(ffn_w8a8_kernel, smem);
  if (attr != cudaSuccess) return (int)attr;
  ffn_w8a8_kernel<<<(M + BM - 1) / BM, THREADS, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const int8_t*)wu, (const float*)su, (const float*)bu,
      (const int8_t*)wd, (const float*)sd, (const float*)bd, (__nv_bfloat16*)out, M, H, I);
  return (int)cudaGetLastError();
}
