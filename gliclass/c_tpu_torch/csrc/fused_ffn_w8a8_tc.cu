// K2, tensor-core variant: the fused w8a8 feed-forward block on s8 mma.sync,
// y = gelu_tanh(x W_up) W_down with per-row int8 activations, in four device
// launches.
//
// Replaces the TPU kernel gliclass/c_tpu/ops/fused_ffn.py::_kernel_w8a8
// (reached through _fused_ffn_pallas and fused_ffn with act_quant on) for H
// and I multiples of 16; fused_ffn_w8a8.cu keeps the other widths.
//
//   x_q, s_x = row_quant(x)                                  launch 1 (int8 [M, H], f32 [M])
//   h = gelu_tanh(((acc(x_q, W_up) * s_x) * s_up) + b_up)    launch 2 (f32 [M, I], and max|h| a row)
//   h_q, s_h = row_quant(h)                                  launch 3 (int8 [M, I], f32 [M])
//   y = bf16(((acc(h_q, W_dn) * s_h) * s_dn) + b_dn)         launch 4
//
// with exact int32 sums and the CUDA-core K2's fp32 operations in the same
// order (int8_gemm_s8.cuh): the result equals fused_ffn_w8a8.cu's bit for bit.
//
// What bounds it on the H100: 4*M*H*I int8 operations, at gliclass-base's M =
// 8192, H = 768, I = 3072 77.3 GOP, 0.039 ms at the int8 tensor-core peak,
// against 30 MB of activations and weights. The CUDA-core K2 ran both products
// as __dp4a (about 60 TOP/s), and each of its 16-row blocks read both 2.36 MB
// weights from L2 again.
//
// What the design does about it: both products run one s8 tensor-core core
// (128-row tiles, so each weight tile serves 128 rows; a three-stage cp.async
// ring of int8 tiles; mma.sync m16n8k32) on weights given as [N, K] copies,
// k innermost. Unlike the TPU kernel and the CUDA-core K2, the fp32 [M, I]
// intermediate and its int8 copy go through device memory (the row absmax
// needs the whole row, which no output tile holds): at M = 8192 100 MB and 25
// MB, each written and read once, about 0.075 ms at 3.35 TB/s, more than the
// products' bound. The up product folds each row's max |h| into s_h's buffer
// (zeroed by launch 1), so launch 3 reads h once, not twice (reading it
// twice took 0.079 ms of device time at M = 8192 on the H100,
// scripts/k1_k2_times.py).

#include "int8_gemm_s8.cuh"

// x: [M, H] bf16; wtu: [I, H] int8 (W_up as [N, K]); su, bu: [I] f32; wtd:
// [H, I] int8; sd, bd: [H] f32; scratch xq: [M, H] int8, sx: [M] f32, h: [M,
// I] f32, hq: [M, I] int8, sh: [M] f32; out: [M, H] bf16. All contiguous; x,
// wtu, wtd, xq, h, hq and out 16-byte aligned; H and I multiples of 16.
extern "C" int gct_fused_ffn_w8a8_tc(const void* x, const void* wtu, const void* su, const void* bu, const void* wtd,
                                     const void* sd, const void* bd, void* xq, void* sx, void* h, void* hq, void* sh,
                                     void* out, int M, int H, int I, void* stream) {
  if (H % 16 || I % 16 || !bu || !bd) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int rc = s8mm::row_quant<__nv_bfloat16>(x, xq, sx, M, H, false, sh, st);
  if (rc == 0) rc = s8mm::launch<s8mm::Gelu, float>(xq, wtu, sx, su, bu, h, sh, M, I, H, st);
  if (rc == 0) rc = s8mm::row_quant<float>(h, hq, sh, M, I, true, nullptr, st);
  if (rc == 0) rc = s8mm::launch<s8mm::Identity, __nv_bfloat16>(hq, wtd, sh, sd, bd, out, nullptr, M, H, I, st);
  return rc;
}

// The same four launches split at s_h, for tensor parallelism (ops/fused_ffn.py
// fused_ffn_w8a8 with a model group): each rank holds I/tp columns of W_up and
// rows of W_down, and a row's int8 scale of h needs the absmax of the whole
// row, which no rank holds. The up half ends with each row's max |h| of this
// rank's columns in sh; the caller takes its maximum over the model group;
// the down half quantises h with it (the one-rank K2's h_q, bit for bit) and
// gives this rank's partial sums of y, which the caller sums over the group.
// Called in turn with the same arguments on one rank, the halves give
// gct_fused_ffn_w8a8_tc's bits.

// Launches 1-2: x_q, s_x = row_quant(x) (sh zeroed), h = gelu_tanh(...) with
// each row's max |h| folded into sh. Arguments as gct_fused_ffn_w8a8_tc's.
extern "C" int gct_fused_ffn_w8a8_tc_up(const void* x, const void* wtu, const void* su, const void* bu, void* xq,
                                        void* sx, void* h, void* sh, int M, int H, int I, void* stream) {
  if (H % 16 || I % 16 || !bu) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int rc = s8mm::row_quant<__nv_bfloat16>(x, xq, sx, M, H, false, sh, st);
  if (rc == 0) rc = s8mm::launch<s8mm::Gelu, float>(xq, wtu, sx, su, bu, h, sh, M, I, H, st);
  return rc;
}

// Launches 3-4: h_q, s_h = row_quant(h) with the rows' absmax read from sh
// (its scales written back there); out = ((acc(h_q, W_dn) * s_h) * s_dn)
// (+ bd where bd is not null), [M, H] bf16, or fp32 with out_f32 (the
// partial sums a rank adds up in fp32).
extern "C" int gct_fused_ffn_w8a8_tc_down(const void* h, const void* wtd, const void* sd, const void* bd, void* hq,
                                          void* sh, void* out, int out_f32, int M, int H, int I, void* stream) {
  if (H % 16 || I % 16) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int rc = s8mm::row_quant<float>(h, hq, sh, M, I, true, nullptr, st);
  if (rc != 0) return rc;
  if (out_f32) return s8mm::launch<s8mm::Identity, float>(hq, wtd, sh, sd, bd, out, nullptr, M, H, I, st);
  return s8mm::launch<s8mm::Identity, __nv_bfloat16>(hq, wtd, sh, sd, bd, out, nullptr, M, H, I, st);
}
