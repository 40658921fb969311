// K4, tensor-core variant: the weight-only INT8 feed-forward block on bf16
// mma.sync, y = gelu_tanh(x W_up) W_down, in two device launches.
//
// Replaces the TPU kernel gliclass/c_tpu/ops/fused_ffn.py::_kernel_wonly
// (reached through _fused_ffn_pallas and fused_ffn with act_quant off) for H
// and I multiples of 16; fused_ffn_wonly.cu keeps the other shapes.
//
//   h = bf16(gelu_tanh((x . W_up_q) * s_up + b_up))    launch 1, into [M, I] scratch
//   y = bf16((h . W_dn_q) * s_dn + b_dn)                launch 2
//
// with bf16 x, int8 weights widened exactly to bf16, fp32 sums: the plain
// version's arithmetic (ops/fused_ffn.py fused_ffn_wonly_plain) with the fp32
// sums in another order.
//
// What bounds it on the H100: 4*M*H*I operations against M*H*2*2 bytes of
// activations and 2*H*I bytes of weights. At gliclass-base's M = 8192, H =
// 768, I = 3072 that is 77 GFLOP, 0.078 ms at the bf16 tensor-core peak,
// against 30 MB: operations bound it. The CUDA-core K4 runs both products as
// fp32 FMAs (67 TFLOP/s at best) and re-reads and re-converts the 4.7 MB of
// weights in each 16-row block.
//
// What the design does about it: both products run the tensor-core core of
// K3′ (int8_mm_tc.cuh: 128-row tiles, a cp.async ring of bf16 x and int8
// weight, each weight tile widened once per 128 rows, mma.sync m16n8k16),
// the up product with scale, bias and gelu in its epilogue (the op order of
// fused_ffn_wonly.cu), the down product with scale and bias. Unlike the
// TPU kernel, the [M, I] bf16 intermediate goes through device memory: at M =
// 8192 it is 50 MB written and read once, about 0.03 ms at 3.35 TB/s, far
// less than what tensor cores save over a fused CUDA-core kernel whose 16-row
// blocks keep it in shared memory.

#include "int8_mm_tc.cuh"

// x: [M, H] bf16; wu: [H, I] int8; su, bu: [I] f32; wd: [I, H] int8; sd, bd:
// [H] f32; h: [M, I] bf16 scratch; out: [M, H] bf16. All contiguous; x, wu,
// wd, h and out 16-byte aligned; H and I multiples of 16.
extern "C" int gct_fused_ffn_wonly_tc(const void* x, const void* wu, const void* su, const void* bu,
                                      const void* wd, const void* sd, const void* bd, void* h, void* out, int M,
                                      int H, int I, void* stream) {
  if (H % 16 || I % 16 || !bu || !bd) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int rc = i8tc::launch<i8tc::Gelu>(x, wu, su, bu, h, M, I, H, st);
  if (rc != 0) return rc;
  return i8tc::launch<i8tc::Identity>(h, wd, sd, bd, out, M, H, I, st);
}
