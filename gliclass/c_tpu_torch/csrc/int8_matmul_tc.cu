// K3, tensor-core variant: INT8-weight matmul on bf16 mma.sync,
// y = (x . w_q) * scale[n] (+ b[n]) with bf16 x and out.
//
// Replaces the TPU kernel gliclass/c_tpu/ops/int8_matmul.py::_kernel (reached
// through _int8_matmul_pallas and int8_matmul) for bf16 x with K a multiple
// of 8 and N a multiple of 16; int8_matmul.cu keeps fp32 x (TF32 would round
// x and miss fp32's parity) and the other shapes.
//
// What bounds it on the H100: 2*M*N*K operations against M*K*2 + K*N + M*N*2
// bytes. At the encoder's shapes (M = 8192, K and N from 768 to 3072) that is
// 116 GFLOP over qkv, o, up and down, 0.117 ms at the bf16 tensor-core peak,
// against 0.05 GB: operations bound it, and the CUDA-core kernel (fp32 FMAs,
// 67 TFLOP/s at best) could not come within 15x of that.
//
// What the design does about it: the tensor-core core of int8_mm_tc.cuh
// (128 x 128 or 128 x 64 tiles, a four-stage cp.async ring of bf16 x and
// int8 weight, each weight tile widened once per block to bf16 by byte
// permutes, mma.sync m16n8k16 with fp32 sums) with the identity epilogue:
// the per-channel scale and the bias are applied to the fp32 accumulator (as
// int8_matmul.cu). A product of two bf16 values is exact in fp32, so only the
// order of the fp32 sums differs from the CUDA-core kernel and the plain
// version.
//
// wgmma and TMA are within reach of this layout: the widened tile is already
// a bf16 B operand in shared memory that a warpgroup could read (with a
// swizzled layout in place of the padding), and the x ring could be filled by
// TMA with an mbarrier per stage; the widening would then run in a producer
// warpgroup.

#include "int8_mm_tc.cuh"

// bf16 x [M, K] and out [M, N], w: [K, N] int8, scale: [N] f32, bias: [N] f32
// or null; all contiguous, x, w and out 16-byte aligned; K % 8 == 0,
// N % 16 == 0.
extern "C" int gct_int8_matmul_tc(const void* x, const void* w, const void* scale, const void* bias, void* out,
                                  int M, int N, int K, void* stream) {
  return i8tc::launch<i8tc::Identity>(x, w, scale, bias, out, M, N, K, (cudaStream_t)stream);
}
