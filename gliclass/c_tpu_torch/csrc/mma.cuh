// Tensor-core building blocks of the port's Hopper kernels (sm_90a): warp-level
// bf16 and s8 mma.sync, ldmatrix, and cp.async 16-byte copies.
//
// m16n8k16 fragments (PTX ISA, "Matrix Fragments for mma.m16n8k16"), with
// g = lane / 4 and t = lane % 4:
//   A [16 x 16] row-major, four 32-bit registers of two bf16 each:
//     a[0] = A[g][2t..2t+1], a[1] = A[g+8][2t..2t+1],
//     a[2] = A[g][2t+8..2t+9], a[3] = A[g+8][2t+8..2t+9]
//   B [16 x 8] column-major, two registers: b[0] = B[2t..2t+1][g], b[1] = B[2t+8..2t+9][g]
//   C [16 x 8] fp32, four registers: c[i] = C[g + 8 * (i / 2)][2t + i % 2]
//     (row = lane/4 + 8*(i/2), column = 2*(lane%4) + i%2)
//
// ldmatrix.x4 loads four 8 x 8 b16 matrices; lanes 8m..8m+7 give the row
// addresses of matrix m, and register m of lane l holds row l/4, columns
// 2(l%4), 2(l%4)+1 of matrix m (with .trans: column l/4, rows 2(l%4), 2(l%4)+1).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace gct {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += A . B on one m16n8k16 tile, bf16 inputs, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += A . B on one m16n8k32 tile, s8 inputs, exact s32 accumulators. The
// fragments hold four s8 values a register where the bf16 ones hold two:
//   A [16 x 32]: a[0] = A[g][4t..4t+3], a[1] = A[g+8][4t..4t+3], a[2], a[3]
//     the same at k + 16; B [32 x 8]: b0 = B[4t..4t+3][g], b1 = B[16+4t..][g];
//   C as for mma_bf16.
// So ldmatrix reads both from [row][k] tiles (k innermost, 16 bytes a matrix
// row) with the bf16 addressing: a k-step of 32 bytes is one of 16 bf16.
__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes from global src (16-byte aligned) to shared dst, asynchronously;
// with valid false the 16 bytes are zero-filled and src is not read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most N of this thread's committed groups are still in flight.
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// cp_async_wait<n> for a count known only at run time (0 <= n <= 7).
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// 2^x by the special-function unit (ex2.approx; 2^-inf = 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace gct
