// K9: the windowed absolute position tables of DeBERTa's tiled route.
//
// Replaces the TPU kernel gliclass/c_tpu/ops/fused_attention.py::_win_table_kernel
// (reached through _windowed_tables_call), which computes
//
//   T[h, w, e, x, y] = pos_rel[h, w*blk + y - x + blk - 1, e],   w < 2S/blk - 1
//
// as a one-hot matrix product on the TPU's MXU: the absolute table
// T[h, e, i, j] = pos_rel[h, j - i + S - 1, e] restricted to the 2S/blk - 1
// distinct block-diagonals of its (blk x blk) tiles. (The row of zeros that
// the TPU version appends to pos_rel is never read: the largest index,
// (2n-2)*blk + 2*blk - 2, is 2S - 2.) Here it is what it is, a copy: every
// output element is one input element, so the result is exact in any type.
//
// Layout: this kernel writes T as [h, w, x, y, e], d innermost, so that the
// d-vector K10 contracts with q or k for one (x, y) pair is contiguous. The
// tests compare it with the JAX package's [h, w, e, x, y] through a
// permutation.
//
// What bounds it on the H100: bytes. It writes h*(2S/blk - 1)*blk*blk*d
// elements (48.8 MB at h=12, S=512, blk=32, d=64 in bf16: 0.015 ms at
// 3.35 TB/s) and reads a [2S-1, d] table per head that stays in L2.
//
// What the design does about it: in this layout the blk x d slab
// T[h, w, x, :, :] is the run of blk consecutive rows of pos_rel that starts
// at w*blk - x + blk - 1, so each block copies one such slab, contiguous on
// both sides, in 16-byte vectors where d's bytes allow it (elementwise
// otherwise).

#include "common.cuh"

namespace {

using namespace gct;

constexpr int THREADS = 128;

template <typename T>
__global__ void __launch_bounds__(THREADS)
win_table_kernel(const T* __restrict__ pos, T* __restrict__ out, int S, int D, int blk, bool vec) {
  const int x = blockIdx.x, w = blockIdx.y, h = blockIdx.z, n_win = gridDim.y;
  const long long first = (long long)w * blk - x + blk - 1;  // relative row of y = 0
  const T* src = pos + ((long long)h * (2 * S - 1) + first) * D;
  T* dst = out + (((size_t)h * n_win + w) * blk + x) * blk * D;
  const int n = blk * D;
  if (vec) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (int e = threadIdx.x; e < n * (int)sizeof(T) / 16; e += THREADS) d4[e] = s4[e];
  } else {
    for (int e = threadIdx.x; e < n; e += THREADS) dst[e] = src[e];
  }
}

template <typename T>
int launch(const void* pos, void* out, int H, int S, int D, int blk, cudaStream_t stream) {
  const bool vec = (D * sizeof(T)) % 16 == 0 && (uintptr_t)pos % 16 == 0 && (uintptr_t)out % 16 == 0;
  dim3 grid(blk, 2 * (S / blk) - 1, H);
  win_table_kernel<T><<<grid, THREADS, 0, stream>>>((const T*)pos, (T*)out, S, D, blk, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. pos: [H, 2S-1, D] contiguous; out:
// [H, 2S/blk - 1, blk, blk, D] contiguous. blk divides S.
extern "C" int gct_windowed_pos_table(int dtype, const void* pos, void* out, int H, int S, int D,
                                      int blk, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (H < 1 || S < 1 || D < 1 || blk < 1 || S % blk) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch<float>(pos, out, H, S, D, blk, st);
  if (dtype == 1) return launch<__nv_bfloat16>(pos, out, H, S, D, blk, st);
  return (int)cudaErrorInvalidValue;
}
