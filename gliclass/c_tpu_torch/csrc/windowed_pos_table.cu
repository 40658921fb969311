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
// at w*blk - x + blk - 1, so the blk slabs of one (h, w) are overlapping runs
// of the same 2*blk - 1 rows. One block owns 8 consecutive slabs of one
// (h, w) (32 KB of output at blk=32, d=64 in bf16, contiguous): it stages the
// 8 + blk - 1 rows they share once in shared memory (5 KB) and writes the
// slabs from there, 16-byte loads and stores, neighbouring threads on
// neighbouring vectors. That is 1,488 blocks at the tiled route's shape
// where one 4 KB block per slab made 11,904, and pos_rel is read from L2
// once per block instead of once per slab. (At that shape the same grid
// copying from pos_rel in L2 without the staging took 0.0201 ms of device
// time against 0.0176, bf16 on an H100 at 700 W.) Where d's bytes are not
// whole 16-byte vectors, or pos_rel or the output is not 16-byte aligned, the
// same kernel loads or stores element by element; where the shared rows
// would not fit in 48 KB (blk*d beyond 12,288 fp32 values) it copies from
// pos_rel directly.

#include "common.cuh"

namespace {

using namespace gct;

constexpr int THREADS = 128;
constexpr int XG = 8;                  // slabs (query rows x) per block
constexpr int SMEM_MAX = 48 * 1024;

// Grid: (x group, window w, head). Slab x of window w copies the rows from
// first(x) = w*blk - x + blk - 1 on; the block's xn slabs share rows
// r0 = first(x0 + xn - 1) .. first(x0) + blk - 1.
template <typename T>
__global__ void __launch_bounds__(THREADS)
win_table_kernel(const T* __restrict__ pos, T* __restrict__ out, int S, int D, int blk, bool stage, bool vec_in,
                 bool vec_out) {
  constexpr int E = 16 / sizeof(T);
  extern __shared__ uint4 smem[];
  const int x0 = blockIdx.x * XG, w = blockIdx.y, h = blockIdx.z, n_win = gridDim.y;
  const int xn = min(XG, blk - x0);
  const int r0 = w * blk - (x0 + xn - 1) + blk - 1;
  const T* src = pos + ((size_t)h * (2 * S - 1) + r0) * D;
  const T* rows = src;
  if (stage) {
    const int n = (xn + blk - 1) * D;
    if (vec_in) {
      for (int e = threadIdx.x; e < n / E; e += THREADS) smem[e] = reinterpret_cast<const uint4*>(src)[e];
    } else {
      T* s = reinterpret_cast<T*>(smem);
      for (int e = threadIdx.x; e < n; e += THREADS) s[e] = src[e];
    }
    __syncthreads();
    rows = reinterpret_cast<const T*>(smem);
  }
  const int slab = blk * D;
  T* dst = out + (((size_t)h * n_win + w) * blk + x0) * slab;
  for (int xl = 0; xl < xn; ++xl, dst += slab) {
    const T* s = rows + (xn - 1 - xl) * D;  // row first(x0 + xl)
    if (vec_out) {
      const uint4* s4 = reinterpret_cast<const uint4*>(s);
      uint4* d4 = reinterpret_cast<uint4*>(dst);
      for (int e = threadIdx.x; e < slab / E; e += THREADS) d4[e] = s4[e];
    } else {
      for (int e = threadIdx.x; e < slab; e += THREADS) dst[e] = s[e];
    }
  }
}

template <typename T>
int launch(const void* pos, void* out, int H, int S, int D, int blk, cudaStream_t stream) {
  const int rows = (blk < XG ? blk : XG) + blk - 1;
  const size_t smem = (size_t)rows * D * sizeof(T);
  const bool stage = smem <= SMEM_MAX;
  const bool whole = (D * sizeof(T)) % 16 == 0, pos_al = (uintptr_t)pos % 16 == 0;
  const bool vec_in = whole && pos_al;
  const bool vec_out = whole && (uintptr_t)out % 16 == 0 && (stage || pos_al);
  dim3 grid((blk + XG - 1) / XG, 2 * (S / blk) - 1, H);
  win_table_kernel<T><<<grid, THREADS, stage ? smem : 0, stream>>>((const T*)pos, (T*)out, S, D, blk, stage,
                                                                  vec_in, vec_out);
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
