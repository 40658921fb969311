// K6: the absolute position table of DeBERTa's bias route.
//
// Replaces the TPU kernel gliclass/c_tpu/ops/fused_attention.py::_table_build_kernel
// (reached through _abs_pos_table_call and abs_pos_table) and, for S not
// divisible by its block, the XLA one-hot builder it hands over to
// (gliclass/c_tpu/models/deberta.py::_abs_pos_table). Both compute
//
//   T[h, d, x, y] = pos_rel[h, y - x + S - 1, d]
//
// as a one-hot matrix product on the TPU's MXU. Here it is what it is, a
// gather: every output element is a copy of one input element, so the result
// is exact in any type.
//
// Layout: this kernel writes T as [h, S(x), d, S(y)], i.e. the [d, S] slab of
// one query row x is contiguous. The bias products that read the table are
// batched over (h, x) with the batch as M (c2p[b, h, i, :] = q[b, h, i, :] .
// T[h, i]), so this layout feeds torch.matmul without a transpose copy. The
// plain version returns the same layout; the tests compare it with the JAX
// package's [h, d, S, S] through a permutation.
//
// What bounds it on the H100: bytes. It writes h*S*S*d elements (402.7 MB at
// h=12, S=512, d=64 in bf16: 0.120 ms at 3.35 TB/s) and reads a [2S-1, d]
// table per head that stays in L2.
//
// What the design does about it: one block owns a 16 x 64 (x, y) tile of one
// head. The 79 relative rows that the tile touches are staged once in shared
// memory, transposed to [d][row] with an odd row stride (no bank conflicts on
// either side), and the block writes its [16, d, 64] output with neighbouring
// threads on neighbouring y, so every warp store is one contiguous run. Any S
// and any d <= 128 are taken; the ragged edge is masked in the block.

#include "common.cuh"

namespace {

using namespace gct;

constexpr int TY = 64;                 // y (key) columns per block
constexpr int TX = 16;                 // x (query) rows per block
constexpr int THREADS = 256;
constexpr int WROWS = TY + TX - 1;     // relative rows a tile touches
constexpr int LDW = WROWS + 2;         // 81: odd stride in words

template <typename T>
__global__ void __launch_bounds__(THREADS)
abs_pos_table_kernel(const T* __restrict__ pos, T* __restrict__ out, int S, int D) {
  extern __shared__ float win[];  // [D][LDW]: win[c][r] = pos_rel[base + r, c]
  const int y0 = blockIdx.x * TY, x0 = blockIdx.y * TX, h = blockIdx.z;
  const int W = 2 * S - 1;
  // Window row r holds relative row base + r; output (xl, yl) reads
  // r = yl - xl + TX - 1.
  const int base = y0 - x0 - (TX - 1) + S - 1;
  const T* ph = pos + (size_t)h * W * D;
  for (int e = threadIdx.x; e < WROWS * D; e += THREADS) {
    const int r = e / D, c = e - r * D, m = base + r;
    win[c * LDW + r] = (m >= 0 && m < W) ? to_float(ph[(size_t)m * D + c]) : 0.f;
  }
  __syncthreads();

  const int yl = threadIdx.x % TY, y = y0 + yl;
  if (y >= S) return;
  for (int rc = threadIdx.x / TY; rc < TX * D; rc += THREADS / TY) {
    const int xl = rc / D, c = rc - xl * D, x = x0 + xl;
    if (x >= S) break;
    out[(((size_t)h * S + x) * D + c) * S + y] = from_float<T>(win[c * LDW + yl - xl + TX - 1]);
  }
}

template <typename T>
int launch(const void* pos, void* out, int H, int S, int D, cudaStream_t stream) {
  const int smem = D * LDW * (int)sizeof(float);
  dim3 grid((S + TY - 1) / TY, (S + TX - 1) / TX, H);
  abs_pos_table_kernel<T><<<grid, THREADS, smem, stream>>>((const T*)pos, (T*)out, S, D);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. pos: [H, 2S-1, D] contiguous;
// out: [H, S, D, S] contiguous. D <= 128.
extern "C" int gct_abs_pos_table(int dtype, const void* pos, void* out, int H, int S, int D,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D < 1 || D > 128 || S < 1 || H < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch<float>(pos, out, H, S, D, st);
  if (dtype == 1) return launch<__nv_bfloat16>(pos, out, H, S, D, st);
  return (int)cudaErrorInvalidValue;
}
