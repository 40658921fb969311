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
// copy: every output element is one input element, so the result is exact in
// any type.
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
// table per head that stays in L2. Written one element at a time (201 M
// two-byte stores, each behind its own index arithmetic) it reached a third
// of that rate, so the design is about fewer instructions per byte.
//
// What the design does about it: a block owns X query rows, up to 1024 key
// columns and a group of channels of one head. It stages the relative rows
// its tile touches once in shared memory, in the table's own type,
// transposed to [channel][row], by 16-byte loads of 8 (bf16) or 4 (fp32)
// channels of two rows each. Row x of channel c is then the run of the staged
// channel that starts X - 1 - (x - x0) elements in: one 16-byte output vector
// is E = 16 / sizeof(T) consecutive staged elements, shifted back by one
// element from one x to the next. Each thread owns one output vector column
// (channel, y .. y + E - 1) and walks x upward, back along the staged row:
// E shared-memory reads and one 16-byte store a row, at a pointer that steps
// by d*S elements. No division, 64-bit multiply or bounds test is spent per
// element. (A 32-byte register window of two aligned shared reads, funnel-
// shifted into the E vectors between them, was 0-7% faster on an H100 at
// 700 W, both near the memory's write rate; the plain reads were kept as the
// simpler code.) Neighbouring threads own neighbouring vectors, so a warp's store
// is 512 contiguous bytes. The host picks the tile so that the grid holds two
// blocks per SM or more where the table is large enough (X from 32 down to 8
// at the short buckets).
// Rows that are not whole 16-byte vectors (S not a multiple of E) and a
// pos_rel that is not 16-byte aligned (or whose d is not a multiple of E) take
// the scalar paths of the same kernel: element stores along y, element loads
// for the staging. d enters only the per-thread setup, so no width needs its
// own specialisation.

#include "common.cuh"

namespace {

using namespace gct;

constexpr int THREADS = 256;
constexpr int YMAX = 1024;       // key columns per block at most
constexpr int MIN_BLOCKS = 264;  // two per SM of the H100's 132

// Two staged elements of one channel (rows l, l + 1) as one shared-memory store.
__device__ __forceinline__ void store_pair(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* dst, __nv_bfloat16 a, __nv_bfloat16 b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __halves2bfloat162(a, b);
}

// Grid: (channel group + n_cg * key tile, query tile, head). The block's
// tile is query rows [x0, x0 + X), key columns [y0, y0 + Y), channels
// [c0, c0 + C), each clipped to the table. Staged window: win[c][l] =
// pos_rel[h, ubase + l, c0 + c] for l < L (zero off the table), so that
// output (x0 + xl, y0 + yl) reads l = yl - xl + X - 1.
template <typename T>
__global__ void __launch_bounds__(THREADS)
abs_pos_table_kernel(const T* __restrict__ pos, T* __restrict__ out, int S, int D, int X, int Y, int C, int L,
                     int n_cg, bool vec_in, bool vec_out) {
  constexpr int E = 16 / sizeof(T);
  extern __shared__ uint4 smem[];  // [C][L] elements
  T* win = reinterpret_cast<T*>(smem);
  const int cg = blockIdx.x % n_cg, h = blockIdx.z;
  const int c0 = cg * C, y0 = (blockIdx.x / n_cg) * Y, x0 = blockIdx.y * X;
  const int Cb = min(C, D - c0), Yb = min(Y, S - y0), Xb = min(X, S - x0);
  const int W = 2 * S - 1, ubase = y0 - x0 + S - X;
  const T* ph = pos + (size_t)h * W * D + c0;

  if (vec_in) {  // 16-byte loads of E channels of rows l and l + 1; rows fastest
    const int pairs = L / 2;
    for (int e = threadIdx.x; e < pairs * (Cb / E); e += THREADS) {
      const int q = e / pairs, l = 2 * (e - q * pairs), m = ubase + l;
      uint4 a = make_uint4(0, 0, 0, 0), b = a;
      if (m >= 0 && m < W) a = *reinterpret_cast<const uint4*>(ph + (size_t)m * D + q * E);
      if (m + 1 >= 0 && m + 1 < W) b = *reinterpret_cast<const uint4*>(ph + (size_t)(m + 1) * D + q * E);
      const T* av = reinterpret_cast<const T*>(&a);
      const T* bv = reinterpret_cast<const T*>(&b);
#pragma unroll
      for (int i = 0; i < E; ++i) store_pair(win + (q * E + i) * L + l, av[i], bv[i]);
    }
  } else {
    for (int e = threadIdx.x; e < Cb * L; e += THREADS) {
      const int c = e / L, l = e - c * L, m = ubase + l;
      win[e] = (m >= 0 && m < W) ? ph[(size_t)m * D + c] : from_float<T>(0.f);
    }
  }
  __syncthreads();

  const size_t dS = (size_t)D * S;
  T* const tile = out + (((size_t)h * S + x0) * D + c0) * S + y0;
  if (vec_out) {
    // Item f = (channel c, vector v): row x0 + xl reads E staged elements
    // from v*E + X - 1 - xl on.
    const int NV = Yb / E;
    for (int f = threadIdx.x; f < Cb * NV; f += THREADS) {
      const int c = f / NV, v = f - c * NV;
      const T* wr = win + c * L + v * E + X - 1;
      T* p = tile + c * (size_t)S + v * E;
      for (int xl = 0; xl < Xb; ++xl, --wr, p += dS) {
        uint4 o;
        T* ov = reinterpret_cast<T*>(&o);
#pragma unroll
        for (int i = 0; i < E; ++i) ov[i] = wr[i];
        *reinterpret_cast<uint4*>(p) = o;
      }
    }
  } else {
    // One warp per (row, channel), lanes along y.
    const int lane = threadIdx.x % 32;
    for (int r = threadIdx.x / 32; r < Xb * Cb; r += THREADS / 32) {
      const int xl = r / Cb, c = r - xl * Cb;
      T* p = tile + xl * dS + c * (size_t)S;
      const T* wr = win + c * L + X - 1 - xl;
      for (int yl = lane; yl < Yb; yl += 32) p[yl] = wr[yl];
    }
  }
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

template <typename T>
int launch(const void* pos, void* out, int H, int S, int D, cudaStream_t stream) {
  constexpr int E = 16 / sizeof(T);
  const bool vec_out = S % E == 0 && (uintptr_t)out % 16 == 0;
  const bool vec_in = D % E == 0 && (uintptr_t)pos % 16 == 0;  // then C is a multiple of E too
  const int Y = S < YMAX ? S : YMAX, n_yt = cdiv(S, Y), NV = cdiv(Y, E);
  // Channels per block: enough (channel, vector) items for two passes of the
  // block's threads, in whole vectors of channels where the staging loads
  // them so, balanced over the groups.
  const int unit = D % E == 0 ? E : 1;
  int C = cdiv(cdiv(2 * THREADS, NV), unit) * unit;
  C = C < D ? C : D;
  const int n_cg = cdiv(D, C);
  C = cdiv(cdiv(D, n_cg), unit) * unit;
  // Query rows per block: 32, fewer where the grid would hold fewer than two
  // blocks per SM.
  int X = 32;
  while (X > 8 && (long long)n_cg * n_yt * cdiv(S, X) * H < MIN_BLOCKS) X /= 2;
  const int L = NV * E + X;                       // even, as the paired staging needs
  const int smem = C * L * (int)sizeof(T);        // at most 24 KB for d <= 128
  dim3 grid(n_cg * n_yt, cdiv(S, X), H);
  abs_pos_table_kernel<T><<<grid, THREADS, smem, stream>>>((const T*)pos, (T*)out, S, D, X, Y, C, L, n_cg,
                                                          vec_in, vec_out);
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
