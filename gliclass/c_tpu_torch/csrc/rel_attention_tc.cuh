// Pieces shared by the tensor-core disentangled-attention kernels K8′
// (row_disentangled_attention_tc.cu) and K1′ (flash_disentangled_attention_tc.cu):
// bf16 staging of head rows (q, k, v) and of a relative table's 127-row
// window, the B fragments of the window products, the products over the band
// of window columns a 16-row strip touches, and the scatter of their
// accumulators onto (query row, key) cells.
//
// For a 64-row query tile i0 and a 64-key tile j0 of one head:
//   the c2p window row w holds relative row j0 - i0 + S - 64 + w, and cell
//   (il, jl) takes w = jl - il + 63 of q row il's product Q . Wk^T;
//   the p2c window row w holds relative row i0 - j0 + S - 64 + w, and cell
//   (il, jl) takes w = il - jl + 63 of k row jl's product K . Wq^T.
// Row 127 of a window is padding (zero). A strip of 16 rows m0 = 16 s (query
// rows in c2p, keys in p2c) touches window columns 48 - 16 s .. 126 - 16 s
// only: the ten n8 column tiles from band_base(s) = 6 - 2 s.

#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace {
namespace relatt {

using namespace gct;
using bf16 = __nv_bfloat16;

constexpr int D = 64;       // head dim
constexpr int WIN = 128;    // 64 + 64 - 1 = 127 relative rows, padded
constexpr int LDH = D + 8;  // bf16 shared rows: 144 bytes, ldmatrix conflict-free

// dst[r][c] = row(r)[c] for r < NR, c < D (zeros where row(r) is null), by the
// block's THREADS threads: cp.async 16-byte copies when the rows allow (vec;
// `safe` is a readable address for the zero-filled copies), else element by
// element.
template <int NR, int THREADS, typename Row>
__device__ __forceinline__ void stage(Row row, bool vec, const bf16* safe, bf16* dst) {
  if (vec) {
    for (int e = threadIdx.x; e < NR * D / 8; e += THREADS) {
      const int r = e / (D / 8), c = (e % (D / 8)) * 8;
      const bf16* src = row(r);
      cp_async16(dst + r * LDH + c, src ? src + c : safe, src != nullptr);
    }
    return;
  }
  for (int e = threadIdx.x; e < NR * D; e += THREADS) {
    const int r = e / D, c = e % D;
    const bf16* src = row(r);
    dst[r * LDH + c] = src ? src[c] : __float2bfloat16(0.f);
  }
}

// B fragments of two n8 tiles (rows n0..n0+15 of a [n][k] tile) at k-step ks.
__device__ __forceinline__ void ld_b_pair(uint32_t r[4], const bf16* base, int n0, int ks, int lane) {
  ldmatrix_x4(r, base + (n0 + (lane & 7) + ((lane >> 4) << 3)) * LDH + ks * 16 + ((lane >> 3) & 1) * 8);
}

// The first n8 window column tile of strip s.
__device__ __forceinline__ int band_base(int strip) { return 6 - 2 * strip; }

// acc[n] += A . W[(base + n) * 8 .. +8]^T over k-step ks, for the n8 tiles
// n < 2 * NP with own(n): NP pairs of column tiles loaded from window W.
template <int NP, typename Own>
__device__ __forceinline__ void band_mma(float (*acc)[4], const uint32_t a[4], const bf16* W, int base, int ks,
                                         int lane, Own own) {
#pragma unroll
  for (int np = 0; np < NP; ++np) {
    uint32_t bb[4];
    ld_b_pair(bb, W, (base + 2 * np) * 8, ks, lane);
    if (own(2 * np)) mma_bf16(acc[2 * np], a, bb[0], bb[1]);
    if (own(2 * np + 1)) mma_bf16(acc[2 * np + 1], a, bb[2], bb[3]);
  }
}

// c2p: accumulator element (query row il of strip m0, window column w) is
// added to key jl = w + il - 63 by add(il, jl, value), where 0 <= jl < 64.
template <int NT, typename Own, typename Add>
__device__ __forceinline__ void scatter_c2p(const float (*acc)[4], int m0, int base, int lane, Own own, Add add) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (!own(nt)) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int il = m0 + g + 8 * (i >> 1), w = (base + nt) * 8 + 2 * t + (i & 1);
      const int jl = w + il - 63;
      if (jl >= 0 && jl < 64) add(il, jl, acc[nt][i]);
    }
  }
}

// p2c: accumulator element (key jl of strip m0, window column w) is added to
// query row il = w + jl - 63 by add(il, jl, value), where 0 <= il < 64.
template <int NT, typename Own, typename Add>
__device__ __forceinline__ void scatter_p2c(const float (*acc)[4], int m0, int base, int lane, Own own, Add add) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int jl = m0 + g + 8 * (i >> 1);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (!own(nt)) continue;
      const int il = (base + nt) * 8 + 2 * t + (i & 1) + jl - 63;
      if (il >= 0 && il < 64) add(il, jl, acc[nt][i]);
    }
  }
}

}  // namespace relatt
}  // namespace
