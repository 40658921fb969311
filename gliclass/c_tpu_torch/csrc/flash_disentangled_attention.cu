// K1: blocked flash DeBERTa disentangled attention (content + c2p + p2c).
//
// Replaces the TPU kernel gliclass/c_tpu/ops/fused_attention.py::_flash_kernel
// (reached through _flash_call and flash_disentangled_attention).
//
//   s[i,j] = (q_i.k_j + q_i.posk_rel[j-i+S-1] + k_j.posq_rel[i-j+S-1]) / scale
//   out_i  = softmax_j(s[i,:] with masked keys at -1e30) . v
//
// What bounds it on the H100: per (batch, head) it reads q, k, v and the
// [2S-1, d] position tables once and writes the context once, while it does
// about 2*S*S*d*6 operations (qk, P.v and the two relative products, the
// latter over a 2x-wide window). From S ~ 128 up that is far above the card's
// ~295 operations per byte, so it is bound by arithmetic, and by how much of
// that arithmetic reaches an execution unit.
//
// What the design does about it: no [S, S] score tensor ever goes to device
// memory. One block owns one 64-row query tile of one (batch, head) and loops
// over 64-key tiles with an fp32 online softmax. The Toeplitz structure of the
// relative bias is used through index arithmetic: the 127 relative rows that
// a (query tile, key tile) pair touches are staged in shared memory, the two
// [64 x 128] window products are formed there, and the skew of the TPU kernel
// (log2(blk) rolls) becomes the index (j - i + 63). The ragged edge (any S on
// the bucket ladder, not only multiples of 64) is masked in the block. This
// first version runs the products as fp32 FMAs on CUDA cores out of shared
// memory; moving them to tensor cores (mma/wgmma) is the next step.
//
// Numerics follow the TPU kernel: masked keys use a finite -1e30 (a key tile
// that is wholly masked at the start of a row then gives exp(0) = 1 terms
// that the first valid tile rescales by exp(-1e30 - m) = 0). Keys past S (the
// last tile's padding) are -inf and weigh exactly 0, so a row with no valid
// key gives the mean of v over its S keys, as the plain version does. The
// three terms are summed before the scale; P is rounded to v's type before
// P.v; the accumulator is fp32. Query rows whose own mask is 0 are computed
// like any other (key-only mask).
//
// A query-row offset (sequence parallelism): q may hold only Sq rows, the
// absolute rows q_off .. q_off + Sq - 1 of the S keys, with strides of its
// own. A tile's relative windows follow its absolute rows; every row reads
// only its own scores, so its result is the full launch's bit for bit. The
// launch over every row with k's strides (sequence parallelism off) takes an
// instantiation where q's strides, Sq and q_off are k's, S and 0 at compile
// time: with them at run time the kernel took 18% longer at q_off = 0 (same
// 128 registers, no spills; scripts/k1_k2_times.py device time, H100).

#include <math.h>

#include "common.cuh"

namespace {

using namespace gct;

constexpr int D = 64;       // head dim
constexpr int BQ = 64;      // query rows per block
constexpr int BK = 64;      // keys per tile
constexpr int WIN = 128;    // 2*64-1 relative rows, padded to 128
constexpr int LD = D + 1;   // padded shared-memory row (floats)
constexpr int LDW = WIN + 1;
constexpr int THREADS = 256;
constexpr int SMEM_FLOATS = 3 * BQ * LD + 2 * WIN * LD + 2 * BQ * LDW + BQ * LD;
constexpr int SMEM_BYTES = SMEM_FLOATS * 4;

__device__ __forceinline__ float group16_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float group16_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, bool ALL_ROWS>
__global__ void __launch_bounds__(THREADS)
flash_da_kernel(const T* __restrict__ q, int q_sb, int q_sh, int q_ss, const T* __restrict__ k,
                const T* __restrict__ v, int sb, int sh, int ss, const T* __restrict__ posk,
                const T* __restrict__ posq, const int* __restrict__ mask,
                T* __restrict__ out, int H, int q_rows, int S, int q_first, float inv_scale) {
  // ALL_ROWS: q is every row, with k's strides.
  const int qsb = ALL_ROWS ? sb : q_sb, qsh = ALL_ROWS ? sh : q_sh, qss = ALL_ROWS ? ss : q_ss;
  const int Sq = ALL_ROWS ? S : q_rows, q_off = ALL_ROWS ? 0 : q_first;
  extern __shared__ float sm[];
  float* Qs = sm;                 // [BQ][LD]
  float* Ks = Qs + BQ * LD;       // [BK][LD]
  float* Vt = Ks + BK * LD;       // [D][LD]   (v transposed: [d][key])
  float* PK = Vt + D * LD;        // [WIN][LD] c2p window of posk_rel
  float* PQ = PK + WIN * LD;      // [WIN][LD] p2c window of posq_rel
  float* QP = PQ + WIN * LD;      // [BQ][LDW] q . PK^T
  float* KP = QP + BQ * LDW;      // [BK][LDW] k . PQ^T
  float* Ps = KP + BK * LDW;      // [BQ][LD]  probabilities of this tile

  const int i0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const size_t off = (size_t)b * sb + (size_t)h * sh;
  const T* qb = q + (size_t)b * qsb + (size_t)h * qsh;
  const T* kb = k + off;
  const T* vb = v + off;
  const int W = 2 * S - 1;
  const T* pk = posk + (size_t)h * W * D;
  const T* pq = posq + (size_t)h * W * D;
  const int* mb = mask + (size_t)b * S;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, c = e % D, i = i0 + r;
    Qs[r * LD + c] = i < Sq ? to_float(qb[(size_t)i * qss + c]) : 0.f;
  }

  float o[4][4], m[4], l[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = -1e30f;
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) o[a][c] = 0.f;
  }

  const int nk = (S + BK - 1) / BK;
  for (int t = 0; t < nk; ++t) {
    const int j0 = t * BK;
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < BK * D; e += THREADS) {
      const int r = e / D, c = e % D, j = j0 + r;
      float kv = 0.f, vv = 0.f;
      if (j < S) {
        kv = to_float(kb[(size_t)j * ss + c]);
        vv = to_float(vb[(size_t)j * ss + c]);
      }
      Ks[r * LD + c] = kv;
      Vt[c * LD + r] = vv;
    }
    // Window row w holds relative row base + w; for local (il, jl) the c2p
    // row is w = jl - il + 63 and the p2c row is w = il - jl + 63. The tile's
    // first absolute row is i0 + q_off.
    const int base_c = j0 - (i0 + q_off) + S - BQ;
    const int base_p = (i0 + q_off) - j0 + S - BK;
    for (int e = tid; e < WIN * D; e += THREADS) {
      const int w = e / D, c = e % D, mc = base_c + w, mp = base_p + w;
      const bool in_win = w < WIN - 1;
      PK[w * LD + c] = (in_win && mc >= 0 && mc < W) ? to_float(pk[(size_t)mc * D + c]) : 0.f;
      PQ[w * LD + c] = (in_win && mp >= 0 && mp < W) ? to_float(pq[(size_t)mp * D + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = 0.f;
    mm_abt<4, D, LD>(Qs, Ks, LD, tr, tc, s);
    {
      float acc[4][8];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[a][c] = 0.f;
      mm_abt<8, D, LD>(Qs, PK, LD, tr, tc, acc);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 8; ++c) QP[(tr * 4 + a) * LDW + tc + 16 * c] = acc[a][c];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[a][c] = 0.f;
      mm_abt<8, D, LD>(Ks, PQ, LD, tr, tc, acc);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 8; ++c) KP[(tr * 4 + a) * LDW + tc + 16 * c] = acc[a][c];
    }
    __syncthreads();

#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int il = tr * 4 + a;
      float mx = -3.0e38f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int jl = tc + 16 * c, j = j0 + jl;
        const float x = (s[a][c] + QP[il * LDW + jl - il + 63] + KP[jl * LDW + il - jl + 63]) * inv_scale;
        s[a][c] = j >= S ? -INFINITY : mb[j] > 0 ? x : -1e30f;
        mx = fmaxf(mx, s[a][c]);
      }
      const float m_new = fmaxf(m[a], group16_max(mx));
      const float alpha = expf(m[a] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[a][c] - m_new);
        sum += p;
        Ps[il * LD + tc + 16 * c] = round_to<T>(p);
      }
      l[a] = alpha * l[a] + group16_sum(sum);
      m[a] = m_new;
#pragma unroll
      for (int c = 0; c < 4; ++c) o[a][c] *= alpha;
    }
    __syncthreads();
    mm_abt<4, D, LD>(Ps, Vt, LD, tr, tc, o);
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + tr * 4 + a;
    if (i >= Sq) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      out[(((size_t)b * Sq + i) * H + h) * D + tc + 16 * c] = from_float<T>(o[a][c] / l[a]);
  }
}

template <typename T>
int launch(const void* q, int qsb, int qsh, int qss, const void* k, const void* v, int sb,
           int sh, int ss, const void* posk, const void* posq, const void* mask, void* out,
           int B, int H, int Sq, int S, int q_off, float inv_scale, cudaStream_t stream) {
  static cudaError_t attr = allow_smem(flash_da_kernel<T, false>, SMEM_BYTES);
  static cudaError_t attr_all = allow_smem(flash_da_kernel<T, true>, SMEM_BYTES);
  if (attr != cudaSuccess) return (int)attr;
  if (attr_all != cudaSuccess) return (int)attr_all;
  const bool all_rows = Sq == S && q_off == 0 && qsb == sb && qsh == sh && qss == ss;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  (all_rows ? flash_da_kernel<T, true> : flash_da_kernel<T, false>)<<<grid, THREADS, SMEM_BYTES, stream>>>(
      (const T*)q, qsb, qsh, qss, (const T*)k, (const T*)v, sb, sh, ss, (const T*)posk,
      (const T*)posq, (const int*)mask, (T*)out, H, Sq, S, q_off, inv_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q: [B, H, Sq, 64] with element strides
// (qsb, qsh, qss), the query rows q_off .. q_off + Sq - 1; k/v: [B, H, S, 64]
// with element strides (sb, sh, ss); all with a unit last stride; posk/posq:
// [H, 2S-1, 64] contiguous; mask: [B, S] int32; out: [B, Sq, H, 64]
// contiguous. 1 <= Sq, 0 <= q_off, q_off + Sq <= S.
extern "C" int gct_flash_disentangled_attention(int dtype, const void* q, int qsb, int qsh,
                                                int qss, const void* k, const void* v, int sb,
                                                int sh, int ss, const void* posk,
                                                const void* posq, const void* mask, void* out,
                                                int B, int H, int Sq, int S, int q_off,
                                                float inv_scale, void* stream) {
  if (Sq < 1 || q_off < 0 || q_off + Sq > S) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, qsb, qsh, qss, k, v, sb, sh, ss, posk, posq, mask, out, B, H, Sq,
                         S, q_off, inv_scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, qsb, qsh, qss, k, v, sb, sh, ss, posk, posq, mask, out, B,
                                 H, Sq, S, q_off, inv_scale, st);
  return (int)cudaErrorInvalidValue;
}
