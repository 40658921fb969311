// K8: whole-row DeBERTa disentangled attention (content + c2p + p2c, exact softmax).
//
// Replaces the TPU kernel gliclass/c_tpu/ops/fused_attention.py::_kernel
// (reached through _fused_call and fused_disentangled_attention):
//
//   s[i, j] = (q_i.k_j + q_i.posk_rel[j-i+S-1] + k_j.posq_rel[i-j+S-1]) * (1 / scale)   fp32
//   s[i, j] = -1e30 where key j is masked
//   p       = exp(s - max_j s) / sum_j exp(s - max_j s), rounded to v's type
//   out_i   = sum_j p[i, j] v_j                                               fp32 sum
//
// The TPU kernel holds, for a group of heads, the whole [S, 2S-1] products
// q.posk_rel^T and k.posq_rel^T and the [S, S] scores in VMEM, and skews the
// relative axis to the absolute one with log2(S) rolls. None of that fits a
// block of the H100 (227 KB of shared memory), and the rolls are only the
// TPU's way to index.
//
// What bounds it on the H100: at [B, h, S, d] = [128, 12, 512, 64] it does
// four S x S x d products per (batch, head) (q.k, c2p, p2c, p.v), 206 GFLOP,
// 0.21 ms on bf16 tensor cores, against 0.2 GB of q, k, v, out and tables
// (0.06 ms at 3.35 TB/s). So operations bound it.
//
// What the design does about it: one block owns R = 64 query rows of one
// (batch, head) and keeps their whole score rows in shared memory as fp32
// (K7's buffer: 64 x 512 x 4 = 128 KB), so the softmax is exact in one pass as
// in the TPU kernel, and no score goes to device memory. The key loop takes
// tiles of 64 keys. The relative rows that a (row tile, key tile) pair
// touches are 127 of each table; they are staged in one shared buffer, first
// those of posk_rel, then those of posq_rel, so the S + R - 1 rows of a whole
// row tile are never held at once. Each window product ([64 x 128], as in K1)
// is added into the score rows with the skew as index arithmetic: cell
// (il, jl) takes window row jl - il + 63 of the c2p product and il - jl + 63
// of the p2c product, so each cell receives exactly one term of each. q.k,
// the window products and p.v are fp32 FMAs on CUDA cores from shared memory
// (each thread a 4 x 4 or 4 x 8 register tile); tensor cores are later work.
// Rows of q, k, v and the tables are staged with 16-byte loads where they are
// aligned, element by element otherwise.
//
// Numerics follow the TPU kernel: the terms are summed (q.k + c2p) + p2c
// before the scale; p is normalised by a division and rounded to v's type
// before p.v. Masked keys get exp(-1e30 - m) = 0 exactly. A row whose keys
// are all masked has m = -1e30 and gives the plain mean of v over its S keys,
// as in the TPU kernel. Query rows beyond S are not written. S <= 512.

#include "common.cuh"

namespace {

using namespace gct;

constexpr int D = 64;        // head dim
constexpr int R = 64;        // query rows per block
constexpr int KT = 64;       // keys per tile
constexpr int WIN = 128;     // R + KT - 1 = 127 relative rows, padded
constexpr int LD = D + 1;    // padded shared-memory row (floats)
constexpr int THREADS = 256;
constexpr int MAX_S = 512;

inline int smem_bytes(int S_pad) { return (R * (S_pad + 4) + R * LD + KT * LD + WIN * LD) * 4; }

// dst[r][c] = row(r)[c] as floats for r < NR, c < D (zeros where row(r) is
// null), in 16-byte loads when the rows allow (vec), else element by element.
template <int NR, typename T, typename Row>
__device__ __forceinline__ void stage(Row row, bool vec, float* dst) {
  if (vec) {
    constexpr int PER = 16 / sizeof(T);
    for (int e = threadIdx.x; e < NR * D / PER; e += THREADS) {
      const int r = e / (D / PER), c = (e % (D / PER)) * PER;
      const T* src = row(r);
      float t[PER];
      if (src) {
        load16(src + c, t);
      } else {
#pragma unroll
        for (int u = 0; u < PER; ++u) t[u] = 0.f;
      }
#pragma unroll
      for (int u = 0; u < PER; ++u) dst[r * LD + c + u] = t[u];
    }
    return;
  }
  for (int e = threadIdx.x; e < NR * D; e += THREADS) {
    const int r = e / D, c = e % D;
    const T* src = row(r);
    dst[r * LD + c] = src ? to_float(src[c]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
row_da_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              long long sb, long long sh, long long ss, const T* __restrict__ posk,
              const T* __restrict__ posq, const int* __restrict__ mask, T* __restrict__ out,
              int H, int S, int S_pad, bool vec_qkv, bool vec_pos, float inv_scale) {
  extern __shared__ float sm[];
  const int LDS = S_pad + 4;
  float* Sc = sm;               // [R][LDS]  scores, then p
  float* Qs = Sc + R * LDS;     // [R][LD]
  float* Ks = Qs + R * LD;      // [KT][LD]  k tile, then v tile
  float* PW = Ks + KT * LD;     // [WIN][LD] relative rows of one table

  const int i0 = blockIdx.x * R, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const long long off = b * sb + h * sh;
  const T* qb = q + off;
  const T* kb = k + off;
  const T* vb = v + off;
  const int W = 2 * S - 1;
  const T* pk = posk + (size_t)h * W * D;
  const T* pq = posq + (size_t)h * W * D;
  const int* mb = mask + (size_t)b * S;

  // Rows of q, k or v (null beyond S), and rows of a relative table (null
  // outside it and for the window's pad row).
  const auto rows = [&](const T* x, int r0) {
    return [=](int r) -> const T* { return r0 + r < S ? x + (long long)(r0 + r) * ss : nullptr; };
  };
  const auto window = [&](const T* table, int base) {
    return [=](int w) -> const T* {
      const int m = base + w;
      return w < WIN - 1 && m >= 0 && m < W ? table + (size_t)m * D : nullptr;
    };
  };
  stage<R, T>(rows(qb, i0), vec_qkv, Qs);

  for (int j0 = 0; j0 < S; j0 += KT) {
    __syncthreads();  // the previous tile's readers are done
    stage<KT, T>(rows(kb, j0), vec_qkv, Ks);
    // Window row w holds relative row j0 - i0 + S - R + w: c2p's row of
    // (il, jl) is w = jl - il + R - 1.
    stage<WIN, T>(window(pk, j0 - i0 + S - R), vec_pos, PW);
    __syncthreads();

    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
    mm_abt<4, D, LD>(Qs, Ks, LD, tr, tc, acc);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) Sc[(tr * 4 + a) * LDS + j0 + tc + 16 * c] = acc[a][c];

    float win[4][8];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 8; ++c) win[a][c] = 0.f;
    mm_abt<8, D, LD>(Qs, PW, LD, tr, tc, win);
    __syncthreads();  // q.k stored, and every read of the c2p window done
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int il = tr * 4 + a;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int jl = tc + 16 * c + il - (R - 1);
        if (jl >= 0 && jl < KT) Sc[il * LDS + j0 + jl] += win[a][c];
      }
    }
    // Window row w now holds relative row i0 - j0 + S - KT + w: p2c's row of
    // (il, jl) is w = il - jl + KT - 1.
    stage<WIN, T>(window(pq, i0 - j0 + S - KT), vec_pos, PW);
    __syncthreads();

#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 8; ++c) win[a][c] = 0.f;
    mm_abt<8, D, LD>(Ks, PW, LD, tr, tc, win);  // rows: keys jl; columns: window rows
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int jl = tr * 4 + a, j = j0 + jl;
      const bool ok = j < S && mb[j] > 0;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int il = tc + 16 * c + jl - (KT - 1);
        if (il < 0 || il >= R) continue;
        float* cell = Sc + il * LDS + j;
        *cell = ok ? (*cell + win[a][c]) * inv_scale : -1e30f;
      }
    }
  }
  __syncthreads();

  // Exact softmax over each whole row: one warp per row.
  const int warp = tid >> 5, lane = tid & 31;
  for (int r = warp; r < R; r += THREADS / 32) {
    float* row = Sc + r * LDS;
    float m = -3.0e38f;
    for (int j = lane; j < S; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < S; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < S; j += 32) row[j] = round_to<T>(row[j] / sum);
  }

  float o[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[a][c] = 0.f;
  for (int j0 = 0; j0 < S; j0 += KT) {
    __syncthreads();  // softmax done / the previous v tile's readers are done
    stage<KT, T>(rows(vb, j0), vec_qkv, Ks);
    __syncthreads();
    const int n = min(KT, S - j0);
    for (int jl = 0; jl < n; ++jl) {
      float y[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) y[c] = Ks[jl * LD + tc + 16 * c];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float p = Sc[(tr * 4 + a) * LDS + j0 + jl];
#pragma unroll
        for (int c = 0; c < 4; ++c) o[a][c] = fmaf(p, y[c], o[a][c]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + tr * 4 + a;
    if (i >= S) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      out[(((size_t)b * S + i) * H + h) * D + tc + 16 * c] = from_float<T>(o[a][c]);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, long long sb, long long sh, long long ss,
           const void* posk, const void* posq, const void* mask, void* out, int B, int H, int S,
           float inv_scale, cudaStream_t stream) {
  static cudaError_t attr = allow_smem(row_da_kernel<T>, smem_bytes(MAX_S));
  if (attr != cudaSuccess) return (int)attr;
  const int S_pad = (S + KT - 1) / KT * KT;
  // 16-byte loads of rows need 16-byte aligned rows.
  constexpr long long PER = 16 / sizeof(T);
  const bool vec_qkv = sb % PER == 0 && sh % PER == 0 && ss % PER == 0 && (uintptr_t)q % 16 == 0 &&
                       (uintptr_t)k % 16 == 0 && (uintptr_t)v % 16 == 0;
  const bool vec_pos = (uintptr_t)posk % 16 == 0 && (uintptr_t)posq % 16 == 0;
  dim3 grid((S + R - 1) / R, H, B);
  row_da_kernel<T><<<grid, THREADS, smem_bytes(S_pad), stream>>>(
      (const T*)q, (const T*)k, (const T*)v, sb, sh, ss, (const T*)posk, (const T*)posq,
      (const int*)mask, (T*)out, H, S, S_pad, vec_qkv, vec_pos, inv_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/k/v: [B, H, S, 64] with element strides
// (sb, sh, ss) and a unit last stride; posk/posq: [H, 2S-1, 64] contiguous;
// mask: [B, S] int32; out: [B, S, H, 64] contiguous. 1 <= S <= 512.
extern "C" int gct_row_disentangled_attention(int dtype, const void* q, const void* k,
                                              const void* v, long long sb, long long sh,
                                              long long ss, const void* posk, const void* posq,
                                              const void* mask, void* out, int B, int H, int S,
                                              float inv_scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (S < 1 || S > MAX_S) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(q, k, v, sb, sh, ss, posk, posq, mask, out, B, H, S, inv_scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, sb, sh, ss, posk, posq, mask, out, B, H, S, inv_scale,
                                 st);
  return (int)cudaErrorInvalidValue;
}
