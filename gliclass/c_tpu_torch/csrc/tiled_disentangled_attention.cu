// K10: flash DeBERTa attention over windowed absolute position tables (the tiled route).
//
// Replaces the TPU kernel gliclass/c_tpu/ops/fused_attention.py::_tiled_kernel
// (reached through _tiled_call and tiled_bias_attention):
//
//   c2p[b, i, j] = sum_e q[b, i, e] * twc[w = jb - ib + n - 1, e, i mod blk, j mod blk]
//   p2c[b, i, j] = sum_e k[b, j, e] * twq[w = ib - jb + n - 1, e, j mod blk, i mod blk]
//   s[b, i, j]   = (q_i.k_j + c2p + p2c) * (1 / scale), -1e30 where key j is masked
//   out_i        = online softmax over key tiles, fp32 running max and sum,
//                  exp(s - m) rounded to v's type before p.v, divided by the
//                  sum at the end (1 where the sum is 0)
//
// with (ib, jb) = (i, j) / blk and n = S / blk; the tables come from K9 in the
// layout [h, w, x, y, e] (e innermost). The TPU grid runs the batch innermost
// so that a [d, blk, blk] table tile stays in VMEM while every batch row
// passes.
//
// What bounds it on the H100: at [B, h, S, d] = [128, 12, 512, 64] it does
// four S x S x d products per (batch, head) (q.k, the two table
// contractions, p.v), 206 GFLOP, 0.21 ms on bf16 tensor cores, against 0.3 GB
// of q, k, v, out and the two tables (0.09 ms at 3.35 TB/s): operations.
// The table contraction is batched over the pair (i, j) (each pair has its
// own d-vector), so its rows are batch rows; that is why it starved the
// TPU's MXU, and CUDA cores with fp32 FMAs, as here, do not mind.
//
// What the design does about it: one block owns a 16-row query tile of one
// head for a group of G = 8 batch rows, and walks the key tiles of 32 with the
// online softmax, so each table vector read serves 8 batch rows (the TPU
// grid's batch-innermost reuse). A [d, blk, blk] table tile holds 128 KB in
// bf16 at blk = 32, so the two do not fit in shared memory together, and a
// block needs only the vectors of its own (row, key) pairs anyway. Each
// thread owns one key (its lane) and two query rows (warp, warp + 8); each
// warp stages the two tables' vectors of its 64 pairs 16 elements of d at a
// time in its own slice of shared memory (16-byte loads, neighbouring lanes
// on one table row, so every sector read is used whole), and reads them back
// one pair per lane. q and k of the group sit in shared memory as fp32
// (float4 reads: q broadcast, k one row per lane), staged with 16-byte loads
// where the rows are aligned: with one block per SM, element-wise staging
// leaves every warp waiting on load latency between its barriers. Blocks of one
// (head, query tile) are launched next to each other, so the tables they
// share stay in L2. The kernel's tile (16 x 32) is independent of the
// tables' blk: a pair finds its table entry by index arithmetic, and any blk
// that divides S is taken. S must be a multiple of 32.

#include "common.cuh"

namespace {

using namespace gct;

constexpr int D = 64;         // head dim
constexpr int BQ = 16;        // query rows per block
constexpr int BK = 32;        // keys per tile: one per lane
constexpr int G = 8;          // batch rows per block
constexpr int NA = BQ / 8;    // query rows per thread (warp, warp + 8)
constexpr int LDR = D + 4;    // q/k/v shared rows: float4-aligned, conflict-free across lanes
constexpr int LDP = BK + 4;
constexpr int EQ = 16;        // table elements (of d) staged at a time
constexpr int LDT = EQ + 4;   // staged table rows: float4 reads conflict-free across lanes
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int TS_WARP = NA * 2 * BK * LDT;  // one warp's staged table rows (floats)
constexpr int SMEM_BYTES = (G * BQ * LDR + G * BK * LDR + G * BQ * LDP + WARPS * TS_WARP) * 4;

__device__ __forceinline__ float dot4(const float4 a, const float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// The 16 bytes at src as floats into dst (16-byte aligned), in float4 stores.
template <typename T>
__device__ __forceinline__ void stage16(const T* src, float* dst) {
  float t[16 / sizeof(T)];
  load16(src, t);
#pragma unroll
  for (int i = 0; i < 16 / (int)sizeof(T); i += 4)
    *reinterpret_cast<float4*>(dst + i) = make_float4(t[i], t[i + 1], t[i + 2], t[i + 3]);
}

// Stage rows [r0, r0 + NR) of q, k or v for the block's G batch rows as fp32
// into dst[g][r][LDR] (zeros for batch rows beyond B), in 16-byte loads when
// the rows allow (vec), else element by element.
template <int NR, typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ x, long long sb, long long sh,
                                           long long ss, int b0, int B, int h, int r0, bool vec,
                                           float* dst) {
  if (vec) {
    constexpr int PER = 16 / sizeof(T);
    for (int e = threadIdx.x; e < G * NR * D / PER; e += THREADS) {
      const int g = e / (NR * D / PER), r = (e / (D / PER)) % NR, c = (e % (D / PER)) * PER, b = b0 + g;
      float* d = dst + (g * NR + r) * LDR + c;
      if (b < B) {
        stage16(x + b * sb + h * sh + (long long)(r0 + r) * ss + c, d);
      } else {
#pragma unroll
        for (int t = 0; t < PER; ++t) d[t] = 0.f;
      }
    }
    return;
  }
  for (int e = threadIdx.x; e < G * NR * D; e += THREADS) {
    const int g = e / (NR * D), r = (e / D) % NR, c = e % D, b = b0 + g;
    dst[(g * NR + r) * LDR + c] =
        b < B ? to_float(x[b * sb + h * sh + (long long)(r0 + r) * ss + c]) : 0.f;
  }
}

template <typename T, typename TT>
__global__ void __launch_bounds__(THREADS)
tiled_da_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                long long sb, long long sh, long long ss, const TT* __restrict__ twc,
                const TT* __restrict__ twq, const int* __restrict__ mask, T* __restrict__ out,
                int B, int H, int S, int blk, bool vec, float inv_scale) {
  extern __shared__ float sm[];
  float* Qs = sm;                    // [G][BQ][LDR]
  float* KV = Qs + G * BQ * LDR;     // [G][BK][LDR] k tile, then v tile
  float* Ps = KV + G * BK * LDR;     // [G][BQ][LDP] this tile's probabilities
  float* TS = Ps + G * BQ * LDP + (threadIdx.x >> 5) * TS_WARP;  // this warp's [NA][2][BK][LDT]

  const int b0 = blockIdx.x * G, i0 = blockIdx.y * BQ, h = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = S / blk, n_win = 2 * n - 1;
  const size_t win = (size_t)blk * blk * D;  // elements of one window
  const TT* tc_h = twc + (size_t)h * n_win * win;
  const TT* tq_h = twq + (size_t)h * n_win * win;

  stage_rows<BQ>(q, sb, sh, ss, b0, B, h, i0, vec, Qs);

  int xr[NA], ib[NA], xi[NA];
#pragma unroll
  for (int a = 0; a < NA; ++a) {
    xr[a] = warp + 8 * a;
    ib[a] = (i0 + xr[a]) / blk;
    xi[a] = (i0 + xr[a]) % blk;
  }
  float m[G][NA], l[G][NA], acc[G][NA][2];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      m[g][a] = -1e30f;
      l[g][a] = 0.f;
      acc[g][a][0] = acc[g][a][1] = 0.f;
    }

  for (int j0 = 0; j0 < S; j0 += BK) {
    __syncthreads();  // the previous tile's p.v readers are done
    stage_rows<BK>(k, sb, sh, ss, b0, B, h, j0, vec, KV);
    __syncthreads();

    const int j = j0 + lane;
    float sqk[G][NA], sc[G][NA], sp[G][NA];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int a = 0; a < NA; ++a) sqk[g][a] = sc[g][a] = sp[g][a] = 0.f;
    for (int e0 = 0; e0 < D; e0 += EQ) {
      // The warp stages elements [e0, e0 + EQ) of the table vectors of its
      // (row, key) pairs: 16-byte loads, neighbouring lanes on the same
      // table row, so each sector read is used whole.
      __syncwarp();
      constexpr int PER = 16 / sizeof(TT);  // elements in 16 bytes
      constexpr int CPR = EQ / PER;         // 16-byte pieces per staged row
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        for (int c = lane; c < BK * CPR; c += 32) {
          const int y = c / CPR, part = c % CPR, jj = j0 + y, jb = jj / blk, yj = jj % blk;
          const TT* src_c = tc_h + (size_t)(jb - ib[a] + n - 1) * win + ((size_t)xi[a] * blk + yj) * D;
          const TT* src_q = tq_h + (size_t)(ib[a] - jb + n - 1) * win + ((size_t)yj * blk + xi[a]) * D;
          stage16(src_c + e0 + part * PER, TS + ((a * 2 + 0) * BK + y) * LDT + part * PER);
          stage16(src_q + e0 + part * PER, TS + ((a * 2 + 1) * BK + y) * LDT + part * PER);
        }
      }
      __syncwarp();
#pragma unroll
      for (int e = 0; e < EQ; e += 4) {
        float4 tc[NA], tq[NA];
#pragma unroll
        for (int a = 0; a < NA; ++a) {
          tc[a] = *reinterpret_cast<const float4*>(&TS[((a * 2 + 0) * BK + lane) * LDT + e]);
          tq[a] = *reinterpret_cast<const float4*>(&TS[((a * 2 + 1) * BK + lane) * LDT + e]);
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float4 kk = *reinterpret_cast<const float4*>(&KV[(g * BK + lane) * LDR + e0 + e]);
#pragma unroll
          for (int a = 0; a < NA; ++a) {
            const float4 qq = *reinterpret_cast<const float4*>(&Qs[(g * BQ + xr[a]) * LDR + e0 + e]);
            sqk[g][a] = dot4(qq, kk, sqk[g][a]);
            sc[g][a] = dot4(qq, tc[a], sc[g][a]);
            sp[g][a] = dot4(kk, tq[a], sp[g][a]);
          }
        }
      }
    }

    // Online softmax: a row's 32 scores of this tile lie across the warp.
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const bool ok = b0 + g >= B || mask[(size_t)(b0 + g) * S + j] > 0;
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        const float s = ok ? ((sqk[g][a] + sc[g][a]) + sp[g][a]) * inv_scale : -1e30f;
        const float m_new = fmaxf(m[g][a], warp_max(s));
        const float alpha = expf(m[g][a] - m_new);
        const float p = expf(s - m_new);
        l[g][a] = alpha * l[g][a] + warp_sum(p);
        m[g][a] = m_new;
        acc[g][a][0] *= alpha;
        acc[g][a][1] *= alpha;
        Ps[(g * BQ + xr[a]) * LDP + lane] = round_to<T>(p);
      }
    }
    __syncthreads();  // every read of the k tile done; p stored
    stage_rows<BK>(v, sb, sh, ss, b0, B, h, j0, vec, KV);
    __syncthreads();

#pragma unroll
    for (int g = 0; g < G; ++g) {
      for (int y = 0; y < BK; y += 4) {
        float p[NA][4];
#pragma unroll
        for (int a = 0; a < NA; ++a) {
          const float4 p4 = *reinterpret_cast<const float4*>(&Ps[(g * BQ + xr[a]) * LDP + y]);
          p[a][0] = p4.x, p[a][1] = p4.y, p[a][2] = p4.z, p[a][3] = p4.w;
        }
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float v0 = KV[(g * BK + y + t) * LDR + lane];
          const float v1 = KV[(g * BK + y + t) * LDR + lane + 32];
#pragma unroll
          for (int a = 0; a < NA; ++a) {
            acc[g][a][0] = fmaf(p[a][t], v0, acc[g][a][0]);
            acc[g][a][1] = fmaf(p[a][t], v1, acc[g][a][1]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int b = b0 + g;
    if (b >= B) continue;
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      const float l_inv = l[g][a] == 0.f ? 1.f : 1.f / l[g][a];
      T* o = out + (((size_t)b * S + i0 + xr[a]) * H + h) * D;
      o[lane] = from_float<T>(acc[g][a][0] * l_inv);
      o[lane + 32] = from_float<T>(acc[g][a][1] * l_inv);
    }
  }
}

struct Args {
  const void *q, *k, *v;
  long long sb, sh, ss;
  const void *twc, *twq, *mask;
  void* out;
  int B, H, S, blk;
  float inv_scale;
};

template <typename T, typename TT>
int launch(const Args& a, cudaStream_t stream) {
  static cudaError_t attr = allow_smem(tiled_da_kernel<T, TT>, SMEM_BYTES);
  if (attr != cudaSuccess) return (int)attr;
  // 16-byte loads of q/k/v rows need 16-byte aligned rows.
  constexpr long long PER = 16 / sizeof(T);
  const bool vec = a.sb % PER == 0 && a.sh % PER == 0 && a.ss % PER == 0 &&
                   (uintptr_t)a.q % 16 == 0 && (uintptr_t)a.k % 16 == 0 && (uintptr_t)a.v % 16 == 0;
  dim3 grid((a.B + G - 1) / G, a.S / BQ, a.H);  // batch groups of one (head, query tile) adjacent
  tiled_da_kernel<T, TT><<<grid, THREADS, SMEM_BYTES, stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, a.sb, a.sh, a.ss, (const TT*)a.twc,
      (const TT*)a.twq, (const int*)a.mask, (T*)a.out, a.B, a.H, a.S, a.blk, vec, a.inv_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype / table_dtype: 0 = float32, 1 = bfloat16. q/k/v: [B, H, S, 64] with
// element strides (sb, sh, ss) and a unit last stride; twc/twq:
// [H, 2S/blk - 1, blk, blk, 64] contiguous, 16-byte aligned; mask: [B, S]
// int32; out: [B, S, H, 64] contiguous. S a multiple of 32, blk dividing S.
extern "C" int gct_tiled_disentangled_attention(int dtype, int table_dtype, const void* q,
                                                const void* k, const void* v, long long sb,
                                                long long sh, long long ss, const void* twc,
                                                const void* twq, const void* mask, void* out,
                                                int B, int H, int S, int blk, float inv_scale,
                                                void* stream) {
  if (S < BK || S % BK || blk < 1 || S % blk || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, sb, sh, ss, twc, twq, mask, out, B, H, S, blk, inv_scale};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0 && table_dtype == 0) return launch<float, float>(a, st);
  if (dtype == 0 && table_dtype == 1) return launch<float, __nv_bfloat16>(a, st);
  if (dtype == 1 && table_dtype == 0) return launch<__nv_bfloat16, float>(a, st);
  if (dtype == 1 && table_dtype == 1) return launch<__nv_bfloat16, __nv_bfloat16>(a, st);
  return (int)cudaErrorInvalidValue;
}
