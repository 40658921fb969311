// K7: softmax attention over precomputed c2p/p2c biases (DeBERTa's bias route).
//
// Replaces the TPU kernel gliclass/c_tpu/ops/fused_attention.py::_bias_kernel
// (reached through _bias_fused_call, bias_fused_attention and
// table_bias_attention):
//
//   s[i, j] = (q_i . k_j + c2p[i, j] + p2c[i, j]) * (1 / scale)   in fp32
//   s[i, j] = -1e30 where key j is masked
//   p       = exp(s - max_j s) / sum_j exp(s - max_j s), rounded to v's type
//   out_i   = sum_j p[i, j] v_j                                    fp32 sum
//
// What bounds it on the H100: at [B, h, S, d] = [128, 12, 512, 64] with bf16
// biases it must move 1.81 GB (the two [B, h, S, S] biases dominate): 0.54 ms
// at 3.35 TB/s, against 103 GFLOP of q.k and p.v (0.10 ms on bf16 tensor
// cores). So bytes bound it, and the design's first job is to read each bias
// element once, in full sectors.
//
// What the design does about it: one block owns R query rows of one (batch,
// head) and keeps their whole score rows in shared memory as fp32 (R * S * 4
// bytes, 128 KB at most: R = 64 up to S = 512, 32 up to 1024, 16 up to 2048),
// so the softmax is exact over the row in one pass, as in the TPU kernel, and
// no score goes back to device memory. The key loop stages each tile of c2p
// and p2c through shared memory with the loads running along whichever of
// (i, j) is contiguous in memory: the route's products leave c2p contiguous
// in j ([h, S_i, B, S_j]) and p2c contiguous in i ([h, S_j, B, S_i]), and the
// kernel takes all four strides of each, so neither needs a transpose copy.
// q.k and p.v run as fp32 FMAs on CUDA cores from shared memory, each thread
// owning a 4 x 4 register tile (K1's scheme); tensor cores are later work.
//
// Numerics follow the TPU kernel: fp32 scores and statistics, the three terms
// summed in the order (q.k + c2p) + p2c before the scale, p normalised by a
// division and rounded to v's type before p.v. Masked keys get exp(-1e30 - m)
// = 0 exactly. A row whose keys are all masked has m = -1e30 and gives the
// plain mean of v over its S keys, in the TPU kernel and the plain version
// alike; the engine never builds such a row (key 0 is always valid). Query
// rows beyond S are not written.

#include "common.cuh"

namespace {

using namespace gct;

constexpr int D = 64;       // head dim
constexpr int LD = D + 1;   // padded shared-memory row (floats)
constexpr int THREADS = 256;

// Thread layout for R query rows: TR groups of 4 rows by TC groups of
// columns; a key tile is 4 * TC keys wide; each thread owns NCO of the 64
// output columns in p.v.
template <int R> struct Geo {
  static constexpr int TR = R / 4;
  static constexpr int TC = THREADS / TR;
  static constexpr int KT = 4 * TC;
  static constexpr int NCO = D / TC;
  static_assert(TR * TC == THREADS && NCO >= 1, "unsupported row count");
};

template <int R> inline int smem_floats(int S_pad) {
  using G = Geo<R>;
  return R * LD + G::KT * LD + G::KT * (R + 1) + R * (S_pad + 4);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Stage tile[r][jl] (r < R, jl < KT) of a bias whose element (i, j) lies at
// b[i * si + j * sj]; the store goes to dst[r * ld_r + jl * ld_j]. Loads run
// along j when sj == 1, else along i.
template <int R, int KT, typename TB>
__device__ __forceinline__ void stage_bias(const TB* __restrict__ b, long long si, long long sj,
                                           int i0, int j0, int S, float* dst, int ld_r,
                                           int ld_j) {
  if (sj == 1) {
    for (int e = threadIdx.x; e < R * KT; e += THREADS) {
      const int r = e / KT, jl = e % KT, i = i0 + r, j = j0 + jl;
      dst[r * ld_r + jl * ld_j] = (i < S && j < S) ? to_float(b[i * si + j]) : 0.f;
    }
  } else {
    for (int e = threadIdx.x; e < R * KT; e += THREADS) {
      const int jl = e / R, r = e % R, i = i0 + r, j = j0 + jl;
      dst[r * ld_r + jl * ld_j] = (i < S && j < S) ? to_float(b[i * si + j * sj]) : 0.f;
    }
  }
}

template <typename T, typename TB, int R>
__global__ void __launch_bounds__(THREADS)
bias_attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 long long sb, long long sh, long long ss,
                 const TB* __restrict__ c2p, long long cb, long long ch, long long ci, long long cj,
                 const TB* __restrict__ p2c, long long pb, long long ph, long long pi, long long pj,
                 const int* __restrict__ mask, T* __restrict__ out, int H, int S, int S_pad,
                 float inv_scale) {
  using G = Geo<R>;
  constexpr int KT = G::KT, TC = G::TC;
  extern __shared__ float sm[];
  float* Qs = sm;                 // [R][LD]
  float* KV = Qs + R * LD;        // [KT][LD]   k tile, then v tile
  float* Pt = KV + KT * LD;       // [KT][R+1]  p2c tile, transposed
  float* Sc = Pt + KT * (R + 1);  // [R][LDS]   c2p, then scores, then p
  const int LDS = S_pad + 4;

  const int i0 = blockIdx.x * R, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tr = tid / TC, tc = tid % TC;
  const long long off = b * sb + h * sh;
  const T* qb = q + off;
  const T* kb = k + off;
  const T* vb = v + off;
  const TB* cbase = c2p + b * cb + h * ch;
  const TB* pbase = p2c + b * pb + h * ph;
  const int* mb = mask + (size_t)b * S;

  for (int e = tid; e < R * D; e += THREADS) {
    const int r = e / D, c = e % D, i = i0 + r;
    Qs[r * LD + c] = i < S ? to_float(qb[(long long)i * ss + c]) : 0.f;
  }

  for (int j0 = 0; j0 < S; j0 += KT) {
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < KT * D; e += THREADS) {
      const int r = e / D, c = e % D, j = j0 + r;
      KV[r * LD + c] = j < S ? to_float(kb[(long long)j * ss + c]) : 0.f;
    }
    stage_bias<R, KT>(cbase, ci, cj, i0, j0, S, Sc + j0, LDS, 1);
    stage_bias<R, KT>(pbase, pi, pj, i0, j0, S, Pt, 1, R + 1);
    __syncthreads();

    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < D; ++kk) {
      float x[4], y[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) x[a] = Qs[(tr * 4 + a) * LD + kk];
#pragma unroll
      for (int c = 0; c < 4; ++c) y[c] = KV[(tc + TC * c) * LD + kk];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(x[a], y[c], acc[a][c]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int il = tr * 4 + a;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int jl = tc + TC * c, j = j0 + jl;
        float* cell = Sc + il * LDS + j0 + jl;
        const float s = ((acc[a][c] + *cell) + Pt[jl * (R + 1) + il]) * inv_scale;
        *cell = (j < S && mb[j] > 0) ? s : -1e30f;
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

  float o[4][G::NCO];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < G::NCO; ++c) o[a][c] = 0.f;
  for (int j0 = 0; j0 < S; j0 += KT) {
    __syncthreads();  // softmax done / the previous v tile's readers are done
    for (int e = tid; e < KT * D; e += THREADS) {
      const int r = e / D, c = e % D, j = j0 + r;
      KV[r * LD + c] = j < S ? to_float(vb[(long long)j * ss + c]) : 0.f;
    }
    __syncthreads();
    const int n = min(KT, S - j0);
    for (int jl = 0; jl < n; ++jl) {
      float y[G::NCO];
#pragma unroll
      for (int c = 0; c < G::NCO; ++c) y[c] = KV[jl * LD + tc + TC * c];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float p = Sc[(tr * 4 + a) * LDS + j0 + jl];
#pragma unroll
        for (int c = 0; c < G::NCO; ++c) o[a][c] = fmaf(p, y[c], o[a][c]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + tr * 4 + a;
    if (i >= S) continue;
#pragma unroll
    for (int c = 0; c < G::NCO; ++c)
      out[(((size_t)b * S + i) * H + h) * D + tc + TC * c] = from_float<T>(o[a][c]);
  }
}

struct Args {
  const void *q, *k, *v;
  long long sb, sh, ss;
  const void* c2p;
  long long cb, ch, ci, cj;
  const void* p2c;
  long long pb, ph, pi, pj;
  const void* mask;
  void* out;
  int B, H, S;
  float inv_scale;
};

template <typename T, typename TB, int R>
int launch_r(const Args& a, cudaStream_t stream) {
  using G = Geo<R>;
  const int S_pad = (a.S + G::KT - 1) / G::KT * G::KT;
  const int bytes = smem_floats<R>(S_pad) * (int)sizeof(float);
  // Opt in once to the largest size this instantiation is launched with.
  static cudaError_t attr = allow_smem(bias_attn_kernel<T, TB, R>, smem_floats<R>(64 * 512 / R) * 4);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((a.S + R - 1) / R, a.H, a.B);
  bias_attn_kernel<T, TB, R><<<grid, THREADS, bytes, stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, a.sb, a.sh, a.ss, (const TB*)a.c2p, a.cb, a.ch,
      a.ci, a.cj, (const TB*)a.p2c, a.pb, a.ph, a.pi, a.pj, (const int*)a.mask, (T*)a.out, a.H,
      a.S, S_pad, a.inv_scale);
  return (int)cudaGetLastError();
}

template <typename T, typename TB>
int launch(const Args& a, cudaStream_t stream) {
  if (a.S <= 512) return launch_r<T, TB, 64>(a, stream);
  if (a.S <= 1024) return launch_r<T, TB, 32>(a, stream);
  if (a.S <= 2048) return launch_r<T, TB, 16>(a, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype / bias_dtype: 0 = float32, 1 = bfloat16. q/k/v: [B, H, S, 64] with
// element strides (sb, sh, ss) and a unit last stride; c2p/p2c: [B, H, S, S]
// with element strides (b, h, i, j) each; mask: [B, S] int32; out:
// [B, S, H, 64] contiguous. S <= 2048.
extern "C" int gct_bias_fused_attention(int dtype, int bias_dtype, const void* q, const void* k,
                                        const void* v, long long sb, long long sh, long long ss,
                                        const void* c2p, long long cb, long long ch, long long ci,
                                        long long cj, const void* p2c, long long pb, long long ph,
                                        long long pi, long long pj, const void* mask, void* out,
                                        int B, int H, int S, float inv_scale, void* stream) {
  const Args a{q, k, v, sb, sh, ss, c2p, cb, ch, ci, cj, p2c, pb, ph, pi, pj, mask, out,
               B, H, S, inv_scale};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0 && bias_dtype == 0) return launch<float, float>(a, st);
  if (dtype == 0 && bias_dtype == 1) return launch<float, __nv_bfloat16>(a, st);
  if (dtype == 1 && bias_dtype == 0) return launch<__nv_bfloat16, float>(a, st);
  if (dtype == 1 && bias_dtype == 1) return launch<__nv_bfloat16, __nv_bfloat16>(a, st);
  return (int)cudaErrorInvalidValue;
}
