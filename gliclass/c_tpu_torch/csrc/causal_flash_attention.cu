// K5: causal grouped-query flash attention with key padding (decoder backbones).
//
// Replaces the TPU kernel gliclass/c_tpu/ops/causal_attention.py::_kernel
// (reached through _flash_call and causal_flash_attention).
//
//   s[i,j] = scale * q_i.k_j                    fp32
//   out_i  = softmax_j(s[i,:] over j <= i with mask[j] > 0) . v
//
// Query head h reads kv head h / g (the JAX package's q.reshape(B, nkv, g, S, d)
// grouping). Masked keys score -1e30 and contribute exactly 0, so a row with
// no valid key gives 0 (l == 0), as the plain version does.
//
// What bounds it on the H100: per (batch, query head) it reads q, k, v once
// and writes the context once, while it does about 2*S*S*d operations (q.k
// and P.v, halved by causality). At d = 128 and S >= 128 that is well above
// the card's ~295 operations per byte, so it is bound by arithmetic, and by
// how much of that arithmetic reaches an execution unit.
//
// What the design does about it: no [S, S] score tensor goes to device
// memory. One block owns one 64-row query tile of one (batch, query head) and
// loops over 64-key tiles only up to the diagonal (block-causal skip; the
// TPU kernel's grid steps above the diagonal become iterations that never
// run). Key j > i is masked inside the diagonal tile. A block per query head
// re-reads its kv head's K/V tiles through L2 (g blocks share them): one
// block over all g heads would need g*64*d fp32 of accumulator. Q, K^T and
// P^T are staged k-major in shared memory so that each thread reads its four
// rows and four columns as one 16-byte load each; every thread keeps a 4 x 4
// score tile and a 4 x (d/16) context tile in fp32 registers, with an fp32
// running max and sum per row. d is padded to 64 or 128 with zeros (any
// d <= 128 runs). The ragged edge (any S on the bucket ladder) is masked in
// the block. This first version runs the products as fp32 FMAs on CUDA cores;
// tensor cores (mma.sync / wgmma) are the next step.
//
// A query-row offset (sequence parallelism): q may hold only Sq rows, the
// absolute rows q_off .. q_off + Sq - 1 of the S keys. The causal cut is then
// j <= i + q_off, in the tile skip (key tiles up to the one holding the
// tile's last absolute row) and in the mask. A key tile wholly above a row
// adds exactly nothing to it (alpha = 1, p = 0), so every row equals the full
// launch's bit for bit.

#include "common.cuh"

namespace {

using namespace gct;

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int LDT = BQ + 4;   // k-major row stride (floats), 16-byte aligned
constexpr int THREADS = 256;  // 16 x 16 threads: 4 rows x 4 keys each

template <int DP>
constexpr int smem_floats() {
  return DP * LDT + DP * LDT + BK * DP + BK * LDT;  // Qt, Kt, Vs, Pt
}

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

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS)
causal_fa_kernel(const T* __restrict__ q, int qsb, int qsk, int qsg, int qss,
                 const T* __restrict__ k, int ksb, int ksh, int kss,
                 const T* __restrict__ v, int vsb, int vsh, int vss,
                 const int* __restrict__ mask, T* __restrict__ out, int nkv, int g,
                 int Sq, int S, int q_off, int d, float scale) {
  extern __shared__ __align__(16) float sm[];
  float* Qt = sm;               // [DP][LDT]  q tile, k-major: Qt[c][row]
  float* Kt = Qt + DP * LDT;    // [DP][LDT]  k tile, k-major: Kt[c][key]
  float* Vs = Kt + DP * LDT;    // [BK][DP]   v tile, row-major
  float* Pt = Vs + BK * DP;     // [BK][LDT]  probabilities, Pt[key][row]
  __shared__ int kok[BK];       // key valid (in range and unmasked)

  constexpr int NG = DP / 64;   // 64-wide column groups of the context
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int i0 = qt * BQ;
  const int kv = h / g, gi = h - kv * g;
  const int nh = nkv * g;
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const T* qb = q + (size_t)b * qsb + (size_t)kv * qsk + (size_t)gi * qsg;
  const T* kb = k + (size_t)b * ksb + (size_t)kv * ksh;
  const T* vb = v + (size_t)b * vsb + (size_t)kv * vsh;
  const int* mb = mask + (size_t)b * S;

  for (int e = tid; e < BQ * DP; e += THREADS) {
    const int r = e / DP, c = e % DP, i = i0 + r;
    Qt[c * LDT + r] = (i < Sq && c < d) ? to_float(qb[(size_t)i * qss + c]) : 0.f;
  }

  float o[4][4 * NG], m[4], l[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = -1e30f;
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NG; ++c) o[a][c] = 0.f;
  }

  // Key tiles up to the one holding the tile's last absolute row (at q_off =
  // 0, tile qt: BQ == BK, so it holds the diagonal and every later tile lies
  // wholly above it).
  const int t_last = min((i0 + q_off + BQ - 1) / BK, (S - 1) / BK);
  for (int t = 0; t <= t_last; ++t) {
    const int j0 = t * BK;
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < BK * DP; e += THREADS) {
      const int r = e / DP, c = e % DP, j = j0 + r;
      const bool in = j < S && c < d;
      Kt[c * LDT + r] = in ? to_float(kb[(size_t)j * kss + c]) : 0.f;
      Vs[r * DP + c] = in ? to_float(vb[(size_t)j * vss + c]) : 0.f;
    }
    if (tid < BK) kok[tid] = (j0 + tid < S) && mb[j0 + tid] > 0;
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = 0.f;
#pragma unroll 4
    for (int c = 0; c < DP; ++c) {
      const float4 qa = *reinterpret_cast<const float4*>(Qt + c * LDT + tr * 4);
      const float4 kk = *reinterpret_cast<const float4*>(Kt + c * LDT + tc * 4);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv4[4] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) s[a][cc] = fmaf(qv[a], kv4[cc], s[a][cc]);
    }

#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = i0 + tr * 4 + a + q_off;  // the absolute row
      bool ok[4];
      float mx = -1e30f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int jl = tc * 4 + c;
        ok[c] = kok[jl] && (j0 + jl <= i);
        s[a][c] = ok[c] ? s[a][c] * scale : -1e30f;
        mx = fmaxf(mx, s[a][c]);
      }
      const float m_new = fmaxf(m[a], group16_max(mx));
      const float alpha = expf(m[a] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = ok[c] ? expf(s[a][c] - m_new) : 0.f;
        sum += p;
        Pt[(tc * 4 + c) * LDT + tr * 4 + a] = round_to<T>(p);
      }
      l[a] = alpha * l[a] + group16_sum(sum);
      m[a] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * NG; ++c) o[a][c] *= alpha;
    }
    __syncthreads();

    const int jn = min(BK, S - j0);  // keys past S hold p = 0 and v = 0
#pragma unroll 2
    for (int j = 0; j < jn; ++j) {
      const float4 pa = *reinterpret_cast<const float4*>(Pt + j * LDT + tr * 4);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
      for (int gcol = 0; gcol < NG; ++gcol) {
        const float4 vv = *reinterpret_cast<const float4*>(Vs + j * DP + gcol * 64 + tc * 4);
        const float vf[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) o[a][gcol * 4 + c] = fmaf(pv[a], vf[c], o[a][gcol * 4 + c]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + tr * 4 + a;
    if (i >= Sq) continue;
    const float inv = l[a] > 0.f ? 1.f / l[a] : 0.f;
    T* orow = out + (((size_t)b * Sq + i) * nh + h) * d;
#pragma unroll
    for (int gcol = 0; gcol < NG; ++gcol)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = gcol * 64 + tc * 4 + c;
        if (col < d) orow[col] = from_float<T>(o[a][gcol * 4 + c] * inv);
      }
  }
}

struct Dims {
  int B, nkv, g, Sq, S, q_off, d;
};

template <typename T, int DP>
int launch(const void* q, const int* qs, const void* k, const int* ks, const void* v,
           const int* vs, const void* mask, void* out, Dims n, float scale, cudaStream_t stream) {
  constexpr int bytes = smem_floats<DP>() * 4;
  static cudaError_t attr = allow_smem(causal_fa_kernel<T, DP>, bytes);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((n.Sq + BQ - 1) / BQ, n.nkv * n.g, n.B);
  causal_fa_kernel<T, DP><<<grid, THREADS, bytes, stream>>>(
      (const T*)q, qs[0], qs[1], qs[2], qs[3], (const T*)k, ks[0], ks[1], ks[2], (const T*)v,
      vs[0], vs[1], vs[2], (const int*)mask, (T*)out, n.nkv, n.g, n.Sq, n.S, n.q_off, n.d, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const int* qs, const void* k, const int* ks, const void* v,
             const int* vs, const void* mask, void* out, Dims n, float scale, cudaStream_t st) {
  if (n.d <= 64) return launch<T, 64>(q, qs, k, ks, v, vs, mask, out, n, scale, st);
  return launch<T, 128>(q, qs, k, ks, v, vs, mask, out, n, scale, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q: [B, nkv, g, Sq, d] with element strides
// (qsb, qsk, qsg, qss), the query rows q_off .. q_off + Sq - 1; k, v: [B, nkv,
// S, d] with strides (sb, sh, ss); all with a unit last stride; mask: [B, S]
// int32; out: [B, Sq, nkv*g, d] contiguous. 1 <= d <= 128, 1 <= Sq, 0 <=
// q_off, q_off + Sq <= S.
extern "C" int gct_causal_flash_attention(int dtype, const void* q, int qsb, int qsk, int qsg,
                                          int qss, const void* k, int ksb, int ksh, int kss,
                                          const void* v, int vsb, int vsh, int vss,
                                          const void* mask, void* out, int B, int nkv, int g,
                                          int Sq, int S, int q_off, int d, float scale,
                                          void* stream) {
  if (d < 1 || d > 128 || Sq < 1 || q_off < 0 || q_off + Sq > S || B < 1 || nkv < 1 || g < 1)
    return (int)cudaErrorInvalidValue;
  const int qs[4] = {qsb, qsk, qsg, qss}, ks[3] = {ksb, ksh, kss}, vs[3] = {vsb, vsh, vss};
  const Dims n{B, nkv, g, Sq, S, q_off, d};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return dispatch<float>(q, qs, k, ks, v, vs, mask, out, n, scale, st);
  if (dtype == 1) return dispatch<__nv_bfloat16>(q, qs, k, ks, v, vs, mask, out, n, scale, st);
  return (int)cudaErrorInvalidValue;
}
