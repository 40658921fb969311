// K7, tensor-core variant: softmax attention over precomputed c2p/p2c biases
// (DeBERTa's bias route) with bf16 q, k, v and biases, on mma.sync.
//
// Replaces the TPU kernel gliclass/c_tpu/ops/fused_attention.py::_bias_kernel
// (reached through _bias_fused_call, bias_fused_attention and
// table_bias_attention) for bf16 q/k/v and bf16 biases, the serve path's
// types; bias_fused_attention.cu keeps fp32 and mixed types.
//
//   s[i, j] = ((q_i . k_j + c2p[i, j]) + p2c[i, j]) * (1 / scale)   in fp32
//   s[i, j] = -1e30 where key j is masked
//   p       = exp(s - max_j s) / sum_j exp(s - max_j s), rounded to bf16
//   out_i   = sum_j p[i, j] v_j                                     fp32 sum
//
// What bounds it on the H100: at [B, h, S, d] = [128, 12, 512, 64] the two
// bf16 [B, h, S, S] biases are 1.61 GB of the 2.01 GB the function must move,
// 0.60 ms at 3.35 TB/s, against 103 GFLOP of q.k and p.v (0.10 ms on bf16
// tensor cores). So bytes bound it: the design keeps bias copies in flight and
// takes the products and the softmax off the critical path.
//
// What the design does about it: one block of 8 warps owns R query rows of one
// (batch, head), R = 32 up to S = 512 and 16 above (S <= 2048), and keeps their
// whole fp32 score rows in shared memory (32 x 516 x 4 = 66 KB at S = 512), so
// the softmax is exact over the row in one pass, as in the TPU kernel. With
// the two stage buffers and the key mask a block takes 104.5 KB at S = 512, so
// two blocks share an SM and one streams biases while the other runs its
// softmax and p.v. The key loop steps by 64 keys; each step's k tile and c2p
// and p2c tiles are copied by cp.async 16-byte copies along whichever of
// (i, j) is contiguous in memory, into a tile laid out the same way ([row][key]
// for c2p and [key][row] for p2c in the route's [h, S, B, S] products), while
// the previous step's products run: one barrier a step. The kernel takes all
// four strides of each bias, so neither needs a transpose copy; other strides
// or alignments fall back to element loads. Each warp keeps its 16-row q strip
// in registers as A fragments for the whole key loop and runs q.k for its 16
// (R = 32) or 8 (R = 16) keys of the step on mma.sync m16n8k16 (bf16 in, fp32
// accumulators); it adds c2p, p2c, the scale and the mask to the accumulator
// registers from the staged tiles (padded so the reads are free of bank
// conflicts) and writes finished scores, in the order (q.k + c2p) + p2c, so no
// cell is visited twice. The softmax (one warp per row, exp by ex2.approx, one
// reciprocal per row, as K8's tensor-core variant) writes p, normalised and
// rounded to bf16, over the fp32 row it came from, while the first v tile is
// copied in; p.v reads p with ldmatrix and v with ldmatrix.trans, v tiles
// double-buffered.
//
// Edges as the CUDA-core K7: any S <= 2048, ragged last tiles (k, v and bias
// elements beyond S are zero, their scores -1e30 and their p zero), masked
// keys at -1e30, and a row with no valid key gives the mean of v over its S
// keys. Query rows beyond S are not written.

#include "common.cuh"
#include "mma.cuh"

namespace {

using namespace gct;
using bf16 = __nv_bfloat16;

constexpr int D = 64;         // head dim
constexpr int KT = 64;        // keys per step
constexpr int LDH = D + 8;    // bf16 q/k/v rows: 144 bytes, ldmatrix conflict-free
constexpr int LDC = KT + 8;   // [row][key] bias tile rows
constexpr int THREADS = 256;

template <int R> struct Geo {
  static constexpr int LDT = R + 8;                                       // [key][row] bias tile rows
  static constexpr int BIAS = R * LDC > KT * LDT ? R * LDC : KT * LDT;    // one bias tile, either layout
  static constexpr int STAGE = KT * LDH + 2 * BIAS;                       // k (or v) tile, c2p, p2c
  static constexpr int WPS = 8 / (R / 16);                                // warps per 16-row strip
  static constexpr int NT = KT / WPS / 8;                                 // n8 key tiles a warp in q.k
  static constexpr int DT = D / WPS / 8;                                  // n8 head-dim tiles a warp in p.v
  static constexpr int MAX_S = R == 32 ? 512 : 2048;
  static_assert(R * LDH <= STAGE && (NT == 1 || NT == 2) && NT == DT, "unsupported row count");
};

template <int R> inline int smem_bytes(int S_pad) {
  return R * (S_pad + 4) * 4 + 2 * Geo<R>::STAGE * 2 + S_pad * 4;
}

// dst[r][c] = x[(r0 + r) * ss + c] for r < NR, c < D, zero beyond S: cp.async
// 16-byte copies when the rows are 16-byte aligned (vec), else element loads.
template <int NR>
__device__ __forceinline__ void stage_rows(const bf16* x, long long ss, int r0, int S, bool vec, bf16* dst) {
  if (vec) {
    for (int e = threadIdx.x; e < NR * (D / 8); e += THREADS) {
      const int r = e / (D / 8), c = (e % (D / 8)) * 8;
      const bool ok = r0 + r < S;
      cp_async16(dst + r * LDH + c, ok ? x + (long long)(r0 + r) * ss + c : x, ok);
    }
    return;
  }
  for (int e = threadIdx.x; e < NR * D; e += THREADS) {
    const int r = e / D, c = e % D;
    dst[r * LDH + c] = r0 + r < S ? x[(long long)(r0 + r) * ss + c] : __float2bfloat16(0.f);
  }
}

// The (rows i0 .. i0+R-1, keys j0 .. j0+KT-1) tile of a bias whose (i, j) lies
// at b[i * si + j * sj], zero beyond S, into dst laid out [key][row] (rows
// LDT apart) when `col`, else [row][key] (rows LDC apart). vec: 16-byte
// copies along the contiguous axis (j when !col, i when col).
template <int R>
__device__ __forceinline__ void stage_bias(const bf16* b, long long si, long long sj, int i0, int j0, int S,
                                           bool col, bool vec, bf16* dst) {
  constexpr int LDT = Geo<R>::LDT;
  if (vec && !col) {
    for (int e = threadIdx.x; e < R * (KT / 8); e += THREADS) {
      const int r = e / (KT / 8), c = (e % (KT / 8)) * 8, i = i0 + r, j = j0 + c;
      const bool ok = i < S && j < S;
      cp_async16(dst + r * LDC + c, ok ? b + i * si + j : b, ok);
    }
  } else if (vec) {
    for (int e = threadIdx.x; e < KT * (R / 8); e += THREADS) {
      const int jl = e / (R / 8), c = (e % (R / 8)) * 8, i = i0 + c, j = j0 + jl;
      const bool ok = i < S && j < S;
      cp_async16(dst + jl * LDT + c, ok ? b + i + j * sj : b, ok);
    }
  } else {
    for (int e = threadIdx.x; e < R * KT; e += THREADS) {
      const int r = col ? e % R : e / KT, jl = col ? e / R : e % KT, i = i0 + r, j = j0 + jl;
      dst[col ? jl * LDT + r : r * LDC + jl] = i < S && j < S ? b[i * si + j * sj] : __float2bfloat16(0.f);
    }
  }
}

// Bias values at (row il, keys jl and jl + 1) of a staged tile.
template <int R>
__device__ __forceinline__ float2 bias_pair(const bf16* tile, bool col, int il, int jl) {
  if (col)
    return make_float2(__bfloat162float(tile[jl * Geo<R>::LDT + il]),
                       __bfloat162float(tile[(jl + 1) * Geo<R>::LDT + il]));
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(tile + il * LDC + jl));
}

template <int R>
__global__ void __launch_bounds__(THREADS, R == 32 ? 2 : 1)
bias_attn_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                    long long sb, long long sh, long long ss,
                    const bf16* __restrict__ c2p, long long cb, long long ch, long long ci, long long cj,
                    const bf16* __restrict__ p2c, long long pb, long long ph, long long pi, long long pj,
                    const int* __restrict__ mask, bf16* __restrict__ out, int H, int S, int S_pad,
                    bool vec_qkv, bool c_col, bool c_vec, bool p_col, bool p_vec, float inv_scale) {
  using G = Geo<R>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int LDS = S_pad + 4;
  float* Sc = reinterpret_cast<float*>(smem);           // [R][LDS] scores; then p as bf16
  bf16* Buf = reinterpret_cast<bf16*>(Sc + R * LDS);    // [2][STAGE] stage buffers; later v tiles
  int* Ms = reinterpret_cast<int*>(Buf + 2 * G::STAGE); // [S_pad] key valid

  const int i0 = blockIdx.x * R, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int m0 = (warp / G::WPS) * 16;  // the warp's 16-row strip
  const int part = warp % G::WPS;       // its keys (q.k) and head dims (p.v): NT * 8 of each
  const long long off = b * sb + h * sh;
  const bf16* qb = q + off;
  const bf16* kb = k + off;
  const bf16* vb = v + off;
  const bf16* cbase = c2p + b * cb + h * ch;
  const bf16* pbase = p2c + b * pb + h * ph;
  const int* mb = mask + (size_t)b * S;

  const auto stage_tile = [&](int j0, bf16* buf) {
    stage_rows<KT>(kb, ss, j0, S, vec_qkv, buf);
    stage_bias<R>(cbase, ci, cj, i0, j0, S, c_col, c_vec, buf + KT * LDH);
    stage_bias<R>(pbase, pi, pj, i0, j0, S, p_col, p_vec, buf + KT * LDH + G::BIAS);
  };
  stage_rows<R>(qb, ss, i0, S, vec_qkv, Buf + G::STAGE);  // q waits in buffer 1 until it is in registers
  stage_tile(0, Buf);
  cp_async_commit();
  for (int j = threadIdx.x; j < S_pad; j += THREADS) Ms[j] = j < S && mb[j] > 0;
  cp_async_wait<0>();
  __syncthreads();

  uint32_t qa[4][4];  // the warp's q strip as A fragments, for every key step
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    ldmatrix_x4(qa[ks], Buf + G::STAGE + (m0 + (lane & 15)) * LDH + ks * 16 + (lane >> 4) * 8);
  __syncthreads();  // buffer 1 is free

  const int T = S_pad / KT;
  const int kw = part * G::NT * 8;  // the warp's first key (q.k) and head dim (p.v) in a step
  for (int tile = 0; tile < T; ++tile) {
    const int j0 = tile * KT;
    const bf16* Ks = Buf + (tile & 1) * G::STAGE;
    const bf16* Cs = Ks + KT * LDH;
    const bf16* Ps = Cs + G::BIAS;
    bf16* next = Buf + ((tile + 1) & 1) * G::STAGE;
    if (tile + 1 < T)
      stage_tile(j0 + KT, next);
    else
      stage_rows<KT>(vb, ss, 0, S, vec_qkv, next);  // the first v tile comes in behind the softmax
    cp_async_commit();

    float sc[G::NT][4] = {};
    if constexpr (G::NT == 2) {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t bb[4];  // keys kw .. kw + 15, dims ks*16 .. +16
        ldmatrix_x4(bb, Ks + (kw + (lane & 7) + ((lane >> 4) << 3)) * LDH + ks * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(sc[0], qa[ks], bb[0], bb[1]);
        mma_bf16(sc[1], qa[ks], bb[2], bb[3]);
      }
    } else {
#pragma unroll
      for (int k2 = 0; k2 < 2; ++k2) {
        uint32_t bb[4];  // keys kw .. kw + 7, dims k2*32 .. +32
        ldmatrix_x4(bb, Ks + (kw + (lane & 7)) * LDH + k2 * 32 + (lane >> 3) * 8);
        mma_bf16(sc[0], qa[2 * k2], bb[0], bb[1]);
        mma_bf16(sc[0], qa[2 * k2 + 1], bb[2], bb[3]);
      }
    }
    // Finished scores of rows m0 + g (+8), keys kw + nt*8 + 2t (+1).
#pragma unroll
    for (int nt = 0; nt < G::NT; ++nt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int il = m0 + g + 8 * hh, jl = kw + nt * 8 + 2 * t;
        const float2 cv = bias_pair<R>(Cs, c_col, il, jl), pv = bias_pair<R>(Ps, p_col, il, jl);
        const float s0 = ((sc[nt][2 * hh] + cv.x) + pv.x) * inv_scale;
        const float s1 = ((sc[nt][2 * hh + 1] + cv.y) + pv.y) * inv_scale;
        *reinterpret_cast<float2*>(Sc + il * LDS + j0 + jl) =
            make_float2(Ms[j0 + jl] ? s0 : -1e30f, Ms[j0 + jl + 1] ? s1 : -1e30f);
      }
    if (tile + 1 < T) cp_async_wait<0>();
    __syncthreads();  // the next step's tiles have landed; this step's buffer is free
  }

  // Exact softmax over each whole row, one warp per row; p (normalised,
  // rounded to bf16, zero beyond S) is written over the row it came from.
  constexpr int U = G::MAX_S / 32;
  for (int r = warp; r < R; r += THREADS / 32) {
    float* row = Sc + r * LDS;
    float e[U];
    float m = -3.0e38f;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = lane + 32 * u;
      e[u] = j < S ? row[j] : -3.0e38f;
      m = fmaxf(m, e[u]);
    }
    m = warp_max(m);
    float sum = 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      e[u] = lane + 32 * u < S ? __expf(e[u] - m) : 0.f;
      sum += e[u];
    }
    const float inv = 1.f / warp_sum(sum);
    __syncwarp();  // every lane has read the row
    bf16* prow = reinterpret_cast<bf16*>(row);
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (lane + 32 * u < S_pad) prow[lane + 32 * u] = __float2bfloat16_rn(e[u] * inv);
  }

  // p.v: rows m0 .. m0+15, head dims kw .. kw + NT*8; v tile tt in buffer (T + tt) & 1.
  const bf16* P = reinterpret_cast<const bf16*>(Sc);
  const int LDP = 2 * LDS;
  float o[G::DT][4] = {};
  for (int tt = 0; tt < T; ++tt) {
    cp_async_wait<0>();
    __syncthreads();  // v tile tt has landed (first: the softmax is done); tile tt-1's buffer is free
    if (tt + 1 < T) stage_rows<KT>(vb, ss, (tt + 1) * KT, S, vec_qkv, Buf + ((T + tt + 1) & 1) * G::STAGE);
    cp_async_commit();
    const bf16* Vs = Buf + ((T + tt) & 1) * G::STAGE;
    const int j0 = tt * KT;
    if constexpr (G::DT == 2) {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t pa[4], bb[4];
        ldmatrix_x4(pa, P + (m0 + (lane & 15)) * LDP + j0 + ks * 16 + (lane >> 4) * 8);
        ldmatrix_x4_trans(bb, Vs + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDH + kw + (lane >> 4) * 8);
        mma_bf16(o[0], pa, bb[0], bb[1]);
        mma_bf16(o[1], pa, bb[2], bb[3]);
      }
    } else {
#pragma unroll
      for (int k2 = 0; k2 < 2; ++k2) {
        uint32_t pa0[4], pa1[4], bb[4];  // keys k2*32 .. +32, head dims kw .. kw + 7
        ldmatrix_x4(pa0, P + (m0 + (lane & 15)) * LDP + j0 + k2 * 32 + (lane >> 4) * 8);
        ldmatrix_x4(pa1, P + (m0 + (lane & 15)) * LDP + j0 + k2 * 32 + 16 + (lane >> 4) * 8);
        ldmatrix_x4_trans(bb, Vs + (k2 * 32 + lane) * LDH + kw);
        mma_bf16(o[0], pa0, bb[0], bb[1]);
        mma_bf16(o[0], pa1, bb[2], bb[3]);
      }
    }
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = i0 + m0 + g + 8 * hh;
    if (i >= S) continue;
    bf16* orow = out + (((size_t)b * S + i) * H + h) * D + kw + 2 * t;
#pragma unroll
    for (int dt = 0; dt < G::DT; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(orow + dt * 8) = __floats2bfloat162_rn(o[dt][2 * hh], o[dt][2 * hh + 1]);
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

// 16-byte copies of a bias along its contiguous axis need that axis at unit
// stride, every other stride a multiple of 8 elements, an aligned base and
// S % 8 == 0 (so a copy lies wholly inside or outside the S x S block).
bool bias_vec(const void* p, long long b, long long h, long long along, long long across, int S) {
  return along == 1 && across % 8 == 0 && b % 8 == 0 && h % 8 == 0 && S % 8 == 0 && (uintptr_t)p % 16 == 0;
}

template <int R>
int launch_r(const Args& a, cudaStream_t stream) {
  static cudaError_t attr = allow_smem(bias_attn_tc_kernel<R>, smem_bytes<R>(Geo<R>::MAX_S));
  if (attr != cudaSuccess) return (int)attr;
  const int S_pad = (a.S + KT - 1) / KT * KT;
  const bool vec_qkv = a.sb % 8 == 0 && a.sh % 8 == 0 && a.ss % 8 == 0 && (uintptr_t)a.q % 16 == 0 &&
                       (uintptr_t)a.k % 16 == 0 && (uintptr_t)a.v % 16 == 0;
  // Each bias is staged along j when j has unit stride, else along i when i has.
  const bool c_col = a.cj != 1 && a.ci == 1, p_col = a.pj != 1 && a.pi == 1;
  const bool c_vec = c_col ? bias_vec(a.c2p, a.cb, a.ch, a.ci, a.cj, a.S) : bias_vec(a.c2p, a.cb, a.ch, a.cj, a.ci, a.S);
  const bool p_vec = p_col ? bias_vec(a.p2c, a.pb, a.ph, a.pi, a.pj, a.S) : bias_vec(a.p2c, a.pb, a.ph, a.pj, a.pi, a.S);
  dim3 grid((a.S + R - 1) / R, a.H, a.B);
  bias_attn_tc_kernel<R><<<grid, THREADS, smem_bytes<R>(S_pad), stream>>>(
      (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v, a.sb, a.sh, a.ss, (const bf16*)a.c2p, a.cb, a.ch,
      a.ci, a.cj, (const bf16*)a.p2c, a.pb, a.ph, a.pi, a.pj, (const int*)a.mask, (bf16*)a.out, a.H, a.S,
      S_pad, vec_qkv, c_col, c_vec, p_col, p_vec, a.inv_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 only. q/k/v: [B, H, S, 64] with element strides (sb, sh, ss) and a unit
// last stride; c2p/p2c: [B, H, S, S] with element strides (b, h, i, j) each;
// mask: [B, S] int32; out: [B, S, H, 64] contiguous. 1 <= S <= 2048.
extern "C" int gct_bias_fused_attention_tc(const void* q, const void* k, const void* v, long long sb,
                                           long long sh, long long ss, const void* c2p, long long cb,
                                           long long ch, long long ci, long long cj, const void* p2c,
                                           long long pb, long long ph, long long pi, long long pj,
                                           const void* mask, void* out, int B, int H, int S, float inv_scale,
                                           void* stream) {
  if (S < 1 || S > 2048 || B < 1 || H < 1 || B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, sb, sh, ss, c2p, cb, ch, ci, cj, p2c, pb, ph, pi, pj, mask, out, B, H, S, inv_scale};
  cudaStream_t st = (cudaStream_t)stream;
  return S <= 512 ? launch_r<32>(a, st) : launch_r<16>(a, st);
}
