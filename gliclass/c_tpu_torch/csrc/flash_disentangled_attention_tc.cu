// K1, tensor-core variant: blocked flash DeBERTa disentangled attention in
// bf16 on mma.sync (content + c2p + p2c, online softmax).
//
// Replaces the TPU kernel gliclass/c_tpu/ops/fused_attention.py::_flash_kernel
// (reached through _flash_call and flash_disentangled_attention) for bf16
// q, k, v and tables; flash_disentangled_attention.cu keeps fp32 (TF32 would
// round q and k and miss fp32's 1e-4) and the mixed types.
//
//   s[i, j] = ((q_i.k_j + q_i.posk_rel[j-i+S-1]) + k_j.posq_rel[i-j+S-1]) * (1 / scale)   fp32
//   s[i, j] = -1e30 where key j is masked
//   out_i   = sum_j bf16(exp(s - m)) v_j / sum_j exp(s - m)    (running max m, fp32 sums)
//
// What bounds it on the H100: per (batch, head) it reads q, k, v and the two
// [2S-1, 64] tables once and writes the context once; summed over the shapes
// chip_smoke.py times ([128, 56], [128, 128], [16, 512] at 12 heads) that is
// 0.0595 ms of bytes against 0.042 ms of bf16 operations (four S x S x 64
// products per head), so bytes bound it. At S <= 128 the 64-row tiles also
// multiply padding: at the 56 bucket (64/56)^2 = 1.31 times the products. The
// CUDA-core K1 ran all six products as fp32 FMAs on operands widened to fp32
// in shared memory (199 KB a block: one block of 8 warps per SM), with the
// window products through shared memory, four barriers per key tile and the
// accurate expf per element.
//
// What the design does about it: one block of 4 warps owns a 64-row query
// tile of one (batch, head); each warp owns a 16-row strip and keeps its q
// strip in registers as A fragments for the whole key loop. For each 64-key
// tile, the k tile and the 127 relative rows of each table that the (query
// tile, key tile) pair touches are staged as bf16 (rows padded to 144 bytes,
// so ldmatrix reads are free of bank conflicts) with cp.async 16-byte copies
// where the rows are 16-byte aligned, element loads otherwise. The v tile is
// copied in behind the score products and the next tile's k and windows
// behind the softmax, so each tile's copies overlap the other half of its
// work; q waits in the v buffer until it is in registers. All products run
// on mma.sync m16n8k16 (bf16 in, fp32 accumulators), through the helpers
// that K8′ shares (rel_attention_tc.cuh):
//   q.k   the warp's strip against the 64 keys, stored into its own rows of an
//         fp32 [64 x 72] score tile;
//   c2p   Q . Wk^T over the ten window column tiles of the strip's band,
//         window column w of row il added to key jl = w + il - 63 (the warp's
//         own rows: a warp-level sync only);
//   p2c   K . Wq^T over the same band, window column w of key jl added to
//         query row il = w + jl - 63 after a barrier, with the mask and
//         (1 / scale) * log2(e) applied there.
// Each cell thus takes its three terms in the order ((q.k + c2p) + p2c), with
// no atomics, in three barriers a key tile. Each warp then reads its own rows
// back in accumulator layout: the running max by quad shuffles, p = 2^(s - m)
// by ex2.approx, packed to bf16 A fragments straight from registers, O += P.v
// with v by ldmatrix.trans, the row sums per lane and one reciprocal per row
// at the end. A block takes 72 KB of shared memory and a thread 165
// registers (no spills): three blocks (12 warps) share an SM.
//
// A query-row offset (sequence parallelism), as the CUDA-core K1: q may hold
// only Sq rows, the absolute rows q_off .. q_off + Sq - 1 of the S keys, with
// strides of its own; the c2p/p2c windows follow the tile's absolute rows.
// Every row reads only its own scores, and a row's products, sums and
// rounding do not depend on where in a tile it sits, so its result is the
// full launch's bit for bit.
//
// Edges as the CUDA-core K1: any S, ragged last tiles (q, k, v rows and
// window rows outside the tables are zero), masked keys at a finite -1e30 (a
// key tile wholly masked at the start of a row gives 2^0 = 1 terms that the
// first valid tile rescales by 2^(-1e30 - m) = 0). Keys past S are -inf and
// weigh exactly 0, so a row with no valid key gives the mean of v over its S
// keys, as the plain version does.

#include <math.h>

#include "rel_attention_tc.cuh"

namespace {

using namespace gct;
using namespace relatt;

constexpr int R = 64;         // query rows per block
constexpr int KT = 64;        // keys per tile
constexpr int THREADS = 128;  // 4 warps, one 16-row strip each
constexpr int LDS = KT + 8;   // fp32 score rows: fragment-layout float2 accesses free of bank conflicts
constexpr int SMEM = R * LDS * 4 + (2 * KT + 2 * WIN) * LDH * 2;  // scores; k, c2p and p2c windows, v
constexpr float LOG2E = 1.4426950408889634f;

__global__ void __launch_bounds__(THREADS, 3)
flash_da_tc_kernel(const bf16* __restrict__ q, long long qsb, long long qsh, long long qss,
                   const bf16* __restrict__ k, const bf16* __restrict__ v, long long sb, long long sh, long long ss,
                   const bf16* __restrict__ posk, const bf16* __restrict__ posq, const int* __restrict__ mask,
                   bf16* __restrict__ out, int H, int Sq, int S, int q_off, bool vec_qkv, bool vec_pos,
                   float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Sc = reinterpret_cast<float*>(smem);        // [R][LDS] scores of this key tile, in log2 units
  bf16* Ks = reinterpret_cast<bf16*>(Sc + R * LDS);  // [KT][LDH] k tile
  bf16* Wk = Ks + KT * LDH;                          // [WIN][LDH] c2p window
  bf16* Wq = Wk + WIN * LDH;                         // [WIN][LDH] p2c window
  bf16* Vs = Wq + WIN * LDH;                         // [KT][LDH] v tile; the q tile before tile 0's v

  const int i0 = blockIdx.x * R, h = blockIdx.y, b = blockIdx.z;
  const int a0 = i0 + q_off;  // the tile's first absolute query row
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int m0 = warp * 16;  // the warp's strip: query rows in q.k and c2p, keys in p2c
  const int base = band_base(warp);
  const auto all = [](int) { return true; };
  const long long off = b * sb + h * sh;
  const bf16* qb = q + b * qsb + h * qsh;
  const bf16* kb = k + off;
  const bf16* vb = v + off;
  const int W = 2 * S - 1;
  const bf16* pk = posk + (size_t)h * W * D;
  const bf16* pq = posq + (size_t)h * W * D;
  const int* mb = mask + (size_t)b * S;

  // Rows of k or v (null beyond S), of q (null beyond Sq), and rows of a
  // relative table (null outside it and for the window's pad row).
  const auto rows = [&](const bf16* x, int r0) {
    return [=](int r) -> const bf16* { return r0 + r < S ? x + (long long)(r0 + r) * ss : nullptr; };
  };
  const auto q_rows = [&](int r) -> const bf16* { return i0 + r < Sq ? qb + (long long)(i0 + r) * qss : nullptr; };
  const auto window = [&](const bf16* table, int first) {
    return [=](int w) -> const bf16* {
      const int m = first + w;
      return w < WIN - 1 && m >= 0 && m < W ? table + (size_t)m * D : nullptr;
    };
  };
  const auto stage_kw = [&](int j0) {
    stage<KT, THREADS>(rows(kb, j0), vec_qkv, kb, Ks);
    stage<WIN, THREADS>(window(pk, j0 - a0 + S - R), vec_pos, pk, Wk);
    stage<WIN, THREADS>(window(pq, a0 - j0 + S - KT), vec_pos, pq, Wq);
  };
  stage<R, THREADS>(q_rows, vec_qkv, qb, Vs);
  stage_kw(0);
  cp_async_commit();

  uint32_t qa[4][4];  // the warp's q strip as A fragments, for every key tile
  float o[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  // Rows g (index 0) and g + 8 (index 1) of the strip: running max (log2
  // units) and this lane's part of the running sum.
  float m_run[2] = {-1e30f, -1e30f}, l_run[2] = {0.f, 0.f};

  const int T = (S + KT - 1) / KT;
  for (int tile = 0; tile < T; ++tile) {
    const int j0 = tile * KT;
    // The keys whose cells this lane finishes in the p2c pass (m0 + g and
    // m0 + g + 8): 1 valid, 0 masked, -1 past S.
    int key[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int j = j0 + m0 + g + 8 * hh;
      key[hh] = j < S ? (mb[j] > 0) : -1;
    }
    cp_async_wait<0>();
    __syncthreads();  // k and windows of this tile have landed; every read of the last tile's scores and v is done
    if (tile == 0) {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) ldmatrix_x4(qa[ks], Vs + (m0 + (lane & 15)) * LDH + ks * 16 + (lane >> 4) * 8);
      __syncthreads();  // every warp holds its q fragments: the v tile may overwrite the q tile
    }
    stage<KT, THREADS>(rows(vb, j0), vec_qkv, vb, Vs);
    cp_async_commit();

    {  // q.k into the warp's own score rows (row m0 + g + 8 hh, key 8 nt + 2t, +1)
      float s[8][4] = {};
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bb[4];
          ld_b_pair(bb, Ks, np * 16, ks, lane);
          mma_bf16(s[2 * np], qa[ks], bb[0], bb[1]);
          mma_bf16(s[2 * np + 1], qa[ks], bb[2], bb[3]);
        }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *reinterpret_cast<float2*>(Sc + (m0 + g + 8 * hh) * LDS + nt * 8 + 2 * t) =
              make_float2(s[nt][2 * hh], s[nt][2 * hh + 1]);
    }
    {  // c2p onto the same rows
      float c[10][4] = {};
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) band_mma<5>(c, qa[ks], Wk, base, ks, lane, all);
      __syncwarp();
      scatter_c2p<10>(c, m0, base, lane, all, [&](int il, int jl, float x) { Sc[il * LDS + jl] += x; });
    }
    float p2c[10][4] = {};  // the k strip against the p2c window
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t ka[4];
      ldmatrix_x4(ka, Ks + (m0 + (lane & 15)) * LDH + ks * 16 + (lane >> 4) * 8);
      band_mma<5>(p2c, ka, Wq, base, ks, lane, all);
    }
    __syncthreads();  // every warp's q.k + c2p is in; every read of k and the windows is done
    if (tile + 1 < T) stage_kw(j0 + KT);
    cp_async_commit();
    scatter_p2c<10>(p2c, m0, base, lane, all, [&](int il, int jl, float x) {
      float* cell = Sc + il * LDS + jl;
      const int kv = jl - m0 < 8 ? key[0] : key[1];
      *cell = kv > 0 ? (*cell + x) * scale_log2 : kv == 0 ? -1e30f : -INFINITY;
    });
    cp_async_wait<1>();  // this thread's v copies (the next tile's k and windows may still be in flight)
    __syncthreads();     // every p2c term and every v row of this tile is in

    // Online softmax over the warp's rows, p packed to bf16 A fragments of P.v:
    // k-step kk takes key tiles 2kk (a[0], a[1]) and 2kk + 1 (a[2], a[3]).
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float2 x = *reinterpret_cast<const float2*>(Sc + (m0 + g + 8 * hh) * LDS + nt * 8 + 2 * t);
        s[nt][2 * hh] = x.x, s[nt][2 * hh + 1] = x.y;
      }
    float mu[2], alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * hh], s[nt][2 * hh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mu[hh] = fmaxf(m_run[hh], mx);
      alpha[hh] = ex2(m_run[hh] - mu[hh]);
      m_run[hh] = mu[hh];
    }
    uint32_t pf[4][4];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float p0 = ex2(s[nt][0] - mu[0]), p1 = ex2(s[nt][1] - mu[0]);
      const float p2 = ex2(s[nt][2] - mu[1]), p3 = ex2(s[nt][3] - mu[1]);
      rs[0] += p0 + p1;
      rs[1] += p2 + p3;
      pf[nt >> 1][(nt & 1) * 2] = pack_bf16(p0, p1);
      pf[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l_run[hh] = alpha[hh] * l_run[hh] + rs[hh];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      o[nt][0] *= alpha[0], o[nt][1] *= alpha[0];
      o[nt][2] *= alpha[1], o[nt][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, Vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDH + np * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * np], pf[kk], vf[0], vf[1]);
        mma_bf16(o[2 * np + 1], pf[kk], vf[2], vf[3]);
      }
  }

  // The row sums over the quad and one reciprocal per row; the context
  // rounded to bf16 into [B, Sq, H, 64].
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float l = l_run[hh];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / l;
    const int i = i0 + m0 + g + 8 * hh;
    if (i >= Sq) continue;
    bf16* orow = out + (((size_t)b * Sq + i) * H + h) * D + 2 * t;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(orow + nt * 8) =
          __floats2bfloat162_rn(o[nt][2 * hh] * inv, o[nt][2 * hh + 1] * inv);
  }
}

}  // namespace

// bf16 only. q: [B, H, Sq, 64] with element strides (qsb, qsh, qss), the
// query rows q_off .. q_off + Sq - 1; k/v: [B, H, S, 64] with element strides
// (sb, sh, ss); all with a unit last stride; posk/posq: [H, 2S-1, 64]
// contiguous; mask: [B, S] int32; out: [B, Sq, H, 64] contiguous. 1 <= Sq,
// 0 <= q_off, q_off + Sq <= S, at most 65,535 query tiles.
extern "C" int gct_flash_disentangled_attention_tc(const void* q, long long qsb, long long qsh, long long qss,
                                                   const void* k, const void* v, long long sb, long long sh,
                                                   long long ss, const void* posk, const void* posq,
                                                   const void* mask, void* out, int B, int H, int Sq, int S,
                                                   int q_off, float inv_scale, void* stream) {
  if (Sq < 1 || q_off < 0 || q_off + Sq > S || B < 1 || H < 1 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  static cudaError_t attr = allow_smem(flash_da_tc_kernel, SMEM);
  if (attr != cudaSuccess) return (int)attr;
  // cp.async copies of rows need 16-byte aligned rows.
  const bool vec_qkv = sb % 8 == 0 && sh % 8 == 0 && ss % 8 == 0 && qsb % 8 == 0 && qsh % 8 == 0 &&
                       qss % 8 == 0 && (uintptr_t)q % 16 == 0 && (uintptr_t)k % 16 == 0 &&
                       (uintptr_t)v % 16 == 0;
  const bool vec_pos = (uintptr_t)posk % 16 == 0 && (uintptr_t)posq % 16 == 0;
  dim3 grid((Sq + R - 1) / R, H, B);
  flash_da_tc_kernel<<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(
      (const bf16*)q, qsb, qsh, qss, (const bf16*)k, (const bf16*)v, sb, sh, ss, (const bf16*)posk,
      (const bf16*)posq, (const int*)mask, (bf16*)out, H, Sq, S, q_off, vec_qkv, vec_pos, inv_scale * LOG2E);
  return (int)cudaGetLastError();
}
