// K8, tensor-core variant: whole-row DeBERTa disentangled attention in bf16
// on mma.sync (content + c2p + p2c, exact softmax).
//
// Replaces the TPU kernel gliclass/c_tpu/ops/fused_attention.py::_kernel
// (reached through _fused_call and fused_disentangled_attention) for bf16
// q, k, v and tables; row_disentangled_attention.cu keeps every other type.
//
//   s[i, j] = (q_i.k_j + q_i.posk_rel[j-i+S-1] + k_j.posq_rel[i-j+S-1]) * (1 / scale)   fp32
//   s[i, j] = -1e30 where key j is masked
//   p       = exp(s - max_j s) / sum_j exp(s - max_j s), rounded to bf16
//   out_i   = sum_j p[i, j] v_j                                               fp32 sum
//
// What bounds it on the H100: at [B, h, S, d] = [128, 12, 512, 64] the
// function needs four S x S x d products per (batch, head), 206 GFLOP, 0.21 ms
// at the bf16 tensor-core peak, against 0.2 GB of q, k, v, out and tables.
// The kernel multiplies 232 GFLOP (the window products' tiles that overlap
// the band of their 64 x 64 score tile) and reads 40 KB of k and window rows
// per (row tile, key tile) from L2, 4 GB in all; with one block per SM the
// load latency and the barriers between its phases, not the tensor cores,
// set its time. The CUDA-core variant runs the same products as fp32 FMAs
// (16.6 ms).
//
// What the design does about it: one block owns R = 64 query rows of one
// (batch, head) and keeps their whole fp32 score rows in shared memory
// (64 x 516 x 4 = 129 KB at S = 512), so the softmax is exact in one pass, as
// in the TPU kernel. q, k, v and the 127 relative rows of each table that a
// (row tile, 64-key tile) pair touches are staged as bf16 (rows padded to 144
// bytes, so ldmatrix reads are free of bank conflicts) with cp.async 16-byte
// copies where the rows are 16-byte aligned, element loads otherwise; the
// k tile and both windows are double-buffered, so the next tile's copies run
// under this tile's products. All products run on mma.sync m16n8k16 (bf16
// in, fp32 accumulators); each of the 8 warps owns a 16-row strip and one
// half of the columns:
//   q.k   Q[64 x 64] . K[64 x 64]^T, stored into the score rows;
//   c2p   Q . Wk[128 x 64]^T, window column w of query row il added to key
//         jl = w + il - 63 straight from the accumulator registers;
//   p2c   K . Wq[128 x 64]^T, window column w of key jl added to query row
//         il = w + jl - 63, with the mask and 1/scale applied there.
// A 16-row strip s touches window columns 48 - 16s .. 126 - 16s only, so a
// warp multiplies 5 of the 16 n8 column tiles (10 per strip) instead of 8. A barrier separates the three passes, so each cell takes one term of
// each in the order (q.k + c2p) + p2c, with no atomics. The q strip stays in
// registers as A fragments for the whole key loop. Once the last tile's
// products are in registers, every v tile is copied in behind the softmax.
// The softmax (one warp per row, exp by ex2.approx, p = e * (1 / sum): the
// accurate expf and a division per element took 1.7 of 5.9 ms) writes p,
// normalised and rounded to bf16, over the fp32 row it came from; p.v reads
// it with ldmatrix and v with ldmatrix.trans into fp32 accumulators. The
// next step is wgmma with TMA loads (64-row warpgroup tiles fit the 64-row
// block) and a second block per SM from a smaller score buffer.
//
// Edges as the CUDA-core K8: any S <= 512, ragged last tiles (k and v rows
// beyond S are zero, their scores -1e30, their p zero), masked keys at -1e30,
// and a row with no valid key gives the mean of v over its S keys.

#include "rel_attention_tc.cuh"

namespace {

using namespace gct;
using namespace relatt;

constexpr int R = 64;        // query rows per block
constexpr int KT = 64;       // keys per tile
constexpr int BUF = (KT + 2 * WIN) * LDH;  // one stage buffer: k tile, c2p window, p2c window
constexpr int THREADS = 256;
constexpr int MAX_S = 512;

// Scores, two stage buffers (later every v tile), the key mask.
inline int smem_bytes(int S_pad) { return R * (S_pad + 4) * 4 + 2 * BUF * 2 + MAX_S * 4; }

__global__ void __launch_bounds__(THREADS, 1)
row_da_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                 long long sb, long long sh, long long ss, const bf16* __restrict__ posk,
                 const bf16* __restrict__ posq, const int* __restrict__ mask, bf16* __restrict__ out,
                 int H, int S, int S_pad, bool vec_qkv, bool vec_pos, float inv_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int LDS = S_pad + 4;
  float* Sc = reinterpret_cast<float*>(smem);           // [R][LDS] scores; then p as bf16
  bf16* Buf = reinterpret_cast<bf16*>(Sc + R * LDS);    // [2][BUF] stage buffers; then v tiles
  int* Ms = reinterpret_cast<int*>(Buf + 2 * BUF);      // [S_pad] key valid

  const int i0 = blockIdx.x * R, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int strip = warp & 3, m0 = strip * 16;  // the warp's 16-row strip (query rows; keys in p2c)
  const int side = warp >> 2;                   // which half of the columns the warp owns
  // Window columns of the strip: n8 tiles 6 - 2*strip .. 15 - 2*strip, five
  // to each side. The warp loads the three tile pairs from `base` and
  // multiplies the five local tiles it owns (side 0: 0..4, side 1: 1..5).
  const int base = 6 - 2 * strip + 4 * side;
  const auto own = [side](int nt) { return side ? nt >= 1 : nt <= 4; };
  const long long off = b * sb + h * sh;
  const bf16* qb = q + off;
  const bf16* kb = k + off;
  const bf16* vb = v + off;
  const int W = 2 * S - 1;
  const bf16* pk = posk + (size_t)h * W * D;
  const bf16* pq = posq + (size_t)h * W * D;
  const int* mb = mask + (size_t)b * S;

  // Rows of q, k or v (null beyond S), and rows of a relative table (null
  // outside it and for the window's pad row).
  const auto rows = [&](const bf16* x, int r0) {
    return [=](int r) -> const bf16* { return r0 + r < S ? x + (long long)(r0 + r) * ss : nullptr; };
  };
  const auto window = [&](const bf16* table, int base) {
    return [=](int w) -> const bf16* {
      const int m = base + w;
      return w < WIN - 1 && m >= 0 && m < W ? table + (size_t)m * D : nullptr;
    };
  };
  // Key tile j0: k rows; c2p window row w holds relative row j0 - i0 + S - R + w
  // (cell (il, jl) takes w = jl - il + R - 1); p2c window row w holds relative
  // row i0 - j0 + S - KT + w (cell (il, jl) takes w = il - jl + KT - 1).
  const auto stage_tile = [&](int j0, bf16* buf) {
    stage<KT, THREADS>(rows(kb, j0), vec_qkv, kb, buf);
    stage<WIN, THREADS>(window(pk, j0 - i0 + S - R), vec_pos, pk, buf + KT * LDH);
    stage<WIN, THREADS>(window(pq, i0 - j0 + S - KT), vec_pos, pq, buf + (KT + WIN) * LDH);
  };
  stage<R, THREADS>(rows(qb, i0), vec_qkv, qb, Buf + BUF);  // q waits in buffer 1 until it is in registers
  stage_tile(0, Buf);
  cp_async_commit();
  for (int j = threadIdx.x; j < S_pad; j += THREADS) Ms[j] = j < S && mb[j] > 0;
  cp_async_wait<0>();
  __syncthreads();

  uint32_t qa[4][4];  // the warp's q strip as A fragments, for every key tile
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) ldmatrix_x4(qa[ks], Buf + BUF + (m0 + (lane & 15)) * LDH + ks * 16 + (lane >> 4) * 8);
  __syncthreads();  // buffer 1 is free

  const int T = S_pad / KT;
  for (int tile = 0; tile < T; ++tile) {
    const int j0 = tile * KT;
    const bf16* Ks = Buf + (tile & 1) * BUF;
    const bf16* Wk = Ks + KT * LDH;
    const bf16* Wq = Wk + WIN * LDH;
    if (tile + 1 < T) stage_tile(j0 + KT, Buf + ((tile + 1) & 1) * BUF);
    cp_async_commit();

    float sqk[4][4] = {}, c2p[6][4] = {}, p2c[6][4] = {};
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t bb[4], ka[4];
#pragma unroll
      for (int np = 0; np < 2; ++np) {  // q.k: keys side*32 .. +32
        ld_b_pair(bb, Ks, side * 32 + np * 16, ks, lane);
        mma_bf16(sqk[2 * np], qa[ks], bb[0], bb[1]);
        mma_bf16(sqk[2 * np + 1], qa[ks], bb[2], bb[3]);
      }
      band_mma<3>(c2p, qa[ks], Wk, base, ks, lane, own);  // c2p: the warp's window column tiles
      ldmatrix_x4(ka, Ks + (m0 + (lane & 15)) * LDH + ks * 16 + (lane >> 4) * 8);
      band_mma<3>(p2c, ka, Wq, base, ks, lane, own);  // p2c: the k strip against the same column tiles
    }
    __syncthreads();  // every read of this tile's buffer done
    if (tile + 1 == T) {
      // Both buffers are free: every v tile streams in behind the softmax,
      // one copy group each.
      for (int tt = 0; tt < T; ++tt) {
        stage<KT, THREADS>(rows(vb, tt * KT), vec_qkv, vb, Buf + tt * KT * LDH);
        cp_async_commit();
      }
    }

    // q.k into the score rows (row m0 + g + 8*(i/2), key 2t + i%2 of the n8 tile).
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float2*>(Sc + (m0 + g + 8 * hh) * LDS + j0 + side * 32 + nt * 8 + 2 * t) =
            make_float2(sqk[nt][2 * hh], sqk[nt][2 * hh + 1]);
    __syncthreads();
    scatter_c2p<6>(c2p, m0, base, lane, own, [&](int il, int jl, float x) { Sc[il * LDS + j0 + jl] += x; });
    __syncthreads();
    scatter_p2c<6>(p2c, m0, base, lane, own, [&](int il, int jl, float x) {
      float* cell = Sc + il * LDS + j0 + jl;
      *cell = Ms[j0 + jl] != 0 ? (*cell + x) * inv_scale : -1e30f;
    });
    if (tile + 1 < T) cp_async_wait<0>();
    __syncthreads();  // the next tile's buffer has landed; this tile's scores are whole
  }

  // Exact softmax over each whole row, one warp per row; p (normalised,
  // rounded to bf16, zero beyond S) is written over the row it came from.
  for (int r = warp; r < R; r += THREADS / 32) {
    float* row = Sc + r * LDS;
    float e[MAX_S / 32];
    float m = -3.0e38f;
#pragma unroll
    for (int u = 0; u < MAX_S / 32; ++u) {
      const int j = lane + 32 * u;
      e[u] = j < S ? row[j] : -3.0e38f;
      m = fmaxf(m, e[u]);
    }
    m = warp_max(m);
    float sum = 0.f;
#pragma unroll
    for (int u = 0; u < MAX_S / 32; ++u) {
      e[u] = lane + 32 * u < S ? __expf(e[u] - m) : 0.f;
      sum += e[u];
    }
    const float inv = 1.f / warp_sum(sum);
    __syncwarp();  // every lane has read the row
    bf16* prow = reinterpret_cast<bf16*>(row);
#pragma unroll
    for (int u = 0; u < MAX_S / 32; ++u)
      if (lane + 32 * u < S_pad) prow[lane + 32 * u] = __float2bfloat16_rn(e[u] * inv);
  }

  // p.v: the warp's rows m0..m0+15, head dims side*32 .. +32.
  const bf16* P = reinterpret_cast<const bf16*>(Sc);
  const int LDP = 2 * LDS;
  float o[4][4] = {};
  for (int tile = 0; tile < T; ++tile) {
    cp_async_wait_n(T - 1 - tile);
    __syncthreads();  // v tile `tile` has landed (and, first, the softmax is done)
    const bf16* Vs = Buf + tile * KT * LDH;
    const int j0 = tile * KT;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t pa[4], bb[4];
      ldmatrix_x4(pa, P + (m0 + (lane & 15)) * LDP + j0 + ks * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        ldmatrix_x4_trans(bb, Vs + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDH + side * 32 + np * 16 +
                                  (lane >> 4) * 8);
        mma_bf16(o[2 * np], pa, bb[0], bb[1]);
        mma_bf16(o[2 * np + 1], pa, bb[2], bb[3]);
      }
    }
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = i0 + m0 + g + 8 * hh;
    if (i >= S) continue;
    bf16* orow = out + (((size_t)b * S + i) * H + h) * D + side * 32 + 2 * t;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(orow + nt * 8) = __floats2bfloat162_rn(o[nt][2 * hh], o[nt][2 * hh + 1]);
  }
}

}  // namespace

// bf16 only. q/k/v: [B, H, S, 64] with element strides (sb, sh, ss) and a unit
// last stride; posk/posq: [H, 2S-1, 64] contiguous; mask: [B, S] int32; out:
// [B, S, H, 64] contiguous. 1 <= S <= 512.
extern "C" int gct_row_disentangled_attention_tc(const void* q, const void* k, const void* v, long long sb,
                                                 long long sh, long long ss, const void* posk, const void* posq,
                                                 const void* mask, void* out, int B, int H, int S, float inv_scale,
                                                 void* stream) {
  if (S < 1 || S > MAX_S || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  static cudaError_t attr = allow_smem(row_da_tc_kernel, smem_bytes(MAX_S));
  if (attr != cudaSuccess) return (int)attr;
  const int S_pad = (S + KT - 1) / KT * KT;
  // cp.async copies of rows need 16-byte aligned rows.
  const bool vec_qkv = sb % 8 == 0 && sh % 8 == 0 && ss % 8 == 0 && (uintptr_t)q % 16 == 0 &&
                       (uintptr_t)k % 16 == 0 && (uintptr_t)v % 16 == 0;
  const bool vec_pos = (uintptr_t)posk % 16 == 0 && (uintptr_t)posq % 16 == 0;
  dim3 grid((S + R - 1) / R, H, B);
  row_da_tc_kernel<<<grid, THREADS, smem_bytes(S_pad), (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, sb, sh, ss, (const bf16*)posk, (const bf16*)posq,
      (const int*)mask, (bf16*)out, H, S, S_pad, vec_qkv, vec_pos, inv_scale);
  return (int)cudaGetLastError();
}
