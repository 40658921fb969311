// K10, tensor-core variant: flash DeBERTa attention over windowed absolute
// position tables (the tiled route), bf16 q/k/v and tables on mma.sync.
//
// Replaces the TPU kernel gliclass/c_tpu/ops/fused_attention.py::_tiled_kernel
// (reached through _tiled_call and tiled_bias_attention) when q, k, v and the
// tables are all bf16; tiled_disentangled_attention.cu keeps every other
// combination of types.
//
//   c2p[b, i, j] = sum_e q[b, i, e] * twc[w = jb - ib + n - 1, i mod blk, j mod blk, e]
//   p2c[b, i, j] = sum_e k[b, j, e] * twq[w = ib - jb + n - 1, j mod blk, i mod blk, e]
//   s[b, i, j]   = ((q_i.k_j + c2p) + p2c) * (1 / scale), -1e30 where key j is masked
//   out_i        = online softmax over key tiles, fp32 running max and sum,
//                  exp(s - m) rounded to bf16 before p.v, divided by the sum
//                  at the end (1 where the sum is 0)
//
// with (ib, jb) = (i, j) / blk and n = S / blk; the tables come from K9 in the
// layout [h, w, x, y, e] (e innermost).
//
// What bounds it on the H100: at [B, h, S, d] = [128, 12, 512, 64] the four
// products (q.k, the two table contractions, p.v) are 206 GFLOP, 0.21 ms at
// the bf16 tensor-core peak, against 0.3 GB of q, k, v, out and the two
// tables in device memory. A table vector belongs to one (query row, key)
// pair and serves only the batch rows of its block, so the tables are read
// from L2 once per group of batch rows: with 16 rows a group, 6.4 GB at
// [128, 512], plus k and v once per 16-row query tile (6.4 GB). L2 traffic
// and its latency bound it, not operations. The CUDA-core variant (8 rows
// a group, fp32 FMAs, two warp shuffle trees per row and key tile) took
// 19.0 ms; a first tensor-core version that loaded every operand from L2
// straight into registers took 7.5 ms, its warps waiting on chains of loads.
//
// What the design does about it: one block owns a 16-row query tile of one
// head for G = 16 batch rows and walks key tiles of 16. With the batch rows
// as the N dimension, both table contractions are plain m16n8k16 products:
// c2p for query row x is twc[w, x, y0:y0+16, :] (16 keys x 64) times
// q[b0:b0+16, x, :]; p2c for key y is twq[w', y, x0:x0+16, :] (16 query rows
// x 64) times k[b0:b0+16, y, :]. q.k and p.v are m16n8 tiles per batch row.
// Every operand is staged in shared memory with cp.async 16-byte copies
// (element loads for q/k/v rows that are not 16-byte aligned) and read with
// ldmatrix (.trans for v): per key tile 32 KB each of k, v and the two table
// slices. Rows are 144 bytes apart and each batch row's block of rows 16
// bytes more, so the reads down a batch column (c2p's q, p2c's k) are free of
// bank conflicts like those down a row. Table rows are addressed one by
// one, so any blk dividing S is taken (a 16-row slice may cross a table
// block at blk = 8). Copies overlap compute: the next tile's c2p slice is
// copied once c2p is done, its k and p2c slice once p2c is done, and its v
// under the next tile's score phases. The three score terms arrive in three
// fragment layouts; each is added into one shared fp32 score tile [G, 16, 16]
// in its own phase between barriers (the mask and 1/scale with the last).
// One lane owns one (batch row, query row) for the online softmax (exp by
// ex2.approx), so no shuffle tree is needed; it writes p as bf16 and the
// rescale factor to shared memory, and each warp runs p.v for its two batch
// rows. 212 KB of shared memory: one block per SM. Blocks of one (head, query
// tile) are launched next to each other, so the tables they share stay in
// L2. The next step is wgmma with TMA loads of the table slabs (at blk = 32
// each (w, x) slab of a key tile is one contiguous run) and a larger query
// tile to cut the k and v traffic. S must be a multiple of 32.

#include "common.cuh"
#include "mma.cuh"

namespace {

using namespace gct;
using bf16 = __nv_bfloat16;

constexpr int D = 64;               // head dim
constexpr int BQ = 16;              // query rows per block
constexpr int BK = 16;              // keys per tile
constexpr int G = 16;               // batch rows per block (two n8 tiles)
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int LDH = D + 8;          // bf16 shared rows: 144 bytes
constexpr int GS = 16 * LDH + 8;    // elements between batch rows of q, k, v (16 rows each)
constexpr int LSX = BK + 1;         // score tile: floats between query rows
constexpr int LSG = BQ * LSX + 4;   // floats between batch rows (276: the fragment adds spread over banks)
constexpr int LDP = BK + 8;         // p rows (bf16): 48 bytes
constexpr int QKV_ELEMS = G * GS;   // q, k or v tile
constexpr int TAB_ELEMS = BQ * BK * LDH;
constexpr int SMEM_BYTES = (3 * QKV_ELEMS + 2 * TAB_ELEMS) * 2 + G * LSG * 4 + G * BQ * LDP * 2 + G * BQ * 4 +
                           G * BK * 4 + 2 * BQ * 4;

// B fragments of two n8 tiles at k-step ks: rows n = 0..15 of a [n][k] tile
// whose row n starts at base + n * stride.
__device__ __forceinline__ void ld_b_pair(uint32_t r[4], const bf16* base, int stride, int ks, int lane) {
  ldmatrix_x4(r, base + ((lane & 7) + ((lane >> 4) << 3)) * stride + ks * 16 + ((lane >> 3) & 1) * 8);
}

// A fragments at k-step ks of a [16][k] tile with rows LDH apart.
__device__ __forceinline__ void ld_a(uint32_t r[4], const bf16* base, int ks, int lane) {
  ldmatrix_x4(r, base + (lane & 15) * LDH + ks * 16 + (lane >> 4) * 8);
}

__global__ void __launch_bounds__(THREADS, 1)
tiled_da_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                   long long sb, long long sh, long long ss, const bf16* __restrict__ twc,
                   const bf16* __restrict__ twq, const int* __restrict__ mask, bf16* __restrict__ out,
                   int B, int H, int S, int blk, bool vec, bool vec_mask, float inv_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);       // q[g][x] at g*GS + x*LDH
  bf16* Ks = Qs + QKV_ELEMS;                      // k[g][y] at g*GS + y*LDH
  bf16* Vs = Ks + QKV_ELEMS;                      // v[g][y] at g*GS + y*LDH
  bf16* Tc = Vs + QKV_ELEMS;                      // twc rows [x][y]
  bf16* Tq = Tc + TAB_ELEMS;                      // twq rows [y][x]
  float* Ss = reinterpret_cast<float*>(Tq + TAB_ELEMS);  // s[g][x][y] at g*LSG + x*LSX + y
  bf16* Ps = reinterpret_cast<bf16*>(Ss + G * LSG);      // p[g][x][y] at (g*BQ + x)*LDP + y
  float* Al = reinterpret_cast<float*>(Ps + G * BQ * LDP);  // [G][BQ] rescale factors, then sums
  int* Ms = reinterpret_cast<int*>(Al + G * BQ);            // [G][BK] the mask's tile
  int* Cx = Ms + G * BK;  // [BQ] query row x's part of its twc row index
  int* Qx = Cx + BQ;      // [BQ] query row x's part of its twq row index

  const int b0 = blockIdx.x * G, i0 = blockIdx.y * BQ, h = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g8 = lane >> 2, t = lane & 3;
  const int n = S / blk;
  const size_t win = (size_t)blk * blk * D;  // elements of one window
  const bf16* tc_h = twc + (size_t)h * (2 * n - 1) * win;
  const bf16* tq_h = twq + (size_t)h * (2 * n - 1) * win;
  // The pair (i, j)'s table rows, (ib, xi) = divmod(i, blk), (jb, yj) = divmod(j, blk):
  //   twc: (jb - ib + n - 1) * blk^2 + xi * blk + yj = [jb * blk^2 + yj] + Cx[x]
  //   twq: (ib - jb + n - 1) * blk^2 + yj * blk + xi = [(n - 1 - jb) * blk^2 + yj * blk] + Qx[x]
  if (threadIdx.x < BQ) {
    const int i = i0 + threadIdx.x, ib = i / blk, xi = i % blk;
    Cx[threadIdx.x] = (n - 1 - ib) * blk * blk + xi * blk;
    Qx[threadIdx.x] = ib * blk * blk + xi;
  }
  __syncthreads();

  // Rows r0..r0+15 of q, k or v for the block's batch rows into dst (zeros
  // beyond B): cp.async where the rows are 16-byte aligned, else element loads.
  const auto stage_rows = [&](const bf16* x, int r0, bf16* dst) {
    if (vec) {
      for (int e = threadIdx.x; e < G * 16 * (D / 8); e += THREADS) {
        const int gg = e >> 7, r = (e >> 3) & 15, c = (e & 7) * 8;
        const bool ok = b0 + gg < B;
        const bf16* src = x + (ok ? (b0 + gg) * sb + h * sh + (long long)(r0 + r) * ss + c : 0);
        cp_async16(dst + gg * GS + r * LDH + c, src, ok);
      }
      return;
    }
    for (int e = threadIdx.x; e < G * 16 * D; e += THREADS) {
      const int gg = e >> 10, r = (e >> 6) & 15, c = e & 63;
      dst[gg * GS + r * LDH + c] =
          b0 + gg < B ? x[(b0 + gg) * sb + h * sh + (long long)(r0 + r) * ss + c] : __float2bfloat16(0.f);
    }
  };
  // The table rows of key tile j0: twc's (x, y) pairs into Tc[x][y], twq's
  // into Tq[y][x] (cp.async: the tables are contiguous and 16-byte aligned).
  // A thread keeps one key y and one 16-byte piece c, and walks x.
  const int ty = (threadIdx.x >> 3) & 15, tcol = (threadIdx.x & 7) * 8, tx = threadIdx.x >> 7;
  const auto stage_c2p = [&](int j0) {
    const int j = j0 + ty, kc = (j / blk) * blk * blk + j % blk;
#pragma unroll
    for (int x = tx; x < BQ; x += THREADS / (BK * D / 8))
      cp_async16(Tc + (x * BK + ty) * LDH + tcol, tc_h + (size_t)(kc + Cx[x]) * D + tcol);
  };
  const auto stage_p2c = [&](int j0) {
    const int j = j0 + ty, kq = (n - 1 - j / blk) * blk * blk + (j % blk) * blk;
#pragma unroll
    for (int x = tx; x < BQ; x += THREADS / (BK * D / 8))
      cp_async16(Tq + (ty * BQ + x) * LDH + tcol, tq_h + (size_t)(kq + Qx[x]) * D + tcol);
    stage_rows(k, j0, Ks);
    // The mask's [G, 16] tile, zeros (masked) for batch rows beyond B.
    if (vec_mask) {
      if (threadIdx.x < G * BK / 4) {
        const int gg = threadIdx.x >> 2, c4 = (threadIdx.x & 3) * 4;
        const bool ok = b0 + gg < B;
        cp_async16(Ms + gg * BK + c4, mask + (ok ? (size_t)(b0 + gg) * S + j0 + c4 : 0), ok);
      }
    } else {
      const int gg = threadIdx.x >> 4, y = threadIdx.x & 15;
      Ms[threadIdx.x] = b0 + gg < B ? mask[(size_t)(b0 + gg) * S + j0 + y] : 0;
    }
  };

  // Copy groups, in order: [q, tile 0's tables and k], [tile 0's v]; then per
  // tile t: [t+1's c2p slice], [t+1's k and p2c slice], [t+1's v] (possibly
  // empty, so the counts below hold at every tile).
  stage_rows(q, i0, Qs);
  stage_c2p(0);
  stage_p2c(0);
  cp_async_commit();
  stage_rows(v, 0, Vs);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // q.k's A fragments: the q tile of the warp's two batch rows, for every key tile.
  uint32_t qa[2][4][4];
#pragma unroll
  for (int gg = 0; gg < 2; ++gg)
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) ld_a(qa[gg][ks], Qs + (2 * warp + gg) * GS, ks, lane);
  float acc[2][8][4] = {};
  float m_run = -1e30f, l_run = 0.f;  // the lane's row: batch row 2*warp + lane/16, query row lane%16

  for (int j0 = 0; j0 < S; j0 += BK) {
    const bool more = j0 + BK < S;
    // q.k: batch rows 2*warp, 2*warp+1; C rows are query rows, columns keys.
#pragma unroll
    for (int gg = 0; gg < 2; ++gg) {
      const int g = 2 * warp + gg;
      float c[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t bb[4];
        ld_b_pair(bb, Ks + g * GS, LDH, ks, lane);
        mma_bf16(c[0], qa[gg][ks], bb[0], bb[1]);
        mma_bf16(c[1], qa[gg][ks], bb[2], bb[3]);
      }
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) Ss[g * LSG + (g8 + 8 * (e >> 1)) * LSX + nb * 8 + 2 * t + (e & 1)] = c[nb][e];
    }
    __syncthreads();

    // c2p: query rows 2*warp, 2*warp+1; C rows are keys, columns batch rows.
#pragma unroll
    for (int xx = 0; xx < 2; ++xx) {
      const int x = 2 * warp + xx;
      float c[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t a[4], bb[4];
        ld_a(a, Tc + x * BK * LDH, ks, lane);
        ld_b_pair(bb, Qs + x * LDH, GS, ks, lane);
        mma_bf16(c[0], a, bb[0], bb[1]);
        mma_bf16(c[1], a, bb[2], bb[3]);
      }
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          Ss[(nb * 8 + 2 * t + (e & 1)) * LSG + x * LSX + g8 + 8 * (e >> 1)] += c[nb][e];
    }
    __syncthreads();  // every read of Tc done
    if (more) stage_c2p(j0 + BK);
    cp_async_commit();

    // p2c: keys 2*warp, 2*warp+1; C rows are query rows, columns batch rows.
    // The mask and 1/scale apply here.
#pragma unroll
    for (int yy = 0; yy < 2; ++yy) {
      const int y = 2 * warp + yy;
      float c[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t a[4], bb[4];
        ld_a(a, Tq + y * BQ * LDH, ks, lane);
        ld_b_pair(bb, Ks + y * LDH, GS, ks, lane);
        mma_bf16(c[0], a, bb[0], bb[1]);
        mma_bf16(c[1], a, bb[2], bb[3]);
      }
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int gcol = nb * 8 + 2 * t + (e & 1);
          float* cell = Ss + gcol * LSG + (g8 + 8 * (e >> 1)) * LSX + y;
          *cell = Ms[gcol * BK + y] > 0 ? (*cell + c[nb][e]) * inv_scale : -1e30f;
        }
    }
    __syncthreads();  // every read of Tq, Ks and Ms done; the scores are whole
    if (more) stage_p2c(j0 + BK);
    cp_async_commit();

    // Online softmax: each lane owns one (batch row, query row) of the warp's
    // two batch rows and walks its 16 scores.
    {
      const int g = 2 * warp + (lane >> 4), x = lane & 15;
      const float* srow = Ss + g * LSG + x * LSX;
      float s[BK];
      float m_new = m_run;
#pragma unroll
      for (int y = 0; y < BK; ++y) {
        s[y] = srow[y];
        m_new = fmaxf(m_new, s[y]);
      }
      const float alpha = __expf(m_run - m_new);
      float sum = 0.f;
      uint32_t pw[BK / 2];
#pragma unroll
      for (int y = 0; y < BK; y += 2) {
        const float p0 = __expf(s[y] - m_new), p1 = __expf(s[y + 1] - m_new);
        sum += p0 + p1;
        pw[y / 2] = pack_bf16(p0, p1);
      }
      l_run = alpha * l_run + sum;
      m_run = m_new;
      uint4* prow = reinterpret_cast<uint4*>(Ps + (g * BQ + x) * LDP);
#pragma unroll
      for (int u = 0; u < BK / 8; ++u) prow[u] = make_uint4(pw[4 * u], pw[4 * u + 1], pw[4 * u + 2], pw[4 * u + 3]);
      Al[g * BQ + x] = alpha;
    }
    cp_async_wait<2>();  // this tile's v (the next tile's two table groups may be in flight)
    __syncthreads();

    // p.v for the warp's two batch rows, after rescaling by alpha.
#pragma unroll
    for (int gg = 0; gg < 2; ++gg) {
      const int g = 2 * warp + gg;
      const float a0 = Al[g * BQ + g8], a1 = Al[g * BQ + g8 + 8];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        acc[gg][nt][0] *= a0, acc[gg][nt][1] *= a0;
        acc[gg][nt][2] *= a1, acc[gg][nt][3] *= a1;
      }
      uint32_t pa[4];
      ldmatrix_x4(pa, Ps + (g * BQ + (lane & 15)) * LDP + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bb[4];
        ldmatrix_x4_trans(bb, Vs + g * GS + ((lane & 7) + ((lane >> 3) & 1) * 8) * LDH + np * 16 + (lane >> 4) * 8);
        mma_bf16(acc[gg][2 * np], pa, bb[0], bb[1]);
        mma_bf16(acc[gg][2 * np + 1], pa, bb[2], bb[3]);
      }
    }
    __syncthreads();  // every read of Vs done
    if (more) stage_rows(v, j0 + BK, Vs);
    cp_async_commit();
    cp_async_wait<1>();  // the next tile's tables, k and mask
    __syncthreads();
  }

  Al[(2 * warp + (lane >> 4)) * BQ + (lane & 15)] = l_run;  // the warp's own rows
  __syncwarp();
#pragma unroll
  for (int gg = 0; gg < 2; ++gg) {
    const int g = 2 * warp + gg, b = b0 + g;
    if (b >= B) continue;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int x = g8 + 8 * hh;
      const float l = Al[g * BQ + x];
      const float l_inv = l == 0.f ? 1.f : 1.f / l;
      bf16* o = out + (((size_t)b * S + i0 + x) * H + h) * D + 2 * t;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        *reinterpret_cast<__nv_bfloat162*>(o + nt * 8) =
            __floats2bfloat162_rn(acc[gg][nt][2 * hh] * l_inv, acc[gg][nt][2 * hh + 1] * l_inv);
    }
  }
}

}  // namespace

// bf16 only. q/k/v: [B, H, S, 64] with element strides (sb, sh, ss) and a unit
// last stride; twc/twq: [H, 2S/blk - 1, blk, blk, 64] contiguous, 16-byte
// aligned; mask: [B, S] int32; out: [B, S, H, 64] contiguous. S a multiple of
// 32, blk dividing S.
extern "C" int gct_tiled_disentangled_attention_tc(const void* q, const void* k, const void* v, long long sb,
                                                   long long sh, long long ss, const void* twc, const void* twq,
                                                   const void* mask, void* out, int B, int H, int S, int blk,
                                                   float inv_scale, void* stream) {
  if (S < 32 || S % 32 || blk < 1 || S % blk || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)twc % 16 || (uintptr_t)twq % 16) return (int)cudaErrorInvalidValue;
  static cudaError_t attr = allow_smem(tiled_da_tc_kernel, SMEM_BYTES);
  if (attr != cudaSuccess) return (int)attr;
  // cp.async copies of q/k/v rows need 16-byte aligned rows.
  const bool vec = sb % 8 == 0 && sh % 8 == 0 && ss % 8 == 0 && (uintptr_t)q % 16 == 0 &&
                   (uintptr_t)k % 16 == 0 && (uintptr_t)v % 16 == 0;
  const bool vec_mask = (uintptr_t)mask % 16 == 0;  // rows of S ints, S a multiple of 32
  dim3 grid((B + G - 1) / G, S / BQ, H);  // batch groups of one (head, query tile) adjacent
  tiled_da_tc_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, sb, sh, ss, (const bf16*)twc, (const bf16*)twq,
      (const int*)mask, (bf16*)out, B, H, S, blk, vec, vec_mask, inv_scale);
  return (int)cudaGetLastError();
}
