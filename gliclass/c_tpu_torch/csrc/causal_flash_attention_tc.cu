// K5, tensor-core variant: causal grouped-query flash attention with key
// padding on bf16 mma.sync (flash attention 2), for bf16 q/k/v with d a
// multiple of 16 and at most 128.
//
// Replaces the TPU kernel gliclass/c_tpu/ops/causal_attention.py::_kernel
// (reached through _flash_call and causal_flash_attention);
// causal_flash_attention.cu keeps fp32 (TF32 would round q and k and miss
// fp32's 1e-4) and the other head widths.
//
//   s[i,j] = scale * q_i.k_j                                fp32 sums
//   out_i  = softmax_j(s[i,:] over j <= i with mask[j] > 0) . v
//
// Query head h reads kv head h / g (the JAX package's q.reshape(B, nkv, g, S,
// d) grouping). Masked keys contribute exactly 0, so a row with no valid key
// gives 0 (l == 0), as the plain version does.
//
// What bounds it on the H100: per (batch, query head) it reads q, k, v once
// and writes the context once, while it does about 2*S*S*d operations (q.k
// and P.v, halved by causality). At qwen-1.5B's d = 128 that is above the
// card's ~295 operations per byte from S ~ 600 on; at its buckets (S <= 512)
// bytes and operations are within a few times of each other, and what holds a
// kernel is how much of the arithmetic reaches the tensor cores and how well
// the loads overlap it. The CUDA-core K5 ran every product as fp32 FMAs on
// operands widened to fp32 in shared memory (one 117 KB block per SM at d =
// 128), with P through shared memory and three barriers per key tile.
//
// What the design does about it: one block of 4 warps owns a 64-row query
// tile of one (batch, query head); each warp owns 16 query rows. 64-key tiles
// of k and v are double-buffered with cp.async 16-byte copies, one barrier a
// key tile; q is staged bf16 in v's second buffer and read once into A
// fragments (ldmatrix) before key tile 1 lands there. That keeps a block at
// 70 KB of shared memory and 168 registers a thread (16 bytes spilled) at
// d = 128, so three blocks (12 warps) share an SM: a first version with q in
// a buffer of its own (87 KB, 202 registers, two blocks an SM) took 20%
// longer on the card (scripts/k4_k5_times.py, profiler device time).
// S = q.k^T on mma.sync m16n8k16 (k rows by ldmatrix, not transposed, are
// the B operand); the online softmax runs in registers, exp by ex2.approx
// with scale * log2(e) folded into the scores, the row max by two quad
// shuffles, the row sum kept per lane and reduced once at the end; P is
// packed to bf16 A fragments straight from the S accumulators, and O += P.v
// takes v by ldmatrix.trans; one reciprocal per row at the end. Key tiles above the diagonal never run;
// on the diagonal tile a warp skips the 16-key columns wholly above its rows,
// and the causal cut, the key mask (a 64-bit ballot per tile) and keys past S
// (zero-filled) are applied in registers. Blocks run the longest query tiles
// first, and the g query heads of one kv head are adjacent in the grid, so
// they read its k and v through L2. d below the tile width (64 or 128) is
// zero-padded. The context is staged as bf16 in the warp's own rows of the
// last k tile and stored 16 bytes a copy into [B, S, nh, d].

#include <math.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

using namespace gct;
using bf16 = __nv_bfloat16;

constexpr int BQ = 64;  // query rows per block
constexpr int BK = 64;  // keys per tile
constexpr int THREADS = 128;
constexpr float LOG2E = 1.4426950408889634f;

template <int DP> struct Layout {
  static constexpr int LD = DP + 8;         // bf16 row stride: 16 bytes of padding, ldmatrix conflict-free
  static constexpr int TILE = 64 * LD;      // elements of one 64-row tile
  static constexpr int SMEM = 4 * TILE * 2;  // k x 2, v x 2 (q staged in v's second buffer)
};

template <int DP>
__global__ void __launch_bounds__(THREADS, 3)
causal_fa_tc_kernel(const bf16* __restrict__ q, int qsb, int qsk, int qsg, int qss,
                    const bf16* __restrict__ k, int ksb, int ksh, int kss,
                    const bf16* __restrict__ v, int vsb, int vsh, int vss,
                    const int* __restrict__ mask, bf16* __restrict__ out, int nkv, int g, int S, int d,
                    float scale_log2) {
  using L = Layout<DP>;
  constexpr int LD = L::LD, KS = DP / 16, NT = DP / 8, CH = DP / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);  // [2][64][LD]
  bf16* Vs = Ks + 2 * L::TILE;               // [2][64][LD]
  bf16* Qs = Vs + L::TILE;                   // [64][LD]: v's second buffer until tile 1 is staged

  const int nh = nkv * g;
  const int h = blockIdx.x % nh, b = blockIdx.x / nh;
  const int qt = gridDim.y - 1 - blockIdx.y;  // the longest query tiles first
  const int i0 = qt * BQ;
  const int kv = h / g, gi = h - kv * g;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const int rw = warp * 16;  // the warp's first row in the tile
  const bf16* qb = q + (size_t)b * qsb + (size_t)kv * qsk + (size_t)gi * qsg;
  const bf16* kb = k + (size_t)b * ksb + (size_t)kv * ksh;
  const bf16* vb = v + (size_t)b * vsb + (size_t)kv * vsh;
  const int* mb = mask + (size_t)b * S;

  // Rows r0..r0+63 of a [S, d] matrix (row stride ld) into a tile, zeros
  // past S and d (d % 16 == 0: a 16-byte piece is wholly inside or outside).
  const auto stage = [&](const bf16* src, int ld, int r0, bf16* dst) {
    for (int e = tid; e < 64 * CH; e += THREADS) {
      const int r = e / CH, c = (e % CH) * 8, row = r0 + r;
      const bool ok = row < S && c < d;
      cp_async16(dst + r * LD + c, ok ? src + (size_t)row * ld + c : src, ok);
    }
  };

  stage(qb, qss, i0, Qs);
  stage(kb, kss, 0, Ks);
  stage(vb, vss, 0, Vs);
  cp_async_commit();

  uint32_t qf[KS][4];
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  // Rows gq (index 0) and gq + 8 (index 1) of the warp's 16: running max (in
  // log2 units) and this lane's part of the running sum.
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  // Key tiles 0..qt: BQ == BK, so tile qt holds the diagonal and every later
  // tile lies wholly above it.
  for (int t = 0; t <= qt; ++t) {
    cp_async_wait<0>();
    __syncthreads();  // tile t has landed; every read of tile t - 1's buffers is done
    if (t == 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) ldmatrix_x4(qf[ks], Qs + (rw + (lane & 15)) * LD + ks * 16 + (lane >> 4) * 8);
      __syncthreads();  // every warp holds its q fragments: tile 1 may overwrite the q tile
    }
    if (t < qt) {
      stage(kb, kss, (t + 1) * BK, Ks + ((t + 1) & 1) * L::TILE);
      stage(vb, vss, (t + 1) * BK, Vs + ((t + 1) & 1) * L::TILE);
    }
    cp_async_commit();
    const bf16* Kt = Ks + (t & 1) * L::TILE;
    const bf16* Vt = Vs + (t & 1) * L::TILE;
    const int j0 = t * BK;
    const bool diag = t == qt;
    // Key columns in 8-key tiles that the warp needs: on the diagonal, those
    // up to its last row (the rest are masked for all its rows).
    const int nkt = diag ? 2 * (warp + 1) : 8;

    // The tile's valid keys (in range and unmasked), one bit each.
    const unsigned lo = __ballot_sync(0xffffffffu, j0 + lane < S && mb[j0 + lane] > 0);
    const unsigned hi = __ballot_sync(0xffffffffu, j0 + 32 + lane < S && mb[j0 + 32 + lane] > 0);

    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (2 * np >= nkt) continue;
        uint32_t kf[4];
        ldmatrix_x4(kf, Kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + ks * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qf[ks], kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qf[ks], kf[2], kf[3]);
      }

    // Mask, scale into log2 units, and the row max over the quad.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jl = n * 8 + 2 * tq + (e & 1), il = rw + gq + 8 * (e >> 1);
        const bool ok = (((n < 4 ? lo : hi) >> (jl & 31)) & 1u) && (!diag || jl <= il);
        s[n][e] = ok ? s[n][e] * scale_log2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float mu[2], alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float m_new = fmaxf(m_run[hh], mx[hh]);
      mu[hh] = m_new == -INFINITY ? 0.f : m_new;  // no valid key yet: every p is 2^-inf = 0
      alpha[hh] = ex2(m_run[hh] - mu[hh]);
      m_run[hh] = m_new;
    }

    // p = 2^(s - m), summed in fp32 and packed to bf16 A fragments of P.v:
    // k-step kk takes key tiles 2kk (a[0], a[1]) and 2kk + 1 (a[2], a[3]).
    uint32_t pf[4][4];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float p0 = ex2(s[n][0] - mu[0]), p1 = ex2(s[n][1] - mu[0]);
      const float p2 = ex2(s[n][2] - mu[1]), p3 = ex2(s[n][3] - mu[1]);
      rs[0] += p0 + p1;
      rs[1] += p2 + p3;
      pf[n >> 1][(n & 1) * 2] = pack_bf16(p0, p1);
      pf[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l_run[hh] = alpha[hh] * l_run[hh] + rs[hh];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] *= alpha[0], o[n][1] *= alpha[0];
      o[n][2] *= alpha[1], o[n][3] *= alpha[1];
    }

    // O += P.v over the 16-key steps the warp needs.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (2 * kk >= nkt) continue;
#pragma unroll
      for (int np = 0; np < DP / 16; ++np) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, Vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + np * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * np], pf[kk], vf[0], vf[1]);
        mma_bf16(o[2 * np + 1], pf[kk], vf[2], vf[3]);
      }
    }
  }

  // The row sums over the quad, one reciprocal per row (0 for a row with no
  // valid key); the context rounded to bf16 into the warp's own rows of the
  // last k tile, then 16-byte stores.
  float inv[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float l = l_run[hh];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[hh] = l > 0.f ? 1.f / l : 0.f;
  }
  __syncthreads();  // every read of the last k and v tiles is done
  bf16* Os = Ks + (qt & 1) * L::TILE + rw * LD;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    *reinterpret_cast<__nv_bfloat162*>(Os + gq * LD + n * 8 + 2 * tq) =
        __floats2bfloat162_rn(o[n][0] * inv[0], o[n][1] * inv[0]);
    *reinterpret_cast<__nv_bfloat162*>(Os + (gq + 8) * LD + n * 8 + 2 * tq) =
        __floats2bfloat162_rn(o[n][2] * inv[1], o[n][3] * inv[1]);
  }
  __syncwarp();
  for (int e = lane; e < 16 * CH; e += 32) {
    const int r = e / CH, c = (e % CH) * 8, i = i0 + rw + r;
    if (i < S && c < d)
      *reinterpret_cast<uint4*>(out + (((size_t)b * S + i) * nh + h) * d + c) =
          *reinterpret_cast<const uint4*>(Os + r * LD + c);
  }
}

template <int DP>
int launch(const void* q, const int* qs, const void* k, const int* ks, const void* v, const int* vs,
           const void* mask, void* out, int B, int nkv, int g, int S, int d, float scale, cudaStream_t stream) {
  static cudaError_t attr = allow_smem(causal_fa_tc_kernel<DP>, Layout<DP>::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid(B * nkv * g, (S + BQ - 1) / BQ);
  causal_fa_tc_kernel<DP><<<grid, THREADS, Layout<DP>::SMEM, stream>>>(
      (const bf16*)q, qs[0], qs[1], qs[2], qs[3], (const bf16*)k, ks[0], ks[1], ks[2], (const bf16*)v, vs[0],
      vs[1], vs[2], (const int*)mask, (bf16*)out, nkv, g, S, d, scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 only. q: [B, nkv, g, S, d] with element strides (qsb, qsk, qsg, qss);
// k, v: [B, nkv, S, d] with strides (sb, sh, ss); all with a unit last
// stride, the other strides multiples of 8 and q, k, v 16-byte aligned;
// mask: [B, S] int32; out: [B, S, nkv*g, d] contiguous, 16-byte aligned.
// d a multiple of 16, at most 128.
extern "C" int gct_causal_flash_attention_tc(const void* q, int qsb, int qsk, int qsg, int qss, const void* k,
                                             int ksb, int ksh, int kss, const void* v, int vsb, int vsh, int vss,
                                             const void* mask, void* out, int B, int nkv, int g, int S, int d,
                                             float scale, void* stream) {
  if (d < 16 || d > 128 || d % 16 || S < 1 || B < 1 || nkv < 1 || g < 1 || (S + BQ - 1) / BQ > 65535 ||
      (long long)B * nkv * g > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int qs[4] = {qsb, qsk, qsg, qss}, ks[3] = {ksb, ksh, kss}, vs[3] = {vsb, vsh, vss};
  for (int s : qs)
    if (s % 8) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 3; ++i)
    if (ks[i] % 8 || vs[i] % 8) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)q % 16 || (uintptr_t)k % 16 || (uintptr_t)v % 16 || (uintptr_t)out % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (d <= 64) return launch<64>(q, qs, k, ks, v, vs, mask, out, B, nkv, g, S, d, scale, st);
  return launch<128>(q, qs, k, ks, v, vs, mask, out, B, nkv, g, S, d, scale, st);
}
