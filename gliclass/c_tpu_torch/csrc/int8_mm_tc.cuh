// The tensor-core core shared by K3′ (int8_matmul_tc.cu) and K4′
// (fused_ffn_wonly_tc.cu): y = epi((x . w_q) * scale[n] (+ b[n])) with bf16
// x and out, int8 w_q, fp32 sums on bf16 mma.sync.
//
// A block of 8 warps owns a 128 x 128 output tile (128 x 64 where 128-wide
// tiles would leave SMs idle). The K loop steps by 32 through a ring of four
// stages filled by cp.async 16-byte copies: x as 8 bf16 values a copy, the
// weight as 16 int8 values a copy, so the weight stays int8 in device memory
// and in the ring. Each stage's int8 tile is widened once per block into a
// bf16 [k][n] tile (exact: every int8 value is a bf16 value),
// double-buffered, so one barrier a step separates the copies, the widening
// of step k+1 and the products of step k. Each warp runs mma.sync m16n8k16
// on a 64 x 32 (or 32 x 32) sub-tile, A fragments by ldmatrix from x rows
// padded to 80 bytes, B fragments by ldmatrix.trans from widened rows padded
// by 16 bytes: both reads are free of bank conflicts. The epilogue applies
// the per-channel scale and the bias to the fp32 sum, then ``Epi`` (the
// identity for K3′, the tanh gelu for K4′'s up product), rounds the tile to
// bf16 through shared memory and stores 16 bytes a copy.

#pragma once

#include "common.cuh"
#include "mma.cuh"

// Internal linkage: each kernel file that includes this header instantiates
// its own copies.
namespace {
namespace i8tc {

using namespace gct;
using bf16 = __nv_bfloat16;

constexpr int BM = 128, BK = 32, STAGES = 4, THREADS = 256;
constexpr int LDA = BK + 8;  // bf16 x rows: 80 bytes, ldmatrix conflict-free

template <int BN> struct Tile {
  static constexpr int WARPS_N = BN / 32;      // 4 or 2
  static constexpr int WARPS_M = 8 / WARPS_N;  // 2 or 4
  static constexpr int WM = BM / WARPS_M;      // 64 or 32 rows a warp
  static constexpr int MT = WM / 16;           // m16 tiles a warp
  static constexpr int LDB = BN + 8;           // widened bf16 rows: 16 bytes of padding
  static constexpr int LDO = BN + 8;           // output staging rows
  static constexpr int A_STAGE = BM * LDA;     // bf16 elements
  static constexpr int W_STAGE = BK * BN;      // int8 bytes
  static constexpr int B_BUF = BK * LDB;       // bf16 elements
  static constexpr int SMEM = STAGES * A_STAGE * 2 + STAGES * W_STAGE + 2 * B_BUF * 2;
  static_assert(BM * LDO <= STAGES * A_STAGE, "the output tile fits in the x ring");
};

// The epilogues: applied to scale * sum (+ bias) before the bf16 rounding.
struct Identity {
  __device__ __forceinline__ float operator()(float y) const { return y; }
};
struct Gelu {
  __device__ __forceinline__ float operator()(float y) const { return gelu_tanh(y); }
};

// 16 int8 weights (one 16-byte word) as 8 pairs of bf16 values, exactly and
// off the conversion pipe (16 results a clock per SM): each byte, offset by
// 128, becomes the low mantissa byte of 2^23 (byte permute) and the offset
// is subtracted in fp32; an integer of at most 8 bits is exact in bf16, so
// its bf16 bits are the top half of its fp32 bits (byte permute again).
__device__ __forceinline__ void widen16(const int4 raw, uint32_t out[8]) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(&raw);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t u = w[q] ^ 0x80808080u;
    uint32_t f[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      f[i] = __float_as_uint(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + i)) - 8388736.f);
    out[2 * q] = __byte_perm(f[0], f[1], 0x7632);
    out[2 * q + 1] = __byte_perm(f[2], f[3], 0x7632);
  }
}

template <int BN, typename Epi>
__global__ void __launch_bounds__(THREADS)
int8_mm_tc_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ w, const float* __restrict__ scale,
                  const float* __restrict__ bias, bf16* __restrict__ out, int M, int N, int K) {
  using T = Tile<BN>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);                          // [STAGES][BM][LDA] x ring
  int8_t* Ws = reinterpret_cast<int8_t*>(As + STAGES * T::A_STAGE);  // [STAGES][BK][BN] weight ring
  bf16* Bs = reinterpret_cast<bf16*>(Ws + STAGES * T::W_STAGE);      // [2][BK][LDB] widened weight

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / T::WARPS_N, wn = warp % T::WARPS_N;
  const int KT = (K + BK - 1) / BK;

  // k-step kt into ring slot kt % STAGES, zero-filled beyond M, N and K
  // (K % 8 == 0 and N % 16 == 0, so a copy is wholly inside or outside).
  const auto load_stage = [&](int kt) {
    const int slot = kt % STAGES, k0 = kt * BK;
    bf16* a = As + slot * T::A_STAGE;
    for (int e = tid; e < BM * (BK / 8); e += THREADS) {
      const int r = e / (BK / 8), c = (e % (BK / 8)) * 8, gm = m0 + r, gk = k0 + c;
      const bool ok = gm < M && gk < K;
      cp_async16(a + r * LDA + c, ok ? x + (size_t)gm * K + gk : x, ok);
    }
    int8_t* ws = Ws + slot * T::W_STAGE;
    for (int e = tid; e < BK * (BN / 16); e += THREADS) {
      const int r = e / (BN / 16), c = (e % (BN / 16)) * 16, gk = k0 + r, gn = n0 + c;
      const bool ok = gk < K && gn < N;
      cp_async16(ws + r * BN + c, ok ? w + (size_t)gk * N + gn : w, ok);
    }
  };
  // The int8 tile of step kt, widened to bf16 in buffer kt & 1.
  const auto widen = [&](int kt) {
    const int8_t* ws = Ws + (kt % STAGES) * T::W_STAGE;
    bf16* b = Bs + (kt & 1) * T::B_BUF;
    for (int e = tid; e < BK * (BN / 16); e += THREADS) {
      const int r = e / (BN / 16), c = (e % (BN / 16)) * 16;
      uint32_t p[8];
      widen16(*reinterpret_cast<const int4*>(ws + r * BN + c), p);
      uint4* dst = reinterpret_cast<uint4*>(b + r * T::LDB + c);
      dst[0] = make_uint4(p[0], p[1], p[2], p[3]);
      dst[1] = make_uint4(p[4], p[5], p[6], p[7]);
    }
  };

  float acc[T::MT][4][4];
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(s);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 2>();
  __syncthreads();
  widen(0);

  for (int kt = 0; kt < KT; ++kt) {
    // Groups committed so far: steps 0 .. kt + STAGES - 2; at most one still
    // in flight leaves step kt + 1 landed for this thread.
    cp_async_wait<STAGES - 3>();
    // For all threads: step kt + 1 has landed and step kt is widened; every
    // read of ring slot (kt - 1) % STAGES and of widened buffer (kt + 1) & 1
    // (step kt - 1's) is done.
    __syncthreads();
    if (kt + STAGES - 1 < KT) load_stage(kt + STAGES - 1);
    cp_async_commit();
    if (kt + 1 < KT) widen(kt + 1);

    const bf16* a = As + (kt % STAGES) * T::A_STAGE;
    const bf16* b = Bs + (kt & 1) * T::B_BUF;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t af[T::MT][4], bfr[2][4];
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt)
        ldmatrix_x4(af[mt], a + (wm * T::WM + mt * 16 + (lane & 15)) * LDA + ks * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldmatrix_x4_trans(bfr[np], b + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * T::LDB + wn * 32 +
                                       np * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          mma_bf16(acc[mt][2 * np], af[mt], bfr[np][0], bfr[np][1]);
          mma_bf16(acc[mt][2 * np + 1], af[mt], bfr[np][2], bfr[np][3]);
        }
    }
  }

  // Epilogue: scale, bias and Epi on the fp32 sums, rounded to bf16 into the
  // (now idle) x ring, then 16-byte stores of whole row segments.
  cp_async_wait<0>();
  __syncthreads();
  bf16* Os = As;  // [BM][LDO]
  const int g = lane >> 2, t = lane & 3;
  const Epi epi{};
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = wn * 32 + nt * 8 + 2 * t, gn = n0 + col;
    const bool in = gn < N;  // N % 16 == 0: gn + 1 < N too
    const float s0 = in ? scale[gn] : 0.f, s1 = in ? scale[gn + 1] : 0.f;
    const float b0 = in && bias ? bias[gn] : 0.f, b1 = in && bias ? bias[gn + 1] : 0.f;
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float y0 = __fmul_rn(acc[mt][nt][2 * hh], s0), y1 = __fmul_rn(acc[mt][nt][2 * hh + 1], s1);
        if (bias) y0 = __fadd_rn(y0, b0), y1 = __fadd_rn(y1, b1);
        const int row = wm * T::WM + mt * 16 + g + 8 * hh;
        *reinterpret_cast<__nv_bfloat162*>(Os + row * T::LDO + col) = __floats2bfloat162_rn(epi(y0), epi(y1));
      }
  }
  __syncthreads();
  for (int e = tid; e < BM * (BN / 8); e += THREADS) {
    const int r = e / (BN / 8), c = (e % (BN / 8)) * 8, gm = m0 + r, gn = n0 + c;
    if (gm < M && gn < N)
      *reinterpret_cast<uint4*>(out + (size_t)gm * N + gn) = *reinterpret_cast<const uint4*>(Os + r * T::LDO + c);
  }
}

template <int BN, typename Epi>
int launch_tile(const void* x, const void* w, const void* scale, const void* bias, void* out, int M, int N, int K,
                cudaStream_t stream) {
  static cudaError_t attr = allow_smem(int8_mm_tc_kernel<BN, Epi>, Tile<BN>::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int8_mm_tc_kernel<BN, Epi><<<grid, THREADS, Tile<BN>::SMEM, stream>>>(
      (const bf16*)x, (const int8_t*)w, (const float*)scale, (const float*)bias, (bf16*)out, M, N, K);
  return (int)cudaGetLastError();
}

// Checks the arguments and launches one product: bf16 x [M, K] and out
// [M, N], w: [K, N] int8, scale: [N] f32, bias: [N] f32 or null; all
// contiguous, x, w and out 16-byte aligned; K % 8 == 0, N % 16 == 0.
// 128-wide tiles where they give every SM a block, else 64-wide.
template <typename Epi>
int launch(const void* x, const void* w, const void* scale, const void* bias, void* out, int M, int N, int K,
           cudaStream_t stream) {
  if (M < 1 || N < 1 || K < 1 || K % 8 || N % 16 || (uintptr_t)x % 16 || (uintptr_t)w % 16 ||
      (uintptr_t)out % 16 || (M + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  static int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  const long long wide = (long long)((M + BM - 1) / BM) * ((N + 127) / 128);
  if (wide >= sms) return launch_tile<128, Epi>(x, w, scale, bias, out, M, N, K, stream);
  return launch_tile<64, Epi>(x, w, scale, bias, out, M, N, K, stream);
}

}  // namespace i8tc
}  // namespace
