// The s8 . s8 -> s32 tensor-core core of K2′ (fused_ffn_w8a8_tc.cu), and the
// per-row int8 quantiser that feeds it.
//
//   out[m, n] = Act(((float(acc[m, n]) * row_scale[m]) * col_scale[n]) + bias[n])
//   acc[m, n] = sum_k a[m, k] * b[n, k]                     exact int32
//
// a: [M, K] int8 and b: [N, K] int8, both with k innermost: the m16n8k32 s8
// fragments hold four consecutive k of one row or column, and ldmatrix has no
// 8-bit transpose, so the weight comes as an [N, K] copy (made once where the
// engine places the model; ops/fused_ffn.py nk_weight) and both operands are
// plain ldmatrix reads. A block of 8 warps owns a 128 x 128 output tile (128
// x 64 where 128-wide tiles would leave SMs idle). The K loop steps by 128
// bytes through a ring of three stages filled by cp.async 16-byte copies,
// rows padded to 144 bytes (ldmatrix conflict-free), one barrier a step and
// four m16n8k32 k-steps between barriers. Each warp owns a 64 x 32 (or 32 x
// 32) sub-tile. The epilogue applies the scales and the bias with explicit
// round-to-nearest operations in the order above (no contracted multiply-add,
// so the result is the CUDA-core K2's bit for bit), then Act (the tanh gelu or
// the identity), and stores fp32 or bf16 straight from the accumulators; with
// row_amax given it also folds each row's max |out| into row_amax[m] (an
// atomic max on the fp32 bits, which order as integers for values >= 0), so
// that the quantiser of the output reads it once.
//
// The quantiser is the CUDA-core K2's: per row s = max(absmax / 127, 1e-10)
// and q = round_half_even(x / s), by __fdiv_rn and __float2int_rn; one warp a
// row, four values a lane a step. A maximum is exact in any order, so the
// absmax folded by the product's epilogue gives the same s.

#pragma once

#include "common.cuh"
#include "mma.cuh"

// Internal linkage: each kernel file that includes this header instantiates
// its own copies.
namespace {
namespace s8mm {

using namespace gct;

constexpr int BM = 128, BK = 128, STAGES = 3, THREADS = 256;
constexpr int LDT = BK + 16;  // int8 rows of a stage: 144 bytes

template <int BN> struct Tile {
  static constexpr int WARPS_N = BN / 32;      // 4 or 2
  static constexpr int WARPS_M = 8 / WARPS_N;  // 2 or 4
  static constexpr int WM = BM / WARPS_M;      // 64 or 32 rows a warp
  static constexpr int MT = WM / 16;           // m16 tiles a warp
  static constexpr int A_STAGE = BM * LDT;     // bytes
  static constexpr int B_STAGE = BN * LDT;
  static constexpr int SMEM = STAGES * (A_STAGE + B_STAGE);
};

struct Identity {
  __device__ __forceinline__ float operator()(float y) const { return y; }
};
struct Gelu {
  __device__ __forceinline__ float operator()(float y) const { return gelu_tanh(y); }
};

__device__ __forceinline__ void store2(float* p, float a, float b) { *reinterpret_cast<float2*>(p) = make_float2(a, b); }
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <int BN, typename Act, typename OutT>
__global__ void __launch_bounds__(THREADS, 2)
s8_gemm_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b, const float* __restrict__ row_scale,
               const float* __restrict__ col_scale, const float* __restrict__ bias, OutT* __restrict__ out,
               float* __restrict__ row_amax, int M, int N, int K) {
  using T = Tile<BN>;
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* As = reinterpret_cast<int8_t*>(smem);  // [STAGES][BM][LDT]
  int8_t* Bs = As + STAGES * T::A_STAGE;         // [STAGES][BN][LDT]

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / T::WARPS_N, wn = warp % T::WARPS_N;
  const int KT = (K + BK - 1) / BK;

  // k-step kt into ring slot kt % STAGES, zero-filled beyond M, N and K
  // (K % 16 == 0, so a copy is wholly inside or outside).
  const auto load_stage = [&](int kt) {
    const int slot = kt % STAGES, k0 = kt * BK;
    int8_t* as = As + slot * T::A_STAGE;
    for (int e = tid; e < BM * (BK / 16); e += THREADS) {
      const int r = e / (BK / 16), c = (e % (BK / 16)) * 16, gm = m0 + r, gk = k0 + c;
      const bool ok = gm < M && gk < K;
      cp_async16(as + r * LDT + c, ok ? a + (size_t)gm * K + gk : a, ok);
    }
    int8_t* bs = Bs + slot * T::B_STAGE;
    for (int e = tid; e < BN * (BK / 16); e += THREADS) {
      const int r = e / (BK / 16), c = (e % (BK / 16)) * 16, gn = n0 + r, gk = k0 + c;
      const bool ok = gn < N && gk < K;
      cp_async16(bs + r * LDT + c, ok ? b + (size_t)gn * K + gk : b, ok);
    }
  };

  int acc[T::MT][4][4];
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0;

  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    // Groups committed so far: steps 0 .. kt + STAGES - 2; at most STAGES - 2
    // still in flight leaves step kt landed for this thread.
    cp_async_wait<STAGES - 2>();
    // For all threads: step kt has landed, and every read of ring slot
    // (kt - 1) % STAGES (step kt - 1's) is done.
    __syncthreads();
    if (kt + STAGES - 1 < KT) load_stage(kt + STAGES - 1);
    cp_async_commit();

    const int8_t* as = As + (kt % STAGES) * T::A_STAGE;
    const int8_t* bs = Bs + (kt % STAGES) * T::B_STAGE;
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      uint32_t af[T::MT][4], bfr[2][4];
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt)
        ldmatrix_x4(af[mt], as + (wm * T::WM + mt * 16 + (lane & 15)) * LDT + ks * 32 + (lane >> 4) * 16);
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldmatrix_x4(bfr[np], bs + (wn * 32 + np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDT + ks * 32 +
                                 ((lane >> 3) & 1) * 16);
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          mma_s8(acc[mt][2 * np], af[mt], bfr[np][0], bfr[np][1]);
          mma_s8(acc[mt][2 * np + 1], af[mt], bfr[np][2], bfr[np][3]);
        }
    }
  }
  cp_async_wait<0>();

  // Epilogue: row scale, column scale, bias, Act; row m0 + wm*WM + mt*16 + g
  // (+8), columns 2t, 2t + 1 of each n8 tile.
  const int g = lane >> 2, t = lane & 3;
  const Act act{};
  float cs[4][2], cb[4][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int gn = n0 + wn * 32 + nt * 8 + 2 * t;
    const bool in = gn < N;  // N % 16 == 0: gn + 1 < N too
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      cs[nt][c] = in ? col_scale[gn + c] : 0.f;
      cb[nt][c] = in && bias ? bias[gn + c] : 0.f;
    }
  }
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int gm = m0 + wm * T::WM + mt * 16 + g + 8 * hh;
      const float r = gm < M ? row_scale[gm] : 0.f;
      float amax = 0.f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int gn = n0 + wn * 32 + nt * 8 + 2 * t;
        float y0 = __fmul_rn(__fmul_rn((float)acc[mt][nt][2 * hh], r), cs[nt][0]);
        float y1 = __fmul_rn(__fmul_rn((float)acc[mt][nt][2 * hh + 1], r), cs[nt][1]);
        if (bias) y0 = __fadd_rn(y0, cb[nt][0]), y1 = __fadd_rn(y1, cb[nt][1]);
        y0 = act(y0), y1 = act(y1);
        if (gm < M && gn < N) {
          store2(out + (size_t)gm * N + gn, y0, y1);
          amax = fmaxf(amax, fmaxf(fabsf(y0), fabsf(y1)));
        }
      }
      if (row_amax) {  // the quad holds the row's 32 columns of this warp
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 1));
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 2));
        if (t == 0 && gm < M) atomicMax(reinterpret_cast<int*>(row_amax + gm), __float_as_int(amax));
      }
    }
}

template <int BN, typename Act, typename OutT>
int launch_tile(const void* a, const void* b, const void* row_scale, const void* col_scale, const void* bias,
                void* out, void* row_amax, int M, int N, int K, cudaStream_t stream) {
  static cudaError_t attr = allow_smem(s8_gemm_kernel<BN, Act, OutT>, Tile<BN>::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  s8_gemm_kernel<BN, Act, OutT><<<grid, THREADS, Tile<BN>::SMEM, stream>>>(
      (const int8_t*)a, (const int8_t*)b, (const float*)row_scale, (const float*)col_scale, (const float*)bias,
      (OutT*)out, (float*)row_amax, M, N, K);
  return (int)cudaGetLastError();
}

// Checks the arguments and launches one product: a [M, K] and b [N, K] int8,
// row_scale [M], col_scale [N], bias [N] or null (f32), out [M, N] of OutT;
// all contiguous, a, b and out 16-byte aligned; K and N multiples of 16;
// row_amax [M] f32 (zeroed before; the rows' max |out| folded in) or null.
// 128-wide tiles where they give every SM a block, else 64-wide.
template <typename Act, typename OutT>
int launch(const void* a, const void* b, const void* row_scale, const void* col_scale, const void* bias, void* out,
           void* row_amax, int M, int N, int K, cudaStream_t stream) {
  if (M < 1 || N < 1 || K < 1 || K % 16 || N % 16 || (uintptr_t)a % 16 || (uintptr_t)b % 16 ||
      (uintptr_t)out % 16 || (M + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  static int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  const long long wide = (long long)((M + BM - 1) / BM) * ((N + 127) / 128);
  if (wide >= sms) return launch_tile<128, Act, OutT>(a, b, row_scale, col_scale, bias, out, row_amax, M, N, K, stream);
  return launch_tile<64, Act, OutT>(a, b, row_scale, col_scale, bias, out, row_amax, M, N, K, stream);
}

// Four values of a row as floats (16 bytes of fp32, 8 of bf16; aligned).
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  v[0] = lo.x, v[1] = lo.y, v[2] = hi.x, v[3] = hi.y;
}

constexpr int QUANT_ROWS = 8;  // rows (warps) a block of the quantiser

// Quantises row `row` of x. s[row] holds the row's absmax on entry when
// amax_in (folded by the product that wrote x), and its scale on exit;
// zero_out[row] = 0 when given (the next product's absmax starts there).
template <typename T>
__global__ void __launch_bounds__(QUANT_ROWS * 32)
row_quant_kernel(const T* __restrict__ x, int8_t* __restrict__ q, float* s, int M, int K, bool amax_in,
                 float* __restrict__ zero_out) {
  const int row = blockIdx.x * QUANT_ROWS + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= M) return;
  const T* xr = x + (size_t)row * K;
  float mx = 0.f;
  if (amax_in) {
    mx = s[row];
  } else {
    for (int c = lane * 4; c < K; c += 128) {
      float v[4];
      load4(xr + c, v);
#pragma unroll
      for (int i = 0; i < 4; ++i) mx = fmaxf(mx, fabsf(v[i]));
    }
    mx = warp_max(mx);
  }
  const float sc = fmaxf(__fdiv_rn(mx, 127.0f), 1e-10f);
  int8_t* qr = q + (size_t)row * K;
  for (int c = lane * 4; c < K; c += 128) {
    float v[4];
    load4(xr + c, v);
    char4 o;
    o.x = (int8_t)__float2int_rn(__fdiv_rn(v[0], sc));
    o.y = (int8_t)__float2int_rn(__fdiv_rn(v[1], sc));
    o.z = (int8_t)__float2int_rn(__fdiv_rn(v[2], sc));
    o.w = (int8_t)__float2int_rn(__fdiv_rn(v[3], sc));
    *reinterpret_cast<char4*>(qr + c) = o;
  }
  __syncwarp();  // every lane has read s[row]
  if (lane == 0) {
    s[row] = sc;
    if (zero_out) zero_out[row] = 0.f;
  }
}

// x: [M, K] (fp32 or bf16, 16-byte aligned) -> q: [M, K] int8 (aligned), s:
// [M] f32 scales (on entry the rows' absmax when amax_in); K a multiple of 4;
// zero_out: [M] f32 set to 0, or null.
template <typename T>
int row_quant(const void* x, void* q, void* s, int M, int K, bool amax_in, void* zero_out, cudaStream_t stream) {
  if (M < 1 || K < 4 || K % 4 || (uintptr_t)x % 16 || (uintptr_t)q % 4) return (int)cudaErrorInvalidValue;
  row_quant_kernel<T><<<(M + QUANT_ROWS - 1) / QUANT_ROWS, QUANT_ROWS * 32, 0, stream>>>(
      (const T*)x, (int8_t*)q, (float*)s, M, K, amax_in, (float*)zero_out);
  return (int)cudaGetLastError();
}

}  // namespace s8mm
}  // namespace
