// Quantized-weight matmul: y[m, n] = scale[n] * sum_k bf16(x[m, k]) * w[n, k].
//
// Replaces the Pallas kernel gigapath_tpu/quant/qmatmul.py:_q_matmul_kernel
// (called by q_matmul_pallas). x is bf16 [M, K] row-major; w is the
// nn.Linear weight [N, K] (K contiguous) quantized to int8 or fp8-e4m3
// (__nv_fp8_e4m3, the OCP e4m3fn format of torch.float8_e4m3fn); scale is
// fp32 [N], one per output channel; y is fp32 [M, N].
//
// Numerics follow the Pallas kernel: each weight is converted to float
// exactly (int8 magnitudes <= 127 and every e4m3 value are exact), each
// product of a bf16 value and a weight is exact in fp32, the sum over k is
// accumulated in fp32, and the scale is applied once at the store. The
// kernel differs from its plain version only in the order of the sums.
//
// Bound on the H100: operations, 2*M*N*K (at the flagship's M = 25216 and
// K >= 1536, hundreds of operations per byte moved). This first version
// runs on the fp32 FMA pipes, so its ceiling is the 67 TFLOP/s fp32 rate,
// not the 989 TFLOP/s bf16 tensor-core rate the bound is stated against;
// tensor cores (mma.sync, then wgmma with TMA, or Hopper's fp8 and int8
// MMA) are later work. What the design does about the bound: a block of 256
// threads owns one 128 x 128 output tile and walks K in steps of 16; each
// step's x and w tiles are converted to fp32 once and staged in shared
// memory transposed (k-major), so every thread reads its 8 rows and 8
// columns with four float4 loads and does 64 FMAs with them in registers
// (an 8 x 8 micro-tile per thread); the next step's global loads are
// issued before the current step's FMAs, so they are in flight meanwhile.
// Bounds checks on M, N and K: any shape runs, ragged tiles load zeros.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BM = 128;  // output rows per block
constexpr int BN = 128;  // output columns per block
constexpr int BK = 16;   // k per shared-memory step
constexpr int TM = 8;    // rows per thread
constexpr int TN = 8;    // columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
// each thread loads 8 consecutive k of one x row and of one w row per step
static_assert(THREADS * 8 == BM * BK && THREADS * 8 == BN * BK, "loader mapping");

template <bool FP8>
__device__ __forceinline__ float weight_to_f32(uint8_t b) {
  if constexpr (FP8) {
    return __half2float(__half(__nv_cvt_fp8_to_halfraw(b, __NV_E4M3)));
  } else {
    return static_cast<float>(static_cast<int8_t>(b));
  }
}

// this thread's 8 x values (row gm, k from gk) and 8 weights (row gn, k
// from gk) as fp32; zeros past M, N or K
template <bool FP8>
__device__ __forceinline__ void load_step(const __nv_bfloat16* __restrict__ x,
                                          const uint8_t* __restrict__ w, int M,
                                          int N, int K, int gm, int gn, int gk,
                                          bool vec, float* xv, float* wv) {
  if (vec && gm < M && gk + 8 <= K) {
    const uint4 raw = *reinterpret_cast<const uint4*>(x + (long long)gm * K + gk);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) xv[i] = __bfloat162float(h[i]);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      xv[i] = (gm < M && gk + i < K) ? __bfloat162float(x[(long long)gm * K + gk + i]) : 0.f;
  }
  if (vec && gn < N && gk + 8 <= K) {
    const uint2 raw = *reinterpret_cast<const uint2*>(w + (long long)gn * K + gk);
    const uint8_t* b = reinterpret_cast<const uint8_t*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) wv[i] = weight_to_f32<FP8>(b[i]);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      wv[i] = (gn < N && gk + i < K) ? weight_to_f32<FP8>(w[(long long)gn * K + gk + i]) : 0.f;
  }
}

template <bool FP8>
__global__ void __launch_bounds__(THREADS)
    q_matmul_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
                    const float* __restrict__ scale, float* __restrict__ y, int M,
                    int N, int K, int vec) {
  __shared__ __align__(16) float xs[BK][BM];
  __shared__ __align__(16) float ws[BK][BN];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int lrow = tid >> 1;       // loader: tile row
  const int lk = (tid & 1) * 8;    // loader: first k of its 8
  const int tx = tid % (BN / TN);  // compute: columns tx*4 .. +3 and 64 + tx*4 .. +3
  const int ty = tid / (BN / TN);  // compute: rows ty*4 .. +3 and 64 + ty*4 .. +3

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  float xv[8], wv[8];
  load_step<FP8>(x, w, M, N, K, m0 + lrow, n0 + lrow, lk, vec, xv, wv);
  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();  // the previous step's tiles are consumed
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      xs[lk + i][lrow] = xv[i];
      ws[lk + i][lrow] = wv[i];
    }
    __syncthreads();
    if (k0 + BK < K)  // next step's loads, in flight during the FMAs below
      load_step<FP8>(x, w, M, N, K, m0 + lrow, n0 + lrow, k0 + BK + lk, vec, xv, wv);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
      const float4 a0 = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&xs[kk][BM / 2 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&ws[kk][BN / 2 + tx * 4]);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  // epilogue: the per-channel scale, once, at the store
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = m0 + (i < 4 ? ty * 4 + i : BM / 2 + ty * 4 + i - 4);
    if (r >= M) continue;
    float* yr = y + (long long)r * N;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = n0 + half * (BN / 2) + tx * 4;
      const float* ac = &acc[i][half * 4];
      if (vec && c + 3 < N) {
        const float4 s4 = *reinterpret_cast<const float4*>(scale + c);
        *reinterpret_cast<float4*>(yr + c) =
            make_float4(ac[0] * s4.x, ac[1] * s4.y, ac[2] * s4.z, ac[3] * s4.w);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < N) yr[c + j] = ac[j] * scale[c + j];
      }
    }
  }
}

}  // namespace

// x: bf16 [M, K]; w: int8 (is_fp8 = 0) or fp8-e4m3 (is_fp8 = 1) bytes
// [N, K]; scale: fp32 [N]; y: fp32 [M, N]; all contiguous. vec = 1 lets
// the kernel use 16-byte x loads, 8-byte w loads and 16-byte stores: the
// caller sets it only when K % 8 == 0, N % 4 == 0 and x, w, scale, y are
// 16-byte aligned.
extern "C" int gp_q_matmul(const void* x, const void* w, const float* scale,
                           float* y, int M, int N, int K, int is_fp8, int vec,
                           void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || (N + BN - 1) / BN > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((N + BN - 1) / BN));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const uint8_t* wb = static_cast<const uint8_t*>(w);
  if (is_fp8)
    q_matmul_kernel<true><<<grid, THREADS, 0, st>>>(xb, wb, scale, y, M, N, K, vec);
  else
    q_matmul_kernel<false><<<grid, THREADS, 0, st>>>(xb, wb, scale, y, M, N, K, vec);
  return (int)cudaGetLastError();
}
