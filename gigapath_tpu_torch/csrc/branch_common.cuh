// Device helpers shared by the dilated-branch kernels (forward, dq, dkv).
//
// The FMA kernels compute in fp32 whatever their tensors' dtype: bf16 is
// widened on load, and rounded at the store and where the Pallas kernel
// casts to the input dtype before a matmul (round_to). Tiles are staged
// through shared memory in 64-row blocks, one row per thread, and rows of a
// staged tile are read with broadcast float4 loads (every thread of a warp
// reads the same address), so each shared-memory load feeds four FMAs.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace gp {

constexpr int BM = 64;  // rows per block, one per thread
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// x rounded to T and widened back: the Pallas kernels' .astype(dtype)
// before a matmul (a no-op in fp32)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (std::is_same<T, float>::value) {
    return x;
  } else {
    return __bfloat162float(__float2bfloat16(x));
  }
}

// dot(r, s) of a register row and a staged shared-memory row
template <int DH>
__device__ __forceinline__ float dot_smem(const float* r, const float* s) {
  float a = 0.f;
#pragma unroll
  for (int d = 0; d < DH; d += 4) {
    const float4 x4 = *reinterpret_cast<const float4*>(s + d);
    a = fmaf(r[d], x4.x, a);
    a = fmaf(r[d + 1], x4.y, a);
    a = fmaf(r[d + 2], x4.z, a);
    a = fmaf(r[d + 3], x4.w, a);
  }
  return a;
}

// acc += a * s for a staged shared-memory row s
template <int DH>
__device__ __forceinline__ void axpy_smem(float a, const float* s, float* acc) {
#pragma unroll
  for (int d = 0; d < DH; d += 4) {
    const float4 x4 = *reinterpret_cast<const float4*>(s + d);
    acc[d] = fmaf(a, x4.x, acc[d]);
    acc[d + 1] = fmaf(a, x4.y, acc[d + 1]);
    acc[d + 2] = fmaf(a, x4.z, acc[d + 2]);
    acc[d + 3] = fmaf(a, x4.w, acc[d + 3]);
  }
}

// This thread's row of a BM x DH tile, staged through shared memory (at
// least BM * DH floats) for coalesced global reads, into registers, times
// `mul`. Starts with a barrier: the buffer's previous contents are consumed.
template <typename T, int DH>
__device__ __forceinline__ void load_row(const T* tile, float* smem, float* row,
                                         float mul) {
  const int tid = threadIdx.x;
  __syncthreads();
  for (int e = tid; e < BM * DH; e += BM) smem[e] = load_f32(tile + e);
  __syncthreads();
#pragma unroll
  for (int d = 0; d < DH; ++d) row[d] = smem[tid * DH + d] * mul;
}

// Each thread's register row, times `mul`, into shared memory, then a
// coalesced store of the BM x DH tile.
template <typename T, int DH>
__device__ __forceinline__ void store_row(const float* row, float mul, float* smem,
                                          T* tile) {
  const int tid = threadIdx.x;
  __syncthreads();
#pragma unroll
  for (int d = 0; d < DH; ++d) smem[tid * DH + d] = row[d] * mul;
  __syncthreads();
  for (int e = tid; e < BM * DH; e += BM) store_f32(tile + e, smem[e]);
}

}  // namespace gp
