// Device helpers shared by the pipelined dilated-branch kernels (forward,
// dq, dkv): a two-stage shared-memory ring filled with cp.async.
//
// A ring stage holds tiles in the input dtype, copied from device memory by
// cp.async.cg 16-byte copies (one commit group per stage). A kernel issues
// stage j+1, waits for stage j (cp.async.wait_group 1) and a barrier, then
// computes on stage j while stage j+1 is in flight. A bf16 stage is widened
// once into an fp32 work tile after it lands, so the inner loops read fp32
// rows with the broadcast float4 loads of branch_common.cuh.

#pragma once

#include <initializer_list>
#include <type_traits>

#include "branch_common.cuh"

namespace gp {

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's commit groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// This thread's share of a BYTES-byte contiguous copy from device memory
// into shared memory, in 16-byte pieces strided by the block's BM threads.
// Both addresses must be 16-byte aligned.
template <int BYTES>
__device__ __forceinline__ void cp_async_tile(void* dst, const void* src) {
  static_assert(BYTES % 16 == 0, "a staged tile is a whole number of 16-byte copies");
  constexpr int CHUNKS = BYTES / 16;
  char* d = static_cast<char*>(dst);
  const char* s = static_cast<const char*>(src);
#pragma unroll
  for (int i = 0; i < (CHUNKS + BM - 1) / BM; ++i) {
    const int c = threadIdx.x + i * BM;
    if (CHUNKS % BM == 0 || c < CHUNKS) cp_async16(d + 16 * c, s + 16 * c);
  }
}

// N staged elements of T into an fp32 work tile, each times `mul` and, when
// ROUND, rounded to T (16-byte aligned, N a multiple of 4).
template <typename T, int N, bool ROUND>
__device__ __forceinline__ void widen_tile(const T* src, float* dst, float mul) {
  static_assert(N % 4 == 0, "float4 stores need N % 4 == 0");
  constexpr int VECS = N / 4;
#pragma unroll
  for (int i = 0; i < (VECS + BM - 1) / BM; ++i) {
    const int e = 4 * (threadIdx.x + i * BM);
    if (VECS % BM == 0 || e < N) {
      float4 x;
      x.x = load_f32(src + e) * mul;
      x.y = load_f32(src + e + 1) * mul;
      x.z = load_f32(src + e + 2) * mul;
      x.w = load_f32(src + e + 3) * mul;
      if (ROUND) {
        x.x = round_to<T>(x.x);
        x.y = round_to<T>(x.y);
        x.z = round_to<T>(x.z);
        x.w = round_to<T>(x.w);
      }
      *reinterpret_cast<float4*>(dst + e) = x;
    }
  }
}

// The ring over a cell's key tiles (forward and dq): two stages of (K, V)
// BN x DH tiles in T, then, for bf16, the fp32 work tiles of K and V.
template <typename T, int DH, int BN>
struct KVRing {
  static constexpr int TILE = BN * DH;  // elements of one K or V tile
  static constexpr int TILE_BYTES = TILE * (int)sizeof(T);
  static constexpr int STAGE = 2 * TILE_BYTES;
  static constexpr bool WIDEN = !std::is_same<T, float>::value;
  static constexpr int BYTES = 2 * STAGE + (WIDEN ? 2 * TILE * 4 : 0);
  // a cell starts at a multiple of Mp*DH elements (Mp a multiple of BM) and
  // a key tile at a multiple of TILE, so both are 16-byte aligned from the
  // tensor's base
  static_assert((BM * DH * sizeof(T)) % 16 == 0 && TILE_BYTES % 16 == 0, "16-byte aligned tiles");
  static_assert(BYTES >= BM * DH * 4, "the row tiles are staged in the ring's memory");

  // start the copies of key tile (k, v) into `stage`
  __device__ static void issue(unsigned char* smem, int stage, const T* k, const T* v) {
    T* st = reinterpret_cast<T*>(smem + stage * STAGE);
    cp_async_tile<TILE_BYTES>(st, k);
    cp_async_tile<TILE_BYTES>(st + TILE, v);
  }

  // fp32 K rows of a landed stage (V rows TILE floats after them): the
  // stage itself in fp32, its widened work tiles in bf16 (behind a barrier)
  __device__ static const float* land(unsigned char* smem, int stage) {
    const T* st = reinterpret_cast<const T*>(smem + stage * STAGE);
    if constexpr (WIDEN) {
      float* work = reinterpret_cast<float*>(smem + 2 * STAGE);
      widen_tile<T, TILE, false>(st, work, 1.f);
      widen_tile<T, TILE, false>(st + TILE, work + TILE, 1.f);
      __syncthreads();
      return work;
    } else {
      return reinterpret_cast<const float*>(st);
    }
  }
};

// True when every pointer is 16-byte aligned (cp.async.cg's 16-byte copies)
__host__ inline bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<unsigned long long>(p) % 16 != 0) return false;
  return true;
}

}  // namespace gp
