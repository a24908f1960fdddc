// Device helpers shared by the segment-flash kernels (forward, dq, dkv).
//
// The three kernels read one of two layouts through the same description:
// n_bh = B*H (batch, head) pairs, each with S segments; segment s of pair bh
// holds query rows [s*Mq, s*Mq + nq) of the pair's Lq rows and key rows
// [s*Mk, s*Mk + nk) of its Lk rows, nq = min(Mq, Lq - s*Mq) (nk alike).
//   segmented [B, H, S, M, D]: Lq = S*Mq, Lk = S*Mk, every segment whole;
//   flat [B, H, L, D]:         Mq = Mk = g, Lq = Lk = L, the last segment
//                              ragged (nq = nk = L - (S-1)*g).
// A segment's valid keys are rows [0, kv): kv = kvlen[bh*S + s] when the
// count table is given, else clip(real_len - s*Mk, 0, Mk); never more than
// nk. No kernel reads or writes a row past nq / nk, and key rows at or past
// kv are zeros in shared memory before any product (a flat segment's keys
// past real_len are real rows of the next tokens, and are never read).

#pragma once

#include "branch_common.cuh"
#include "mma_common.cuh"

namespace gp {

constexpr float FLASH_M_FLOOR = -1e20f;  // running-max floor
constexpr float FLASH_NEG_INF = -1e30f;  // masked logit

struct FlashCell {
  long long q0, k0;  // first query / key row of the segment (rows of D elements)
  int nq, nk;        // query / key rows the segment holds in memory
  int kv;            // valid keys: rows [0, kv)
};

__device__ __forceinline__ FlashCell flash_cell(int cell, int S, int Mq, int Mk, int Lq,
                                                int Lk, const int* kvlen, int real_len) {
  const int bh = cell / S;
  const int s = cell - bh * S;
  FlashCell c;
  c.q0 = (long long)bh * Lq + (long long)s * Mq;
  c.k0 = (long long)bh * Lk + (long long)s * Mk;
  c.nq = min(Mq, Lq - s * Mq);
  c.nk = min(Mk, Lk - s * Mk);
  const int kv = kvlen != nullptr ? kvlen[cell] : real_len - s * Mk;
  c.kv = max(0, min(kv, c.nk));
  return c;
}

// Rows [0, n) of a BR x DH tile at src into shared memory as fp32, rows
// [n, BR) as zeros (n may be <= 0 or >= BR), by a block of BM threads.
// Coalesced: consecutive threads read consecutive elements. The trip count
// and stride are compile-time constants, so the loop unrolls and each
// thread's loads are in flight together.
template <typename T, int DH, int BR>
__device__ __forceinline__ void stage_rows(const T* src, int n, float* dst) {
  const int lim = max(0, min(n, BR)) * DH;
#pragma unroll
  for (int e = threadIdx.x; e < BR * DH; e += BM) dst[e] = e < lim ? load_f32(src + e) : 0.f;
}

// This thread's row of a staged BM x DH tile into registers, times mul.
template <int DH>
__device__ __forceinline__ void row_from_smem(const float* smem, float* row, float mul) {
#pragma unroll
  for (int d = 0; d < DH; d += 4) {
    const float4 x4 = *reinterpret_cast<const float4*>(smem + threadIdx.x * DH + d);
    row[d] = x4.x * mul;
    row[d + 1] = x4.y * mul;
    row[d + 2] = x4.z * mul;
    row[d + 3] = x4.w * mul;
  }
}

// Each thread's register row, times mul, through shared memory (at least BM
// * DH floats) into rows [0, n) of the BM x DH tile at dst; rows past n are
// not written. Starts with a barrier: the buffer's previous contents are
// consumed.
template <typename T, int DH>
__device__ __forceinline__ void store_rows(const float* row, float mul, float* smem, T* dst,
                                           int n) {
  __syncthreads();
#pragma unroll
  for (int d = 0; d < DH; ++d) smem[threadIdx.x * DH + d] = row[d] * mul;
  __syncthreads();
  const int lim = max(0, min(n, BM)) * DH;
#pragma unroll
  for (int e = threadIdx.x; e < BM * DH; e += BM)
    if (e < lim) store_f32(dst + e, smem[e]);
}

// The checks every entry point makes on the layout: one block per 64-row
// tile of each segment, the grid's size in one dimension.
__host__ inline bool flash_layout_ok(int n_bh, int S, int Mq, int Mk, int Lq, int Lk,
                                     int rows_per_cell, int real_len) {
  if (n_bh <= 0 || S <= 0 || Mq <= 0 || Mk <= 0) return false;
  if (Lq <= (S - 1) * (long long)Mq || Lq > S * (long long)Mq) return false;
  if (Lk <= (S - 1) * (long long)Mk || Lk > S * (long long)Mk) return false;
  if (real_len < 0) return false;
  const long long tiles = (long long)n_bh * S * ((rows_per_cell + BM - 1) / BM);
  return tiles < 0x7fffffffLL;
}

}  // namespace gp
