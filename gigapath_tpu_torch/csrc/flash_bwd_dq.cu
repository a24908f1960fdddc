// dQ of segment-batched flash attention, in the segmented [B, H, S, M, D] or
// the flat [B, H, L, D] layout (see flash_common.cuh).
//
// Replaces the Pallas kernel gigapath_tpu/ops/pallas_flash.py:_dq_kernel,
// both where _bwd_impl calls it on segments (PERF.md row 12) and where
// _flat_bwd_impl calls it with flat=True (row 14). Inputs q, k, v and the
// output cotangent dout (fp32 or bf16); lse (the forward's) and delta =
// rowsum(dout * out), fp32, row for row with q; kvlen int32 [B, H, S] or null
// (flat: counts from real_len). Output dq in q's layout and dtype.
//
// For query row i and each valid key j (j < kv, and j <= i when causal),
// with the probabilities recomputed from the saved lse as the Pallas kernel
// does:
//   p_ij  = exp2((q_i.k_j) * scale*log2(e) - lse_i*log2(e))
//   ds_ij = p_ij * (dout_i.v_j - delta_i)
//   dq_i  = scale * sum_j round(ds_ij) k_j
// where round() is the Pallas kernel's cast of ds to k's dtype (bf16 for
// bf16 tensors). Key tiles at or past kv are never loaded (a row with no
// valid key, lse ~ -6.9e19, gets dq = 0). In the flat layout the rows of a
// segment at or past its count are computed like the others (the Pallas
// kernel leaves them unspecified).
//
// Bound on the H100: operations, 6*D per admitted (query, key) pair (q.k,
// dout.v, ds*k) at the dtype's peak, next to about 4*D elements moved per
// row; and one exp2 per admitted pair on the MUFU pipes (16 a clock per SM),
// as much time as the bf16 tensor cores' bound at D = 48.
//
// Two kernels, chosen by the tensors' dtype:
// - bf16 tensors (head widths that are multiples of 8): the tensor cores,
//   through the tile steps of bwd_mma.cuh (BwdMma::dq, which the dilated
//   branch's dq shares): 4 warps own 64 query rows of one cell as A
//   fragments, K and V stream through a two-stage cp.async ring, S and dP
//   on mma.sync, p by ex2.approx, bf16(dS) packed from C into A fragments
//   for dQ += dS.K. Registers are capped for 4 blocks an SM up to D = 64
//   (16 warps to hide latency).
// - fp32 tensors (a tensor-core product in fp32 would be TF32, another
//   function): the fp32 FMA pipes. One block owns a 64-row query tile and
//   loops over the key tiles itself; one thread per query row keeps q,
//   dout and the dq accumulator in registers; each K/V tile is staged once
//   in shared memory as fp32, rows past the count as zeros, and read by all
//   rows with broadcast float4 loads.

#include <cstdint>

#include "bwd_mma.cuh"  // BwdMma, flash_cell, the FMA helpers of flash_common.cuh

// The head width is a compile-time constant (q, dout and the accumulator
// live in registers): one library per head width, -DGP_HEAD_DIM=<D>.
#ifndef GP_HEAD_DIM
#error "compile with -DGP_HEAD_DIM=<head width>"
#endif
static_assert(GP_HEAD_DIM % 4 == 0 && GP_HEAD_DIM <= 128, "head width: a multiple of 4, at most 128");

namespace {

using namespace gp;

template <typename T, int DH, int BN>
__global__ void __launch_bounds__(BM)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        const int* __restrict__ kvlen, T* __restrict__ dq, int S, int Mq,
                        int Mk, int Lq, int Lk, int real_len, int causal, float qscale,
                        float scale, int n_qtiles) {
  static_assert(DH % 4 == 0, "float4 shared-memory reads need DH % 4 == 0");
  static_assert(2 * BN >= BM, "the row tiles are staged in the K/V buffer");
  __shared__ __align__(16) float smem[2 * BN * DH];
  float* ks = smem;
  float* vs = smem + BN * DH;

  const int tid = threadIdx.x;
  const int cell = blockIdx.x / n_qtiles;
  const int row0 = (blockIdx.x - cell * n_qtiles) * BM;
  const FlashCell c = flash_cell(cell, S, Mq, Mk, Lq, Lk, kvlen, real_len);
  if (row0 >= c.nq) return;  // past a flat layout's ragged last segment
  const int row = row0 + tid;
  const bool row_ok = row < c.nq;
  int kv = c.kv;
  if (causal && kv > row0 + BM) kv = row0 + BM;

  float qr[DH], dor[DH], acc[DH];
  stage_rows<T, DH, BM>(q + (c.q0 + row0) * DH, c.nq - row0, smem);
  __syncthreads();
  row_from_smem<DH>(smem, qr, 1.f);
  __syncthreads();
  stage_rows<T, DH, BM>(dout + (c.q0 + row0) * DH, c.nq - row0, smem);
  __syncthreads();
  row_from_smem<DH>(smem, dor, 1.f);
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;
  const float lse2 = row_ok ? lse[c.q0 + row] * LOG2E : 0.f;
  const float dlt = row_ok ? delta[c.q0 + row] : 0.f;

  const int n_tiles = (kv + BN - 1) / BN;
  for (int kt = 0; kt < n_tiles; ++kt) {
    __syncthreads();  // the previous tile (or the row staging) is consumed
    const int key0 = kt * BN;
    stage_rows<T, DH, BN>(k + (c.k0 + key0) * DH, kv - key0, ks);
    stage_rows<T, DH, BN>(v + (c.k0 + key0) * DH, kv - key0, vs);
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BN; ++j) {
      const float* kj = ks + j * DH;
      const float s = dot_smem<DH>(qr, kj) * qscale;
      const float dp = dot_smem<DH>(dor, vs + j * DH);
      const int col = key0 + j;
      const bool ok = col < kv && (!causal || col <= row);
      const float p = ok ? exp2f(s - lse2) : 0.f;
      axpy_smem<DH>(round_to<T>(p * (dp - dlt)), kj, acc);
    }
  }

  store_rows<T, DH>(acc, scale, smem, dq + (c.q0 + row0) * DH, c.nq - row0);
}

template <typename T, int DH, int BN>
int launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
           const float* delta, const int* kvlen, void* dq, int n_bh, int S, int Mq, int Mk,
           int Lq, int Lk, int real_len, int causal, float qscale, float scale,
           cudaStream_t stream) {
  const int n_qtiles = (Mq + BM - 1) / BM;
  const unsigned blocks = (unsigned)n_bh * (unsigned)S * (unsigned)n_qtiles;
  flash_bwd_dq_kernel<T, DH, BN><<<blocks, BM, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, kvlen, static_cast<T*>(dq), S, Mq, Mk, Lq, Lk,
      real_len, causal, qscale, scale, n_qtiles);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the tensor-core kernel (bf16 tensors)
// ---------------------------------------------------------------------------

template <int DH>
__global__ void __launch_bounds__(128, DH > 64 ? 2 : 4)
    flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            const int* __restrict__ kvlen, __nv_bfloat16* __restrict__ dq, int S, int Mq,
                            int Mk, int Lq, int Lk, int real_len, int causal, float qscale, float scale,
                            int n_qtiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cell = blockIdx.x / n_qtiles;
  const int row0 = (blockIdx.x - cell * n_qtiles) * 64;
  BwdMma<DH>::dq(q, k, v, dout, lse, delta, dq, flash_cell(cell, S, Mq, Mk, Lq, Lk, kvlen, real_len), row0,
                 causal, qscale, scale, smem);
}

template <int DH>
int launch_mma(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, const int* kvlen, void* dq, int n_bh, int S, int Mq, int Mk, int Lq,
               int Lk, int real_len, int causal, float qscale, float scale, cudaStream_t stream) {
  if constexpr (DH % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  } else {
    constexpr int SMEM = BwdMma<DH>::DQ_SMEM;
    const cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_mma_kernel<DH>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return (int)err;
    const int n_qtiles = (Mq + 63) / 64;
    const unsigned blocks = (unsigned)n_bh * (unsigned)S * (unsigned)n_qtiles;
    flash_bwd_dq_mma_kernel<DH><<<blocks, 128, SMEM, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), lse, delta, kvlen,
        static_cast<__nv_bfloat16*>(dq), S, Mq, Mk, Lq, Lk, real_len, causal, qscale, scale, n_qtiles);
    return (int)cudaGetLastError();
  }
}

}  // namespace

// is_bf16: 0 = fp32 tensors, 1 = bf16 tensors. n_bh = B*H; the layout as in
// flash_common.cuh; kvlen may be null (then real_len bounds the keys); fewer
// than 2^31 query tiles; D == GP_HEAD_DIM; qscale = D^-0.5 * log2(e), scale =
// D^-0.5. bf16 tensors take the tensor-core kernel, which needs a head width
// that is a multiple of 8 and q, k, v, dout and dq 16-byte aligned; fp32
// tensors the FMA kernel, whose key tiles are 64 rows, or 32 above a head
// width of 64.
extern "C" int gp_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                               const float* lse, const float* delta, const int* kvlen,
                               void* dq, int is_bf16, int n_bh, int S, int Mq, int Mk, int Lq,
                               int Lk, int real_len, int causal, float qscale, float scale,
                               void* stream) {
  constexpr int BN = GP_HEAD_DIM > 64 ? 32 : 64;
  if (!flash_layout_ok(n_bh, S, Mq, Mk, Lq, Lk, Mq, real_len))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_mma<GP_HEAD_DIM>(q, k, v, dout, lse, delta, kvlen, dq, n_bh, S, Mq, Mk, Lq, Lk,
                                   real_len, causal, qscale, scale, st);
  return launch<float, GP_HEAD_DIM, BN>(q, k, v, dout, lse, delta, kvlen, dq, n_bh, S, Mq, Mk,
                                        Lq, Lk, real_len, causal, qscale, scale, st);
}
