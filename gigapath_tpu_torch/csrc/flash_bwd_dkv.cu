// dK and dV of segment-batched flash attention, in the segmented [B, H, S, M,
// D] or the flat [B, H, L, D] layout (see flash_common.cuh).
//
// Replaces the Pallas kernel gigapath_tpu/ops/pallas_flash.py:_dkv_kernel,
// both where _bwd_impl calls it on segments (PERF.md row 12) and where
// _flat_bwd_impl calls it with flat=True (row 14). Inputs as
// flash_bwd_dq.cu; outputs dk, dv in k's layout and dtype.
//
// For key row j < kv of a segment and each contributing query row i (i >= j
// when causal), with p_ij and ds_ij as in the dq kernel (the FMA kernel
// folds the scale into k's registers, not into each logit), both fp32 as in
// the Pallas kernel:
//   dv_j = sum_i p_ij dout_i
//   dk_j = scale * sum_i ds_ij q_i
// The contributing query rows are the segment's rows (segmented) or, with
// `flat`, only its rows below the valid count: in the flat layout a row at
// or past real_len adds nothing to dK/dV, whatever its cotangent (the Pallas
// kernel's flat=True row mask). Key rows at or past kv are written as exact
// zeros, and a tile of them is skipped.
//
// Bound on the H100: operations, 8*D per admitted (query, key) pair (q.k,
// dout.v, p*dout, ds*q) at the dtype's peak, next to about 4*D elements
// moved per row; and one exp2 per admitted pair on the MUFU pipes (16 a
// clock per SM).
//
// Two kernels, chosen by the tensors' dtype:
// - bf16 tensors (head widths that are multiples of 8): the tensor cores,
//   through the tile steps of bwd_mma.cuh (BwdMma::dkv, which the dilated
//   branch's dkv shares): 4 warps own 64 keys of one cell as A fragments,
//   Q, dO, lse and delta stream through a two-stage cp.async ring, S^T and
//   dP^T with the keys as M, the Pallas kernel's fp32 p and ds each split
//   into bf16 hi + lo for dV += P^T.dO and dK += dS^T.Q. Registers are
//   capped for 3 blocks an SM up to D = 48; above a head width of 64 a
//   query tile is taken in two passes of 32 columns.
// - fp32 tensors: the fp32 FMA pipes. One block owns
//   a 64-row key tile and loops over the query tiles itself; one thread
//   per key row keeps k, v and the dk/dv accumulators in registers; each
//   query tile's q, dout, lse and delta are staged once in shared memory as
//   fp32 (rows past the contributing count as zeros) and read by all rows
//   with broadcast float4 loads.

#include <cstdint>

#include "bwd_mma.cuh"  // BwdMma, flash_cell, the FMA helpers of flash_common.cuh

// The head width is a compile-time constant (k, v and the accumulators live
// in registers): one library per head width, -DGP_HEAD_DIM=<D>.
#ifndef GP_HEAD_DIM
#error "compile with -DGP_HEAD_DIM=<head width>"
#endif
static_assert(GP_HEAD_DIM % 4 == 0 && GP_HEAD_DIM <= 128, "head width: a multiple of 4, at most 128");

namespace {

using namespace gp;

template <typename T, int DH, int BQ>
__global__ void __launch_bounds__(BM)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         const int* __restrict__ kvlen, T* __restrict__ dk,
                         T* __restrict__ dv, int S, int Mq, int Mk, int Lq, int Lk,
                         int real_len, int causal, int flat, float qscale, float scale,
                         int n_ktiles) {
  static_assert(DH % 4 == 0, "float4 shared-memory reads need DH % 4 == 0");
  static_assert(2 * BQ >= BM, "the key tiles are staged in the query buffers");
  __shared__ __align__(16) float smem[2 * BQ * DH + 2 * BQ];
  float* qs = smem;
  float* dos = smem + BQ * DH;
  float* ls = dos + BQ * DH;
  float* dls = ls + BQ;

  const int tid = threadIdx.x;
  const int cell = blockIdx.x / n_ktiles;
  const int key0 = (blockIdx.x - cell * n_ktiles) * BM;
  const FlashCell c = flash_cell(cell, S, Mq, Mk, Lq, Lk, kvlen, real_len);
  if (key0 >= c.nk) return;  // past a flat layout's ragged last segment
  T* dkt = dk + (c.k0 + key0) * DH;
  T* dvt = dv + (c.k0 + key0) * DH;
  const int kv = c.kv;
  if (key0 >= kv) {  // no valid key in this tile: exact zeros, no work
    const int lim = min(BM, c.nk - key0) * DH;
    for (int e = tid; e < lim; e += BM) {
      store_f32(dkt + e, 0.f);
      store_f32(dvt + e, 0.f);
    }
    return;
  }
  const int key = key0 + tid;
  const bool key_ok = key < kv;

  float kr[DH], vr[DH], dk_acc[DH], dv_acc[DH];
  stage_rows<T, DH, BM>(k + (c.k0 + key0) * DH, kv - key0, smem);
  __syncthreads();
  row_from_smem<DH>(smem, kr, qscale);
  __syncthreads();
  stage_rows<T, DH, BM>(v + (c.k0 + key0) * DH, kv - key0, smem);
  __syncthreads();
  row_from_smem<DH>(smem, vr, 1.f);
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    dk_acc[d] = 0.f;
    dv_acc[d] = 0.f;
  }

  const int q_end = flat ? kv : c.nq;  // query rows that contribute
  // causal: query rows below the key tile see none of its keys
  const int q_start = causal ? (key0 / BQ) * BQ : 0;
  for (int q0 = q_start; q0 < q_end; q0 += BQ) {
    __syncthreads();  // the previous tile (or the row staging) is consumed
    const int n_i = min(BQ, q_end - q0);
    stage_rows<T, DH, BQ>(q + (c.q0 + q0) * DH, n_i, qs);
    stage_rows<T, DH, BQ>(dout + (c.q0 + q0) * DH, n_i, dos);
    for (int e = tid; e < BQ; e += BM) {
      ls[e] = e < n_i ? lse[c.q0 + q0 + e] * LOG2E : 0.f;
      dls[e] = e < n_i ? delta[c.q0 + q0 + e] : 0.f;
    }
    __syncthreads();

    // not unrolled: the 4*D accumulator registers leave no room to hold a
    // second query row's operands; a constant trip count (the rows past
    // n_i are staged as zeros and masked) keeps the loop's own registers few
#pragma unroll 1
    for (int i = 0; i < BQ; ++i) {
      const float* qi = qs + i * DH;
      const float* doi = dos + i * DH;
      const float s = dot_smem<DH>(kr, qi);
      const float dp = dot_smem<DH>(vr, doi);
      const bool ok = key_ok && i < n_i && (!causal || key <= q0 + i);
      const float p = ok ? exp2f(s - ls[i]) : 0.f;
      const float ds = p * (dp - dls[i]);
      axpy_smem<DH>(p, doi, dv_acc);
      axpy_smem<DH>(ds, qi, dk_acc);
    }
  }

  store_rows<T, DH>(dk_acc, scale, smem, dkt, c.nk - key0);
  store_rows<T, DH>(dv_acc, 1.f, smem, dvt, c.nk - key0);
}

template <typename T, int DH, int BQ>
int launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
           const float* delta, const int* kvlen, void* dk, void* dv, int n_bh, int S, int Mq,
           int Mk, int Lq, int Lk, int real_len, int causal, int flat, float qscale,
           float scale, cudaStream_t stream) {
  const int n_ktiles = (Mk + BM - 1) / BM;
  const unsigned blocks = (unsigned)n_bh * (unsigned)S * (unsigned)n_ktiles;
  flash_bwd_dkv_kernel<T, DH, BQ><<<blocks, BM, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, kvlen, static_cast<T*>(dk),
      static_cast<T*>(dv), S, Mq, Mk, Lq, Lk, real_len, causal, flat, qscale, scale,
      n_ktiles);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the tensor-core kernel (bf16 tensors)
// ---------------------------------------------------------------------------

template <int DH>
__global__ void __launch_bounds__(128, DH > 48 ? 2 : 3)
    flash_bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             const int* __restrict__ kvlen, __nv_bfloat16* __restrict__ dk,
                             __nv_bfloat16* __restrict__ dv, int S, int Mq, int Mk, int Lq, int Lk,
                             int real_len, int causal, int flat, float qscale, float scale, int n_ktiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cell = blockIdx.x / n_ktiles;
  const int key0 = (blockIdx.x - cell * n_ktiles) * 64;
  BwdMma<DH>::dkv(q, k, v, dout, lse, delta, dk, dv, flash_cell(cell, S, Mq, Mk, Lq, Lk, kvlen, real_len), key0,
                  causal, flat, qscale, scale, smem);
}

template <int DH>
int launch_mma(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, const int* kvlen, void* dk, void* dv, int n_bh, int S, int Mq, int Mk,
               int Lq, int Lk, int real_len, int causal, int flat, float qscale, float scale,
               cudaStream_t stream) {
  if constexpr (DH % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  } else {
    constexpr int SMEM = BwdMma<DH>::DKV_SMEM;
    const cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_mma_kernel<DH>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return (int)err;
    const int n_ktiles = (Mk + 63) / 64;
    const unsigned blocks = (unsigned)n_bh * (unsigned)S * (unsigned)n_ktiles;
    flash_bwd_dkv_mma_kernel<DH><<<blocks, 128, SMEM, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), lse, delta, kvlen,
        static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), S, Mq, Mk, Lq, Lk, real_len, causal,
        flat, qscale, scale, n_ktiles);
    return (int)cudaGetLastError();
  }
}

}  // namespace

// is_bf16: 0 = fp32 tensors, 1 = bf16 tensors. n_bh = B*H; the layout as in
// flash_common.cuh; kvlen may be null (then real_len bounds the keys); flat:
// only a segment's query rows below its valid count contribute; fewer than
// 2^31 key tiles; D == GP_HEAD_DIM; qscale = D^-0.5 * log2(e), scale =
// D^-0.5. bf16 tensors take the tensor-core kernel, which needs a head width
// that is a multiple of 8 and q, k, v, dout, dk and dv 16-byte aligned;
// fp32 tensors the FMA kernel, which stages query tiles of 64 rows, or 32
// above a head width of 64.
extern "C" int gp_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                const float* lse, const float* delta, const int* kvlen,
                                void* dk, void* dv, int is_bf16, int n_bh, int S, int Mq,
                                int Mk, int Lq, int Lk, int real_len, int causal, int flat,
                                float qscale, float scale, void* stream) {
  constexpr int BQ = GP_HEAD_DIM > 64 ? 32 : 64;
  if (!flash_layout_ok(n_bh, S, Mq, Mk, Lq, Lk, Mk, real_len))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_mma<GP_HEAD_DIM>(q, k, v, dout, lse, delta, kvlen, dk, dv, n_bh, S, Mq, Mk, Lq, Lk,
                                   real_len, causal, flat, qscale, scale, st);
  return launch<float, GP_HEAD_DIM, BQ>(q, k, v, dout, lse, delta, kvlen, dk, dv, n_bh, S, Mq,
                                        Mk, Lq, Lk, real_len, causal, flat, qscale, scale, st);
}
