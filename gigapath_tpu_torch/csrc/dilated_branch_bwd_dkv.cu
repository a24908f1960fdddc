// dK and dV of one dilated branch on the phase-major packed layout.
//
// Replaces the Pallas kernel gigapath_tpu/ops/pallas_dilated.py:_dkv_kernel
// (called by _bwd_impl; PERF.md row 7b). Inputs as
// csrc/dilated_branch_bwd_dq.cu: q, k, v, dout packed [B, S, r, hb, Mp, Dh]
// (fp32 or bf16), lse and delta fp32 [B, S, r, hb, Mp], kvlen int32 [B, S,
// r]. Outputs dk, dv in the packed layout and input dtype.
//
// For key row j of cell (b, s, p, t), j < kvlen, and each query row i (i >= j
// when causal), with p_ij and ds_ij as in the dq kernel, both fp32 as in the
// Pallas kernel:
//   dv_j = sum_i p_ij dout_i
//   dk_j = scale * sum_i ds_ij q_i
// A key tile at or past kvlen is written as zeros and its work skipped (its
// lse-relative exponents are never computed); inside the partial tile the
// keys past kvlen get p = 0 by select, so their rows are exactly 0 as well.
// Padded query rows (zero q and dout, delta 0) add exactly 0.
//
// Bound on the H100: operations, 8*Dh per valid (query, key) pair (q.k,
// dout.v, p*dout, ds*q) at the dtype's peak, next to about 4*Dh elements
// moved per row; and one exp2 per valid pair on the MUFU pipes.
//
// Two kernels, chosen by the tensors' dtype:
// - bf16 tensors (head widths that are multiples of 8): the tensor cores,
//   through the tile steps of bwd_mma.cuh (BwdMma::dkv, shared with the
//   segment-flash dkv) on the cell map branch_cell (see
//   dilated_branch_bwd_dq.cu). 4 warps own 64 keys of one cell and hold its
//   K and V as A fragments; Q, dO, lse and delta stream through a two-stage
//   cp.async ring. With the keys as the M dimension, S^T = K.Q^T and dP^T =
//   V.dO^T come out of C already in the A-fragment layout of dV += P^T.dO
//   and dK += dS^T.Q. The Pallas kernel keeps p and ds in fp32 for these two
//   products, so each is split into bf16 hi + lo (two MMAs into one fp32
//   sum). Causal query tiles start at the key tile's diagonal. Registers
//   are capped for 3 blocks an SM up to Dh = 48; above a head width of 64 a
//   query tile is taken in two passes of 32 columns.
// - fp32 tensors (a tensor-core product in fp32 would be TF32): the fp32
//   FMA pipes. One block owns a 64-row key tile and loops over every query
//   tile itself (no atomics: the same result from run to run); one thread
//   per key row keeps k, v and the dk/dv accumulators in registers (4*Dh
//   values: 192 at the flagship's Dh = 48, where ptxas spills a few hundred
//   bytes, more above it); each query tile's q, dout, lse and delta are
//   staged once in shared memory and read by all rows with broadcast float4
//   loads.

#include <cstdint>

#include "bwd_mma.cuh"  // BwdMma, branch_cell

// The head width is a compile-time constant (k, v and the accumulators live
// in registers): one library per head width, -DGP_HEAD_DIM=<Dh>.
#ifndef GP_HEAD_DIM
#error "compile with -DGP_HEAD_DIM=<head width>"
#endif
static_assert(GP_HEAD_DIM % 4 == 0 && GP_HEAD_DIM <= 128, "head width: a multiple of 4, at most 128");

namespace {

using namespace gp;

template <typename T, int DH, int BQ>
__global__ void __launch_bounds__(BM)
    dilated_branch_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                  const T* __restrict__ v,
                                  const T* __restrict__ dout,
                                  const float* __restrict__ lse,
                                  const float* __restrict__ delta,
                                  const int* __restrict__ kvlen,
                                  T* __restrict__ dk, T* __restrict__ dv, int HB,
                                  int Mp, int causal, float qscale, float scale) {
  static_assert(DH % 4 == 0, "float4 shared-memory reads need DH % 4 == 0");
  static_assert(2 * BQ >= BM, "the key tiles are staged in the query buffers");
  __shared__ __align__(16) float smem[2 * BQ * DH + 2 * BQ];
  float* qs = smem;
  float* dos = smem + BQ * DH;
  float* ls = dos + BQ * DH;
  float* dls = ls + BQ;

  const int tid = threadIdx.x;
  const int n_ktiles = Mp / BM;
  const int cell = blockIdx.x / n_ktiles;  // ((b*S + s)*r + p)*hb + t
  const int key0 = (blockIdx.x - cell * n_ktiles) * BM;
  const int key = key0 + tid;
  const long long base = (long long)cell * Mp * DH;
  const long long tile = base + (long long)key0 * DH;

  int kv = kvlen[cell / HB];
  kv = kv < Mp ? kv : Mp;
  if (key0 >= kv) {  // no valid key in this tile: exact zeros, no work
    for (int e = tid; e < BM * DH; e += BM) {
      store_f32(dk + tile + e, 0.f);
      store_f32(dv + tile + e, 0.f);
    }
    return;
  }
  const bool key_ok = key < kv;

  float kr[DH], vr[DH], dk_acc[DH], dv_acc[DH];
  load_row<T, DH>(k + tile, smem, kr, qscale);
  load_row<T, DH>(v + tile, smem, vr, 1.f);
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    dk_acc[d] = 0.f;
    dv_acc[d] = 0.f;
  }

  // causal: query rows below the key tile see none of its keys
  const int q_start = causal ? (key0 / BQ) * BQ : 0;
  for (int q0 = q_start; q0 < Mp; q0 += BQ) {
    __syncthreads();  // the previous tile (or the row staging) is consumed
    const long long off = base + (long long)q0 * DH;
    for (int e = tid; e < BQ * DH; e += BM) {
      qs[e] = load_f32(q + off + e);
      dos[e] = load_f32(dout + off + e);
    }
    for (int e = tid; e < BQ; e += BM) {
      ls[e] = lse[(long long)cell * Mp + q0 + e] * LOG2E;
      dls[e] = delta[(long long)cell * Mp + q0 + e];
    }
    __syncthreads();

    // not unrolled: the 4*Dh accumulator registers leave no room to hold
    // a second query row's operands, and unrolling spills more
#pragma unroll 1
    for (int i = 0; i < BQ; ++i) {
      const float* qi = qs + i * DH;
      const float* doi = dos + i * DH;
      const float s = dot_smem<DH>(kr, qi);
      const float dp = dot_smem<DH>(vr, doi);
      const bool ok = key_ok && (!causal || key <= q0 + i);
      const float p = ok ? exp2f(s - ls[i]) : 0.f;
      const float ds = p * (dp - dls[i]);
      axpy_smem<DH>(p, doi, dv_acc);
      axpy_smem<DH>(ds, qi, dk_acc);
    }
  }

  store_row<T, DH>(dk_acc, scale, smem, dk + tile);
  store_row<T, DH>(dv_acc, 1.f, smem, dv + tile);
}

template <typename T, int DH, int BQ>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, const int* kvlen, void* dk,
           void* dv, int n_cells, int HB, int Mp, int causal, float qscale,
           float scale, cudaStream_t stream) {
  const unsigned blocks = (unsigned)n_cells * (unsigned)(Mp / BM);
  dilated_branch_bwd_dkv_kernel<T, DH, BQ><<<blocks, BM, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta, kvlen,
      static_cast<T*>(dk), static_cast<T*>(dv), HB, Mp, causal, qscale, scale);
  return (int)cudaGetLastError();
}

template <int DH>
__global__ void __launch_bounds__(128, DH > 48 ? 2 : 3)
    dilated_branch_bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                                      const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                                      const float* __restrict__ lse, const float* __restrict__ delta,
                                      const int* __restrict__ kvlen, __nv_bfloat16* __restrict__ dk,
                                      __nv_bfloat16* __restrict__ dv, int HB, int Mp, int causal, float qscale,
                                      float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_ktiles = Mp / 64;
  const int cell = blockIdx.x / n_ktiles;  // ((b*S + s)*r + p)*hb + t
  const int key0 = (blockIdx.x - cell * n_ktiles) * 64;
  BwdMma<DH>::dkv(q, k, v, dout, lse, delta, dk, dv, branch_cell(cell, HB, Mp, kvlen), key0, causal, 0, qscale,
                  scale, smem);
}

template <int DH>
int launch_mma(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, const int* kvlen, void* dk, void* dv, int n_cells, int HB, int Mp,
               int causal, float qscale, float scale, cudaStream_t stream) {
  if constexpr (DH % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  } else {
    constexpr int SMEM = BwdMma<DH>::DKV_SMEM;
    const cudaError_t err = cudaFuncSetAttribute(dilated_branch_bwd_dkv_mma_kernel<DH>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return (int)err;
    const unsigned blocks = (unsigned)n_cells * (unsigned)(Mp / 64);
    dilated_branch_bwd_dkv_mma_kernel<DH><<<blocks, 128, SMEM, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), lse, delta, kvlen,
        static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), HB, Mp, causal, qscale, scale);
    return (int)cudaGetLastError();
  }
}

}  // namespace

// is_bf16: 0 = fp32 tensors, 1 = bf16 tensors. n_cells = B*S*r*hb, Mp a
// positive multiple of 64, n_cells * Mp/64 blocks below 2^31, Dh ==
// GP_HEAD_DIM; qscale = Dh^-0.5 * log2(e), scale = Dh^-0.5. bf16 tensors
// take the tensor-core kernel, which needs a head width that is a multiple
// of 8 and q, k, v, dout, dk and dv 16-byte aligned; fp32 tensors the FMA
// kernel, which stages query tiles of 64 rows, or 32 above a head width of
// 64.
extern "C" int gp_dilated_branch_bwd_dkv(const void* q, const void* k,
                                         const void* v, const void* dout,
                                         const float* lse, const float* delta,
                                         const int* kvlen, void* dk, void* dv,
                                         int is_bf16, int n_cells, int HB, int Mp,
                                         int Dh, int causal, float qscale,
                                         float scale, void* stream) {
  constexpr int BQ = GP_HEAD_DIM > 64 ? 32 : 64;
  if (Dh != GP_HEAD_DIM || Mp <= 0 || Mp % BM != 0 || n_cells <= 0 ||
      (long long)n_cells * (Mp / BM) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_mma<GP_HEAD_DIM>(q, k, v, dout, lse, delta, kvlen, dk, dv, n_cells, HB, Mp, causal, qscale,
                                   scale, st);
  return launch<float, GP_HEAD_DIM, BQ>(q, k, v, dout, lse, delta, kvlen, dk, dv,
                                        n_cells, HB, Mp, causal, qscale, scale, st);
}
