// dQ of one dilated branch on the phase-major packed layout, pipelined.
//
// Replaces the Pallas kernel gigapath_tpu/ops/pallas_dilated.py:_dq_kernel_pipe
// (called by _bwd_impl_pipe; PERF.md row 8a). The contract is
// csrc/dilated_branch_bwd_dq.cu's, non-causal only: q, k, v and the output
// cotangent dout packed [B, S, r, hb, Mp, Dh] (fp32 or bf16), lse (the
// forward's) and delta = rowsum(dout * out) fp32 [B, S, r, hb, Mp], kvlen
// int32 [B, S, r]; dq in the packed layout and input dtype.
//
// Numerics follow the pipelined Pallas kernel, for query row i and valid key
// j (j < kvlen):
//   s_ij  = round(q_i * scale*log2(e)) . k_j          (fp32 sum)
//   p_ij  = exp2(s_ij - lse_i*log2(e))
//   ds_ij = p_ij * (dout_i . v_j - delta_i)            (fp32)
//   dq_i  = scale * sum_j round(ds_ij) k_j             (fp32 sum)
// where round() is the rounding to the input dtype (a no-op in fp32). The
// serial kernel, as the serial Pallas one, keeps q*scale unrounded and
// rounds ds alike; that one rounding is all that tells the two functions
// apart. Key tiles past kvlen are never loaded (a cell with kvlen = 0 has
// lse ~ -6.9e19 and takes no exp2); inside the partial tile the keys past
// kvlen get p = 0 by select. Padded rows (zero q and dout) come out exactly
// 0.
//
// Bound on the H100: operations, 6*Dh per valid (query, key) pair (q.k,
// dout.v, ds*k) at the dtype's peak, next to about 4*Dh elements moved per
// row; and one exp2 per valid pair on the MUFU pipes (16 a clock per SM).
//
// Two kernels, chosen by the tensors' dtype:
// - bf16 tensors (head widths that are multiples of 8): the tensor cores,
//   through the tile steps of bwd_mma.cuh (BwdMma::dq with
//   Logits::ROUNDED_Q, shared with the serial dq, row 7, and the
//   segment-flash dq) on the cell map branch_cell, with row 7's grid,
//   launch bounds and shared memory. 4 warps own one (cell, 64-row query
//   tile); Q's A fragments are loaded once, multiplied by scale*log2(e) and
//   rounded to bf16 in registers (the forward's load_q rounding), dO's as
//   they are; K and V tiles of 64 keys stream through a two-stage cp.async
//   ring, the next tile in flight while the current one computes, so the
//   Pallas kernel's flattened (head, key block) grid, a TPU device to
//   overlap the MXU with the VPU, has no counterpart here. S = Q.K^T and dP
//   = dO.V^T on mma.sync.m16n8k16, p = ex2.approx(s - lse*log2(e)), the
//   mask by select, ds rounded to bf16 and packed from the C into the A
//   fragments of dq += ds.K.
// - fp32 tensors (a tensor-core product in fp32 would be TF32, another
//   function): the fp32 FMA pipes, one block per (cell, 64-row query tile),
//   one thread per query row with q, dout and the dq accumulator in
//   registers; the cell's K and V tiles streamed through the two-stage
//   cp.async ring of pipe_common.cuh, tile j+1 in flight while tile j's
//   math runs. Key-stage width BN = 64 (32 above a head width of 64);
//   dynamic shared memory 48 KiB at Dh = 48.
//
// Both keep one flat grid on blockIdx.x, the query tiles of a cell
// adjacent, so more than 65535 cells take no second grid dimension.

#include <cstdint>

#include "bwd_mma.cuh"  // BwdMma, branch_cell
#include "pipe_common.cuh"

#ifndef GP_HEAD_DIM
#error "compile with -DGP_HEAD_DIM=<head width>"
#endif
static_assert(GP_HEAD_DIM % 4 == 0 && GP_HEAD_DIM <= 128, "head width: a multiple of 4, at most 128");

namespace {

using namespace gp;

template <int DH, int BN>
__global__ void __launch_bounds__(BM)
    dilated_branch_bwd_dq_pipe_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                      const float* __restrict__ v,
                                      const float* __restrict__ dout,
                                      const float* __restrict__ lse,
                                      const float* __restrict__ delta,
                                      const int* __restrict__ kvlen,
                                      float* __restrict__ dq, int HB, int Mp,
                                      float qscale, float scale) {
  using Ring = KVRing<float, DH, BN>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* smem_f = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int n_qtiles = Mp / BM;
  const int cell = blockIdx.x / n_qtiles;  // ((b*S + s)*r + p)*hb + t
  const int row0 = (blockIdx.x - cell * n_qtiles) * BM;
  const int row = row0 + tid;
  const long long base = (long long)cell * Mp * DH;
  const long long tile = base + (long long)row0 * DH;

  int kv = kvlen[cell / HB];
  kv = kv < Mp ? kv : Mp;

  float qr[DH], dor[DH], acc[DH];
  load_row<float, DH>(q + tile, smem_f, qr, qscale);
  load_row<float, DH>(dout + tile, smem_f, dor, 1.f);
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;
  const float lse2 = lse[(long long)cell * Mp + row] * LOG2E;
  const float dlt = delta[(long long)cell * Mp + row];

  const int n_tiles = (kv + BN - 1) / BN;
  __syncthreads();  // the row staging is consumed before the ring overwrites it
  if (n_tiles > 0) Ring::issue(smem, 0, k + base, v + base);
  cp_async_commit();
  for (int kt = 0; kt < n_tiles; ++kt) {
    __syncthreads();  // every thread is done with tile kt - 1: its stage may refill
    if (kt + 1 < n_tiles) {
      const long long off = base + (long long)(kt + 1) * Ring::TILE;
      Ring::issue(smem, (kt + 1) & 1, k + off, v + off);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of tile kt have landed
    __syncthreads();     // and every thread's
    const float* ks = Ring::land(smem, kt & 1);
    const float* vs = ks + Ring::TILE;

    const int key0 = kt * BN;
#pragma unroll 4
    for (int j = 0; j < BN; ++j) {
      const float* kj = ks + j * DH;
      const float s = dot_smem<DH>(qr, kj);
      const float dp = dot_smem<DH>(dor, vs + j * DH);
      const float p = key0 + j < kv ? exp2f(s - lse2) : 0.f;
      axpy_smem<DH>(p * (dp - dlt), kj, acc);
    }
  }
  cp_async_wait<0>();

  store_row<float, DH>(acc, scale, smem_f, dq + tile);
}

template <int DH, int BN>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, const int* kvlen, void* dq,
           int n_cells, int HB, int Mp, float qscale, float scale, cudaStream_t stream) {
  constexpr int bytes = KVRing<float, DH, BN>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(dilated_branch_bwd_dq_pipe_kernel<DH, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         bytes);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)n_cells * (unsigned)(Mp / BM);
  dilated_branch_bwd_dq_pipe_kernel<DH, BN><<<blocks, BM, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, delta, kvlen, static_cast<float*>(dq), HB, Mp, qscale, scale);
  return (int)cudaGetLastError();
}

template <int DH>
__global__ void __launch_bounds__(128, DH > 64 ? 2 : 4)
    dilated_branch_bwd_dq_pipe_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                                          const __nv_bfloat16* __restrict__ v,
                                          const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                                          const float* __restrict__ delta, const int* __restrict__ kvlen,
                                          __nv_bfloat16* __restrict__ dq, int HB, int Mp, float qscale,
                                          float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_qtiles = Mp / 64;
  const int cell = blockIdx.x / n_qtiles;  // ((b*S + s)*r + p)*hb + t
  const int row0 = (blockIdx.x - cell * n_qtiles) * 64;
  BwdMma<DH>::template dq<Logits::ROUNDED_Q>(q, k, v, dout, lse, delta, dq, branch_cell(cell, HB, Mp, kvlen), row0,
                                             0, qscale, scale, smem);
}

template <int DH>
int launch_mma(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, const int* kvlen, void* dq, int n_cells, int HB, int Mp, float qscale,
               float scale, cudaStream_t stream) {
  if constexpr (DH % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  } else {
    constexpr int SMEM = BwdMma<DH>::DQ_SMEM;
    const cudaError_t err = cudaFuncSetAttribute(dilated_branch_bwd_dq_pipe_mma_kernel<DH>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return (int)err;
    const unsigned blocks = (unsigned)n_cells * (unsigned)(Mp / 64);
    dilated_branch_bwd_dq_pipe_mma_kernel<DH><<<blocks, 128, SMEM, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), lse, delta, kvlen,
        static_cast<__nv_bfloat16*>(dq), HB, Mp, qscale, scale);
    return (int)cudaGetLastError();
  }
}

}  // namespace

// is_bf16: 0 = fp32 tensors, 1 = bf16 tensors. n_cells = B*S*r*hb, Mp a
// positive multiple of 64, n_cells * Mp/64 blocks below 2^31, Dh ==
// GP_HEAD_DIM, k/v 16-byte aligned (the ring's cp.async copies); qscale =
// Dh^-0.5 * log2(e), scale = Dh^-0.5. bf16 tensors take the tensor-core
// kernel, which needs a head width that is a multiple of 8 and q, k, v,
// dout and dq 16-byte aligned; fp32 tensors the FMA kernel.
extern "C" int gp_dilated_branch_bwd_dq_pipe(const void* q, const void* k,
                                             const void* v, const void* dout,
                                             const float* lse, const float* delta,
                                             const int* kvlen, void* dq, int is_bf16,
                                             int n_cells, int HB, int Mp, int Dh,
                                             float qscale, float scale, void* stream) {
  constexpr int BN = GP_HEAD_DIM > 64 ? 32 : 64;
  if (Dh != GP_HEAD_DIM || Mp <= 0 || Mp % BM != 0 || n_cells <= 0 ||
      (long long)n_cells * (Mp / BM) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (!gp::aligned16({k, v})) return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_mma<GP_HEAD_DIM>(q, k, v, dout, lse, delta, kvlen, dq, n_cells, HB, Mp, qscale, scale, st);
  return launch<GP_HEAD_DIM, BN>(q, k, v, dout, lse, delta, kvlen, dq, n_cells, HB, Mp, qscale, scale, st);
}
