// dQ of one dilated branch on the phase-major packed layout.
//
// Replaces the Pallas kernel gigapath_tpu/ops/pallas_dilated.py:_dq_kernel
// (called by _bwd_impl; PERF.md row 7a). Inputs q, k, v and the output
// cotangent dout are packed [B, S, r, hb, Mp, Dh] (fp32 or bf16); lse (the
// forward's) and delta = rowsum(dout * out) are fp32 [B, S, r, hb, Mp];
// kvlen is int32 [B, S, r]. Output dq in the packed layout and input dtype.
//
// For query row i of cell (b, s, p, t) and each valid key j (j < kvlen, and
// j <= i when causal), with the probabilities recomputed from the saved lse:
//   p_ij  = exp2(q_i.k_j * scale*log2(e) - lse_i*log2(e))
//   ds_ij = p_ij * (dout_i.v_j - delta_i)
//   dq_i  = scale * sum_j round(ds_ij) k_j
// where round() is the Pallas kernel's cast of ds to k's dtype (bf16 for
// bf16 tensors). Key tiles at or past kvlen are never loaded (a cell with
// kvlen = 0 has lse ~ -6.9e19, where exp2 would overflow): only the partial
// tile masks its columns, by select. Padded rows (zero q and dout) come out
// exactly 0.
//
// Bound on the H100: operations, 6*Dh per valid (query, key) pair (q.k,
// dout.v, ds*k) at the dtype's peak, next to about 4*Dh elements moved per
// row; and one exp2 per valid pair on the MUFU pipes (16 a clock per SM),
// nearly as much time as the bf16 tensor cores' bound at Dh = 48.
//
// Two kernels, chosen by the tensors' dtype:
// - bf16 tensors (head widths that are multiples of 8): the tensor cores,
//   through the tile steps of bwd_mma.cuh (BwdMma::dq, shared with the
//   segment-flash dq) on this file's cell map, branch_cell: cell ((b*S +
//   s)*r + p)*hb + t is a contiguous [Mp, Dh] block with kvlen[cell / hb]
//   valid keys. 4 warps own one (cell, 64-row query tile) and hold its Q
//   and dO as A fragments; K and V tiles of 64 keys stream through a
//   two-stage cp.async ring, zero-filled past kvlen; S = Q.K^T and dP =
//   dO.V^T on mma.sync.m16n8k16; p = ex2.approx(fma(s, scale*log2(e),
//   -lse*log2(e))) (q not rounded, as the Pallas logits (q.k)*scale*log2e);
//   the masks by select; ds rounded to bf16 and packed from the C into the
//   A fragments of dq += ds.K (K by ldmatrix.trans); the epilogue scales
//   and stores through a padded shared tile. Registers are capped for 4
//   blocks an SM up to Dh = 64.
// - fp32 tensors (a tensor-core product in fp32 would be TF32, another
//   function): the fp32 FMA pipes. One block owns a 64-row query tile and
//   loops over the key tiles itself (no atomics: the same result from run
//   to run); one thread per query row keeps q, dout and the dq accumulator
//   in registers; each K/V tile is staged once in shared memory and read by
//   all rows with broadcast float4 loads, so every shared-memory load feeds
//   four FMAs.
//
// Both keep one flat grid on blockIdx.x, the query tiles of a cell
// adjacent, so more than 65535 cells take no second grid dimension.

#include <cstdint>

#include "bwd_mma.cuh"  // BwdMma, branch_cell

// The head width is a compile-time constant (q, dout and the accumulator
// live in registers): one library per head width, -DGP_HEAD_DIM=<Dh>.
#ifndef GP_HEAD_DIM
#error "compile with -DGP_HEAD_DIM=<head width>"
#endif
static_assert(GP_HEAD_DIM % 4 == 0 && GP_HEAD_DIM <= 128, "head width: a multiple of 4, at most 128");

namespace {

using namespace gp;

template <typename T, int DH, int BN>
__global__ void __launch_bounds__(BM)
    dilated_branch_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                 const T* __restrict__ v,
                                 const T* __restrict__ dout,
                                 const float* __restrict__ lse,
                                 const float* __restrict__ delta,
                                 const int* __restrict__ kvlen,
                                 T* __restrict__ dq, int HB, int Mp, int causal,
                                 float qscale, float scale) {
  static_assert(DH % 4 == 0, "float4 shared-memory reads need DH % 4 == 0");
  static_assert(2 * BN >= BM, "the row tiles are staged in the K/V buffer");
  __shared__ __align__(16) float smem[2 * BN * DH];
  float* ks = smem;
  float* vs = smem + BN * DH;

  // one flat grid, the query tiles of a cell adjacent (as the forward)
  const int tid = threadIdx.x;
  const int n_qtiles = Mp / BM;
  const int cell = blockIdx.x / n_qtiles;  // ((b*S + s)*r + p)*hb + t
  const int row0 = (blockIdx.x - cell * n_qtiles) * BM;
  const int row = row0 + tid;
  const long long base = (long long)cell * Mp * DH;
  const long long tile = base + (long long)row0 * DH;

  int kv = kvlen[cell / HB];
  kv = kv < Mp ? kv : Mp;
  if (causal && kv > row0 + BM) kv = row0 + BM;

  float qr[DH], dor[DH], acc[DH];
  load_row<T, DH>(q + tile, smem, qr, qscale);
  load_row<T, DH>(dout + tile, smem, dor, 1.f);
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;
  const float lse2 = lse[(long long)cell * Mp + row] * LOG2E;
  const float dlt = delta[(long long)cell * Mp + row];

  const int n_tiles = (kv + BN - 1) / BN;
  for (int kt = 0; kt < n_tiles; ++kt) {
    __syncthreads();  // the previous tile (or the row staging) is consumed
    const long long off = base + (long long)kt * BN * DH;
    for (int e = tid; e < BN * DH; e += BM) {
      ks[e] = load_f32(k + off + e);
      vs[e] = load_f32(v + off + e);
    }
    __syncthreads();

    const int key0 = kt * BN;
#pragma unroll 4
    for (int j = 0; j < BN; ++j) {
      const float* kj = ks + j * DH;
      const float s = dot_smem<DH>(qr, kj);
      const float dp = dot_smem<DH>(dor, vs + j * DH);
      const int col = key0 + j;
      const bool ok = col < kv && (!causal || col <= row);
      const float p = ok ? exp2f(s - lse2) : 0.f;
      axpy_smem<DH>(round_to<T>(p * (dp - dlt)), kj, acc);
    }
  }

  store_row<T, DH>(acc, scale, smem, dq + tile);
}

template <typename T, int DH, int BN>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, const int* kvlen, void* dq,
           int n_cells, int HB, int Mp, int causal, float qscale, float scale,
           cudaStream_t stream) {
  const unsigned blocks = (unsigned)n_cells * (unsigned)(Mp / BM);
  dilated_branch_bwd_dq_kernel<T, DH, BN><<<blocks, BM, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta, kvlen,
      static_cast<T*>(dq), HB, Mp, causal, qscale, scale);
  return (int)cudaGetLastError();
}

template <int DH>
__global__ void __launch_bounds__(128, DH > 64 ? 2 : 4)
    dilated_branch_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                                     const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                                     const float* __restrict__ lse, const float* __restrict__ delta,
                                     const int* __restrict__ kvlen, __nv_bfloat16* __restrict__ dq, int HB,
                                     int Mp, int causal, float qscale, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_qtiles = Mp / 64;
  const int cell = blockIdx.x / n_qtiles;  // ((b*S + s)*r + p)*hb + t
  const int row0 = (blockIdx.x - cell * n_qtiles) * 64;
  BwdMma<DH>::dq(q, k, v, dout, lse, delta, dq, branch_cell(cell, HB, Mp, kvlen), row0, causal, qscale, scale,
                 smem);
}

template <int DH>
int launch_mma(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, const int* kvlen, void* dq, int n_cells, int HB, int Mp, int causal,
               float qscale, float scale, cudaStream_t stream) {
  if constexpr (DH % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  } else {
    constexpr int SMEM = BwdMma<DH>::DQ_SMEM;
    const cudaError_t err = cudaFuncSetAttribute(dilated_branch_bwd_dq_mma_kernel<DH>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return (int)err;
    const unsigned blocks = (unsigned)n_cells * (unsigned)(Mp / 64);
    dilated_branch_bwd_dq_mma_kernel<DH><<<blocks, 128, SMEM, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), lse, delta, kvlen,
        static_cast<__nv_bfloat16*>(dq), HB, Mp, causal, qscale, scale);
    return (int)cudaGetLastError();
  }
}

}  // namespace

// is_bf16: 0 = fp32 tensors, 1 = bf16 tensors. n_cells = B*S*r*hb, Mp a
// positive multiple of 64, n_cells * Mp/64 blocks below 2^31, Dh ==
// GP_HEAD_DIM; qscale = Dh^-0.5 * log2(e), scale = Dh^-0.5. bf16 tensors
// take the tensor-core kernel, which needs a head width that is a multiple
// of 8 and q, k, v, dout and dq 16-byte aligned; fp32 tensors the FMA
// kernel, whose key tiles are 64 rows, or 32 above a head width of 64 to
// keep the K/V tiles in bounds.
extern "C" int gp_dilated_branch_bwd_dq(const void* q, const void* k,
                                        const void* v, const void* dout,
                                        const float* lse, const float* delta,
                                        const int* kvlen, void* dq, int is_bf16,
                                        int n_cells, int HB, int Mp, int Dh,
                                        int causal, float qscale, float scale,
                                        void* stream) {
  constexpr int BN = GP_HEAD_DIM > 64 ? 32 : 64;
  if (Dh != GP_HEAD_DIM || Mp <= 0 || Mp % BM != 0 || n_cells <= 0 ||
      (long long)n_cells * (Mp / BM) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_mma<GP_HEAD_DIM>(q, k, v, dout, lse, delta, kvlen, dq, n_cells, HB, Mp, causal, qscale,
                                   scale, st);
  return launch<float, GP_HEAD_DIM, BN>(q, k, v, dout, lse, delta, kvlen, dq, n_cells,
                                        HB, Mp, causal, qscale, scale, st);
}
