// dQ of one dilated branch on the phase-major packed layout.
//
// Replaces the Pallas kernel gigapath_tpu/ops/pallas_dilated.py:_dq_kernel
// (called by _bwd_impl). Inputs q, k, v and the output cotangent dout are
// packed [B, S, r, hb, Mp, Dh] (fp32 or bf16); lse (the forward's) and
// delta = rowsum(dout * out) are fp32 [B, S, r, hb, Mp]; kvlen is int32
// [B, S, r]. Output dq in the packed layout and input dtype.
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
// exactly 0. Otherwise all arithmetic is fp32 for both input dtypes; a bf16
// dq is rounded again at the store.
//
// Bound on the H100: operations, 6*Dh per valid (query, key) pair (q.k,
// dout.v, ds*k), next to about 4*Dh elements moved per row. This first
// version runs on the fp32 FMA pipes (67 TFLOP/s), not the bf16 tensor cores
// (989 TFLOP/s); mma.sync / wgmma are later work. What the design does about
// the bound: one block owns a 64-row query tile and loops over the key tiles
// itself (the TPU grid's sequential accumulation axis becomes that loop, so
// no atomics and the result is the same from run to run); one thread per
// query row keeps q, dout and the dq accumulator in registers; each K/V tile
// is staged once in shared memory as fp32 and read by all rows with
// broadcast float4 loads, so every shared-memory load feeds four FMAs.

#include <cstdint>

#include "branch_common.cuh"

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

}  // namespace

// is_bf16: 0 = fp32 tensors, 1 = bf16 tensors. n_cells = B*S*r*hb, Mp a
// positive multiple of 64, n_cells * Mp/64 blocks below 2^31, Dh ==
// GP_HEAD_DIM; qscale = Dh^-0.5 * log2(e), scale = Dh^-0.5. Key tiles are 64
// rows, or 32 above a head width of 64 to keep the K/V tiles in bounds.
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
    return launch<__nv_bfloat16, GP_HEAD_DIM, BN>(q, k, v, dout, lse, delta, kvlen, dq,
                                                  n_cells, HB, Mp, causal, qscale, scale, st);
  return launch<float, GP_HEAD_DIM, BN>(q, k, v, dout, lse, delta, kvlen, dq, n_cells,
                                        HB, Mp, causal, qscale, scale, st);
}
