// dQ of one dilated branch on the phase-major packed layout, pipelined: the
// next key tile's loads overlap the current tile's math.
//
// Replaces the Pallas kernel gigapath_tpu/ops/pallas_dilated.py:_dq_kernel_pipe
// (called by _bwd_impl_pipe). The contract is csrc/dilated_branch_bwd_dq.cu's,
// non-causal only: q, k, v and the output cotangent dout packed
// [B, S, r, hb, Mp, Dh] (fp32 or bf16), lse (the forward's) and delta =
// rowsum(dout * out) fp32 [B, S, r, hb, Mp], kvlen int32 [B, S, r]; dq in the
// packed layout and input dtype.
//
// Numerics follow the pipelined Pallas kernel, for query row i and valid key
// j (j < kvlen):
//   s_ij  = round(q_i * scale*log2(e)) . k_j          (fp32 sum)
//   p_ij  = exp2(s_ij - lse_i*log2(e))
//   ds_ij = p_ij * (dout_i . v_j - delta_i)            (fp32)
//   dq_i  = scale * sum_j round(ds_ij) k_j             (fp32 sum)
// where round() is the rounding to the input dtype (a no-op in fp32). The
// serial kernel instead keeps q*scale and ds unrounded. Key tiles past kvlen
// are never loaded; inside the partial tile the keys past kvlen get p = 0
// by select. Padded rows (zero q and dout) come out exactly 0.
//
// Pipelining as csrc/dilated_branch_fwd_pipe.cu: one block per (cell,
// 64-row query tile), the cell's K and V tiles streamed through a two-stage
// cp.async ring (pipe_common.cuh), tile j+1 in flight while tile j's math
// runs. Key-stage width BN = 64 (32 above a head width of 64); dynamic
// shared memory 48 KiB at Dh = 48 in both dtypes, as the forward.
//
// Bound on the H100: operations, 6*Dh per valid (query, key) pair (q.k,
// dout.v, ds*k); fp32 FMA pipes here, one thread per query row with q, dout
// and the dq accumulator in registers. Later work: warp-specialised TMA +
// mbarrier + wgmma.

#include <cstdint>

#include "pipe_common.cuh"

#ifndef GP_HEAD_DIM
#error "compile with -DGP_HEAD_DIM=<head width>"
#endif
static_assert(GP_HEAD_DIM % 4 == 0 && GP_HEAD_DIM <= 128, "head width: a multiple of 4, at most 128");

namespace {

using namespace gp;

template <typename T, int DH, int BN>
__global__ void __launch_bounds__(BM)
    dilated_branch_bwd_dq_pipe_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                      const T* __restrict__ v,
                                      const T* __restrict__ dout,
                                      const float* __restrict__ lse,
                                      const float* __restrict__ delta,
                                      const int* __restrict__ kvlen,
                                      T* __restrict__ dq, int HB, int Mp,
                                      float qscale, float scale) {
  using Ring = KVRing<T, DH, BN>;
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
  load_row<T, DH>(q + tile, smem_f, qr, qscale);
#pragma unroll
  for (int d = 0; d < DH; ++d) qr[d] = round_to<T>(qr[d]);
  load_row<T, DH>(dout + tile, smem_f, dor, 1.f);
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
      axpy_smem<DH>(round_to<T>(p * (dp - dlt)), kj, acc);
    }
  }
  cp_async_wait<0>();

  store_row<T, DH>(acc, scale, smem_f, dq + tile);
}

template <typename T, int DH, int BN>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, const int* kvlen, void* dq,
           int n_cells, int HB, int Mp, float qscale, float scale, cudaStream_t stream) {
  constexpr int bytes = KVRing<T, DH, BN>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(dilated_branch_bwd_dq_pipe_kernel<T, DH, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         bytes);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)n_cells * (unsigned)(Mp / BM);
  dilated_branch_bwd_dq_pipe_kernel<T, DH, BN><<<blocks, BM, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, kvlen, static_cast<T*>(dq), HB, Mp, qscale, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// is_bf16: 0 = fp32 tensors, 1 = bf16 tensors. n_cells = B*S*r*hb, Mp a
// positive multiple of 64, n_cells * Mp/64 blocks below 2^31, Dh ==
// GP_HEAD_DIM, k/v 16-byte aligned (the ring's cp.async copies); qscale =
// Dh^-0.5 * log2(e), scale = Dh^-0.5.
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
    return launch<__nv_bfloat16, GP_HEAD_DIM, BN>(q, k, v, dout, lse, delta, kvlen, dq, n_cells,
                                                  HB, Mp, qscale, scale, st);
  return launch<float, GP_HEAD_DIM, BN>(q, k, v, dout, lse, delta, kvlen, dq, n_cells, HB, Mp,
                                        qscale, scale, st);
}
