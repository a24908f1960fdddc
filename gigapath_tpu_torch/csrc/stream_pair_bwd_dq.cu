// dQ of one streaming chunk pair.
//
// Replaces the Pallas kernel gigapath_tpu/ops/pallas_streaming.py:_dq_kernel
// (called by _bwd_impl). Inputs as csrc/stream_pair_fwd.cu, plus the output
// cotangent dout [B, cq, H, Dh] (q's dtype, through its strides), the
// forward's lse and delta' fp32 [B, H, cq]. delta' = rowsum(dout * out) -
// dlse, computed by the wrapper: the pair's lse output is differentiated
// downstream (combine_partials merges through it), so its cotangent folds
// into the delta term. Output dq [B, cq, H, Dh] in q's dtype.
//
// For query row i and each visible key j, with the probabilities recomputed
// from the stored lse:
//   p_ij  = exp2(q_i.k_j * scale*log2(e) - lse_i*log2(e))   (0 where masked)
//   ds_ij = p_ij * (dout_i.v_j - delta'_i)
//   dq_i  = scale * sum_j ds_ij k_j
// A masked pair gives p = 0 by select, whatever the row's lse (a fully
// masked row's lse is a large negative sentinel, where exp2 would overflow).
// Rows off the phase lattice are not touched (the wrapper zeroes dq); all
// arithmetic is fp32, and a bf16 dq is rounded once, at the store.
//
// Bound on the H100: operations, 6*Dh per visible (query, key) pair (q.k,
// dout.v, ds*k). fp32 FMA pipes in this first version, as the forward. What
// the design does about the bound: the forward's lattice and segment skip
// (1/r^2 of the dense tile), one block per 64 lattice rows of one head
// looping over the key tiles itself (the TPU grid's sequential accumulation
// axis becomes that loop: no atomics, the same result from run to run), q,
// dout and the dq accumulator in registers, K/V tiles staged once in shared
// memory as fp32.

#include <cstdint>

#include "stream_common.cuh"

#ifndef GP_HEAD_DIM
#error "compile with -DGP_HEAD_DIM=<head width>"
#endif
static_assert(GP_HEAD_DIM % 8 == 0 && GP_HEAD_DIM <= 128, "head width: a multiple of 8, at most 128");

namespace {

using namespace gp;

template <typename T, int DH, int BN>
__global__ void __launch_bounds__(BM)
    stream_pair_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const T* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              T* __restrict__ dq, PairGeom geo, int n_qtiles, Strides sq,
                              Strides sk, Strides sv, Strides sdo, Strides sdq, float qscale,
                              float scale) {
  static_assert(2 * BN >= BM, "the row tiles are staged in the K/V buffer");
  __shared__ __align__(16) float smem[2 * BN * DH];
  __shared__ int kseg[BN];
  float* ks = smem;
  float* vs = smem + BN * DH;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x / n_qtiles;
  const int n0 = (blockIdx.x - bh * n_qtiles) * BM;
  const int b = bh / geo.H, h = bh - b * geo.H;
  const int phase = h / geo.hpg;

  const Lattice ql = lattice(phase, geo.q0, geo.cq, geo.qstep, geo.qshift);
  if (n0 >= ql.count) return;
  const int n1 = min(n0 + BM, ql.count);
  const bool on_block = n0 + tid < ql.count;
  const int row = ql.row(n0 + tid);
  const int tseg = row_segment(on_block, geo.q0 + row, phase, geo);
  const float lse2 = on_block ? lse[(long long)bh * geo.cq + row] * LOG2E : 0.f;
  const float dlt = on_block ? delta[(long long)bh * geo.cq + row] : 0.f;

  float qr[DH], dor[DH], acc[DH];
  stage_rows<T, DH>(q + b * sq.b + h * sq.h, sq.l, ql, n0, BM, smem, BM);
  __syncthreads();
#pragma unroll
  for (int d = 0; d < DH; ++d) qr[d] = smem[tid * DH + d] * qscale;
  __syncthreads();
  stage_rows<T, DH>(dout + b * sdo.b + h * sdo.h, sdo.l, ql, n0, BM, smem, BM);
  __syncthreads();
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    dor[d] = smem[tid * DH + d];
    acc[d] = 0.f;
  }

  const Lattice kl = key_lattice(phase, geo);
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const int n_ktiles = (kl.count + BN - 1) / BN;
  for (int kt = 0; kt < n_ktiles; ++kt) {
    const int m0 = kt * BN, m1 = min(m0 + BN, kl.count);
    if (!segments_meet(ql, geo.q0, n0, n1, kl, geo.k0, m0, m1, geo.g)) continue;
    __syncthreads();  // the previous tile (or the row staging) is consumed
    stage_rows<T, DH>(kb, sk.l, kl, m0, BN, ks, BM);
    stage_rows<T, DH>(vb, sv.l, kl, m0, BN, vs, BM);
    if (tid < BN) {
      const bool key_on = m0 + tid < kl.count;
      kseg[tid] = key_segment(key_on, geo.k0 + kl.row(m0 + tid), phase, geo);
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BN; ++j) {
      const float* kj = ks + j * DH;
      const float s = dot_smem<DH>(qr, kj);
      const float dp = dot_smem<DH>(dor, vs + j * DH);
      const float p = kseg[j] == tseg ? exp2f(s - lse2) : 0.f;
      axpy_smem<DH>(p * (dp - dlt), kj, acc);
    }
  }

  __syncthreads();
#pragma unroll
  for (int d = 0; d < DH; ++d) smem[tid * DH + d] = acc[d] * scale;
  __syncthreads();
  store_rows<T, DH>(smem, ql, n0, BM, dq + b * sdq.b + h * sdq.h, sdq.l, BM);
}

template <typename T, int DH, int BN>
int launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
           const float* delta, void* dq, int B, const PairGeom& geo, int n_qtiles,
           const long long* st, float qscale, float scale, cudaStream_t stream) {
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]}, sv{st[6], st[7], st[8]},
      sdo{st[9], st[10], st[11]}, sdq{st[12], st[13], st[14]};
  const unsigned blocks = (unsigned)B * (unsigned)geo.H * (unsigned)n_qtiles;
  stream_pair_bwd_dq_kernel<T, DH, BN><<<blocks, BM, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), geo, n_qtiles, sq, sk, sv,
      sdo, sdq, qscale, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// is_bf16: 0 = fp32 q, k, v, dout and dq, 1 = bf16. geometry and n_qtiles as
// gp_stream_pair_fwd; strides: 15 element strides (batch, row, head) of q, k,
// v, dout and dq; lse and delta fp32 [B, H, cq]; qscale = Dh^-1/2 * log2(e),
// scale = Dh^-1/2.
extern "C" int gp_stream_pair_bwd_dq(const void* q, const void* k, const void* v,
                                     const void* dout, const float* lse, const float* delta,
                                     void* dq, int is_bf16, int B, int Dh, const int* geometry,
                                     int n_qtiles, const long long* strides, float qscale,
                                     float scale, void* stream) {
  constexpr int BN = GP_HEAD_DIM > 64 ? 32 : 64;
  const PairGeom geo = read_geom(geometry);
  if (Dh != GP_HEAD_DIM || B <= 0 || geo.H <= 0 || n_qtiles <= 0 || geo.g <= 0 || geo.r <= 0 ||
      geo.hpg <= 0 || geo.qstep <= 0 || geo.kstep <= 0 ||
      (long long)B * geo.H * n_qtiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16, GP_HEAD_DIM, BN>(q, k, v, dout, lse, delta, dq, B, geo,
                                                  n_qtiles, strides, qscale, scale, st);
  return launch<float, GP_HEAD_DIM, BN>(q, k, v, dout, lse, delta, dq, B, geo, n_qtiles, strides,
                                        qscale, scale, st);
}
