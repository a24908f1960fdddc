// dQ of one streaming chunk pair.
//
// Replaces the Pallas kernel gigapath_tpu/ops/pallas_streaming.py:_dq_kernel
// (called by _bwd_impl; PERF.md row 16a). Inputs as csrc/stream_pair_fwd.cu,
// plus the output cotangent dout [B, cq, H, Dh] (q's dtype, through its
// strides), the forward's lse and delta' fp32 [B, H, cq]. delta' =
// rowsum(dout * out) - dlse, computed by the wrapper: the pair's lse output
// is differentiated downstream (combine_partials merges through it), so its
// cotangent folds into the delta term. Output dq [B, cq, H, Dh] in q's
// dtype.
//
// For query row i and each visible key j, with the probabilities recomputed
// from the stored lse:
//   p_ij  = exp2(q_i.k_j * scale*log2(e) - lse_i*log2(e))   (0 where masked)
//   ds_ij = p_ij * (dout_i.v_j - delta'_i)
//   dq_i  = scale * sum_j round(ds_ij) k_j
// where round() is the Pallas kernel's cast of ds to k's dtype before the
// product (bf16 for bf16 tensors, a no-op in fp32). A masked pair gives p =
// 0 by select, whatever the row's lse (a fully masked row's lse is a large
// negative sentinel, where exp2 would overflow). Rows off the phase lattice
// are not touched (the wrapper zeroes dq).
//
// Bound on the H100: operations, 6*Dh per visible (query, key) pair (q.k,
// dout.v, ds*k) at the dtype's peak, and one exp2 per visible pair on the
// MUFU pipes. What the design does about it: the forward's lattice and
// segment skip (1/r^2 of the dense tile), and one block per 64 lattice rows
// of one (batch, head) looping over the key tiles itself (the TPU grid's
// sequential accumulation axis becomes that loop: no atomics, the same
// result from run to run). Two kernels, chosen by the tensors' dtype:
// - bf16 tensors: the tensor cores, through the tile steps of bwd_mma.cuh
//   (BwdMma::dq with Logits::UNROUNDED_Q, shared with rows 7, 8, 12 and
//   14) on this file's cell map, a StreamCell (stream_common.cuh): 4 warps
//   hold the 64 lattice rows' Q and dO as A fragments; K and V tiles of 64
//   lattice keys stream through a two-stage cp.async ring, rows a lattice
//   step apart (16-byte pieces: the wrapper checks the alignment), with
//   the keys' segments beside each stage; the block visits only the key
//   tiles whose segments can meet its rows'; S = Q.K^T and dP = dO.V^T on
//   mma.sync.m16n8k16; p = ex2.approx(fma(s, scale*log2(e), -lse*log2(e)));
//   the mask is kseg[j] == tseg[i] by select (row_segment / key_segment:
//   -2 and -1 for off-phase or invalid rows and keys, so blocks with step
//   = 1 and tiles that straddle a segment boundary come out right); ds is
//   rounded to bf16 and packed from the C into the A fragments of dq +=
//   ds.K (K by ldmatrix.trans); the epilogue scales and stores the rows
//   on the lattice through a padded shared tile.
// - fp32 tensors (a tensor-core product in fp32 would be TF32, another
//   function): the fp32 FMA pipes, one thread per lattice row with q, dout
//   and the dq accumulator in registers, K/V tiles staged once in shared
//   memory as fp32; all arithmetic fp32.

#include <cstdint>

#include "bwd_mma.cuh"  // BwdMma
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

template <int DH>
__global__ void __launch_bounds__(128, DH > 64 ? 2 : 4)
    stream_pair_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                                  const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                                  const float* __restrict__ lse, const float* __restrict__ delta,
                                  __nv_bfloat16* __restrict__ dq, PairGeom geo, int n_qtiles, Strides sq,
                                  Strides sk, Strides sv, Strides sdo, Strides sdq, float qscale, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int bh = blockIdx.x / n_qtiles;
  const int row0 = (blockIdx.x - bh * n_qtiles) * 64;
  const int b = bh / geo.H, h = bh - b * geo.H;
  const long long vec = (long long)bh * geo.cq;
  BwdMma<DH>::dq(q + b * sq.b + h * sq.h, k + b * sk.b + h * sk.h, v + b * sv.b + h * sv.h,
                 dout + b * sdo.b + h * sdo.h, lse + vec, delta + vec, dq + b * sdq.b + h * sdq.h,
                 stream_cell(geo, h, sq.l, sk.l, sv.l, sdo.l, sdq.l, 0), row0, 0, qscale, scale, smem);
}

template <int DH>
int launch_mma(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, void* dq, int B, const PairGeom& geo, int n_qtiles, const long long* st,
               float qscale, float scale, cudaStream_t stream) {
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]}, sv{st[6], st[7], st[8]},
      sdo{st[9], st[10], st[11]}, sdq{st[12], st[13], st[14]};
  constexpr int SMEM = BwdMma<DH>::DQ_SMEM_STREAM;
  const cudaError_t err = cudaFuncSetAttribute(stream_pair_bwd_dq_mma_kernel<DH>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)B * (unsigned)geo.H * (unsigned)n_qtiles;
  stream_pair_bwd_dq_mma_kernel<DH><<<blocks, 128, SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), lse, delta,
      static_cast<__nv_bfloat16*>(dq), geo, n_qtiles, sq, sk, sv, sdo, sdq, qscale, scale);
  return (int)cudaGetLastError();
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

// is_bf16: 0 = fp32 q, k, v, dout and dq (the FMA kernel), 1 = bf16 (the
// tensor-core kernel: every pointer and every stride times 2 bytes a
// multiple of 16). geometry and n_qtiles as gp_stream_pair_fwd (64 lattice
// rows a block); strides: 15 element strides (batch, row, head) of q, k,
// v, dout and dq; lse and delta fp32 [B, H, cq]; qscale = Dh^-1/2 *
// log2(e), scale = Dh^-1/2.
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
    return launch_mma<GP_HEAD_DIM>(q, k, v, dout, lse, delta, dq, B, geo, n_qtiles, strides, qscale,
                                   scale, st);
  return launch<float, GP_HEAD_DIM, BN>(q, k, v, dout, lse, delta, dq, B, geo, n_qtiles, strides,
                                        qscale, scale, st);
}
