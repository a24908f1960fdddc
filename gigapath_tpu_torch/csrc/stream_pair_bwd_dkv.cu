// dK and dV of one streaming chunk pair.
//
// Replaces the Pallas kernel gigapath_tpu/ops/pallas_streaming.py:_dkv_kernel
// (called by _bwd_impl; PERF.md row 16b). Inputs as csrc/stream_pair_bwd_dq.cu
// (q, k, v, dout through their strides, lse and delta' = rowsum(dout *
// out) - dlse fp32 [B, H, cq]). Outputs dk, dv [B, ck, H, Dh] in k's dtype.
//
// For key j and each query row i that sees it, with p_ij and ds_ij as in the
// dq kernel (p = 0 by select where the pair is masked), p and ds in fp32 as
// the Pallas kernel keeps them:
//   dv_j = sum_i p_ij dout_i
//   dk_j = scale * sum_i ds_ij q_i
// Keys off the phase lattice, or at or past the valid bound, are not
// touched (the wrapper zeroes dk and dv); outputs are rounded once, at the
// store.
//
// Bound on the H100: operations, 8*Dh per visible (query, key) pair (q.k,
// dout.v, p*dout, ds*q), and one exp2 per visible pair on the MUFU pipes.
// What the design does about it: the forward's lattice and segment skip;
// one block per lattice key tile of one (batch, head) looping over the
// query tiles itself (no atomics: the same result from run to run). Two
// kernels, chosen by the tensors' dtype:
// - bf16 tensors: the tensor cores, through the tile steps of bwd_mma.cuh
//   (BwdMma::dkv with Logits::UNROUNDED_Q, shared with rows 7, 8, 12 and
//   14) on the StreamCell cell map (stream_common.cuh), 64 lattice keys a
//   block (KEYS_MMA): 4 warps hold the keys' K and V as A fragments; Q,
//   dO, lse and delta of 64 lattice rows stream through a two-stage
//   cp.async ring (rows a lattice step apart, 16-byte pieces: the wrapper
//   checks the alignment; lse and delta gathered at the lattice rows),
//   with the rows' segments beside each stage, over the query tiles whose
//   segments can meet the keys'; S^T = K.Q^T and dP^T = V.dO^T come out
//   with the keys as the M dimension, so P^T and dS^T are the A fragments
//   of dV += P^T.dO and dK += dS^T.Q, each split as bf16 hi + lo to keep
//   the fp32 p and ds; above a head width of 64 a query tile takes two
//   32-column passes. The mask is qseg[i] == kseg[j] by select.
// - fp32 tensors (a tensor-core product in fp32 would be TF32, another
//   function): the fp32 FMA pipes, 32 keys a block (KEYS_FMA), two threads
//   a key, each holding half of the head width (2*Dh registers; one thread
//   a key would hold 4*Dh and spill at Dh = 48, as the phase-major dkv's
//   FMA kernel did), adding their halves of q.k and dout.v with one warp
//   shuffle each. Each query tile's q, dout, lse and delta are staged once
//   in shared memory as fp32.

#include <cstdint>

#include "bwd_mma.cuh"  // BwdMma
#include "stream_common.cuh"

#ifndef GP_HEAD_DIM
#error "compile with -DGP_HEAD_DIM=<head width>"
#endif
static_assert(GP_HEAD_DIM % 8 == 0 && GP_HEAD_DIM <= 128, "head width: a multiple of 8, at most 128");

namespace {

using namespace gp;

constexpr int KEYS_FMA = BM / 2;  // lattice keys per block of the FMA kernel, two threads each
constexpr int KEYS_MMA = 64;       // lattice keys per block of the tensor-core kernel

template <typename T, int DH, int BQ>
__global__ void __launch_bounds__(BM)
    stream_pair_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                               const T* __restrict__ v, const T* __restrict__ dout,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               T* __restrict__ dk, T* __restrict__ dv, PairGeom geo,
                               int n_ktiles, Strides sq, Strides sk, Strides sv, Strides sdo,
                               Strides sdk, Strides sdv, float qscale, float scale) {
  constexpr int HD = DH / 2;  // each thread's half of the head width
  static_assert(HD % 4 == 0, "float4 shared-memory reads need Dh % 8 == 0");
  static_assert(2 * BQ >= KEYS_FMA, "the key rows are staged in the query buffers");
  __shared__ __align__(16) float smem[2 * BQ * DH];
  __shared__ float ls[BQ];
  __shared__ float dls[BQ];
  __shared__ int qseg[BQ];
  float* qs = smem;
  float* dos = smem + BQ * DH;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x / n_ktiles;
  const int m0 = (blockIdx.x - bh * n_ktiles) * KEYS_FMA;
  const int b = bh / geo.H, h = bh - b * geo.H;
  const int phase = h / geo.hpg;

  const Lattice kl = key_lattice(phase, geo);
  if (m0 >= kl.count) return;  // no key of this head below the valid bound here
  const int m1 = min(m0 + KEYS_FMA, kl.count);
  const int kk = tid >> 1, lo = (tid & 1) * HD;  // key row in the block, first lane of the half
  const bool key_on = m0 + kk < kl.count;
  const int useg = key_segment(key_on, geo.k0 + kl.row(m0 + kk), phase, geo);

  float kr[HD], vr[HD], dk_acc[HD], dv_acc[HD];
  stage_rows<T, DH>(k + b * sk.b + h * sk.h, sk.l, kl, m0, KEYS_FMA, smem, BM);
  __syncthreads();
#pragma unroll
  for (int d = 0; d < HD; ++d) kr[d] = smem[kk * DH + lo + d] * qscale;
  __syncthreads();
  stage_rows<T, DH>(v + b * sv.b + h * sv.h, sv.l, kl, m0, KEYS_FMA, smem, BM);
  __syncthreads();
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    vr[d] = smem[kk * DH + lo + d];
    dk_acc[d] = 0.f;
    dv_acc[d] = 0.f;
  }

  const Lattice ql = lattice(phase, geo.q0, geo.cq, geo.qstep, geo.qshift);
  const T* qb = q + b * sq.b + h * sq.h;
  const T* dob = dout + b * sdo.b + h * sdo.h;
  const long long vec = (long long)bh * geo.cq;
  const int n_qt = (ql.count + BQ - 1) / BQ;
  for (int qt = 0; qt < n_qt; ++qt) {
    const int n0 = qt * BQ, n1 = min(n0 + BQ, ql.count);
    if (!segments_meet(kl, geo.k0, m0, m1, ql, geo.q0, n0, n1, geo.g)) continue;
    __syncthreads();  // the previous tile (or the key staging) is consumed
    stage_rows<T, DH>(qb, sq.l, ql, n0, BQ, qs, BM);
    stage_rows<T, DH>(dob, sdo.l, ql, n0, BQ, dos, BM);
    for (int e = tid; e < BQ; e += BM) {
      const bool on = n0 + e < ql.count;
      const int row = ql.row(n0 + e);
      qseg[e] = row_segment(on, geo.q0 + row, phase, geo);
      ls[e] = on ? lse[vec + row] * LOG2E : 0.f;
      dls[e] = on ? delta[vec + row] : 0.f;
    }
    __syncthreads();

#pragma unroll 2
    for (int i = 0; i < BQ; ++i) {
      const float* qi = qs + i * DH + lo;
      const float* doi = dos + i * DH + lo;
      float s = dot_smem<HD>(kr, qi);
      float dp = dot_smem<HD>(vr, doi);
      s += __shfl_xor_sync(0xffffffffu, s, 1);  // the other half of the key's head width
      dp += __shfl_xor_sync(0xffffffffu, dp, 1);
      const float p = qseg[i] == useg ? exp2f(s - ls[i]) : 0.f;
      const float ds = p * (dp - dls[i]);
      axpy_smem<HD>(p, doi, dv_acc);
      axpy_smem<HD>(ds, qi, dk_acc);
    }
  }

  __syncthreads();
#pragma unroll
  for (int d = 0; d < HD; ++d) smem[kk * DH + lo + d] = dk_acc[d] * scale;
  __syncthreads();
  store_rows<T, DH>(smem, kl, m0, KEYS_FMA, dk + b * sdk.b + h * sdk.h, sdk.l, BM);
  __syncthreads();
#pragma unroll
  for (int d = 0; d < HD; ++d) smem[kk * DH + lo + d] = dv_acc[d];
  __syncthreads();
  store_rows<T, DH>(smem, kl, m0, KEYS_FMA, dv + b * sdv.b + h * sdv.h, sdv.l, BM);
}

// Two blocks an SM: the StreamCell's lattice and segment state takes the
// registers a third block would leave (at 3, ptxas spills at Dh = 48).
template <int DH>
__global__ void __launch_bounds__(128, 2)
    stream_pair_bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                                   const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                                   const float* __restrict__ lse, const float* __restrict__ delta,
                                   __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, PairGeom geo,
                                   int n_ktiles, Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdk,
                                   Strides sdv, float qscale, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int bh = blockIdx.x / n_ktiles;
  const int key0 = (blockIdx.x - bh * n_ktiles) * KEYS_MMA;
  const int b = bh / geo.H, h = bh - b * geo.H;
  const long long vec = (long long)bh * geo.cq;
  BwdMma<DH>::dkv(q + b * sq.b + h * sq.h, k + b * sk.b + h * sk.h, v + b * sv.b + h * sv.h,
                  dout + b * sdo.b + h * sdo.h, lse + vec, delta + vec, dk + b * sdk.b + h * sdk.h,
                  dv + b * sdv.b + h * sdv.h, stream_cell(geo, h, sq.l, sk.l, sv.l, sdo.l, sdk.l, sdv.l), key0, 0,
                  0, qscale, scale, smem);
}

template <int DH>
int launch_mma(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, void* dk, void* dv, int B, const PairGeom& geo, int n_ktiles,
               const long long* st, float qscale, float scale, cudaStream_t stream) {
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]}, sv{st[6], st[7], st[8]},
      sdo{st[9], st[10], st[11]}, sdk{st[12], st[13], st[14]}, sdv{st[15], st[16], st[17]};
  constexpr int SMEM = BwdMma<DH>::DKV_SMEM_STREAM;
  const cudaError_t err = cudaFuncSetAttribute(stream_pair_bwd_dkv_mma_kernel<DH>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)B * (unsigned)geo.H * (unsigned)n_ktiles;
  stream_pair_bwd_dkv_mma_kernel<DH><<<blocks, 128, SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), lse, delta,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), geo, n_ktiles, sq, sk, sv, sdo, sdk, sdv,
      qscale, scale);
  return (int)cudaGetLastError();
}

template <typename T, int DH, int BQ>
int launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
           const float* delta, void* dk, void* dv, int B, const PairGeom& geo, int n_ktiles,
           const long long* st, float qscale, float scale, cudaStream_t stream) {
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]}, sv{st[6], st[7], st[8]},
      sdo{st[9], st[10], st[11]}, sdk{st[12], st[13], st[14]}, sdv{st[15], st[16], st[17]};
  const unsigned blocks = (unsigned)B * (unsigned)geo.H * (unsigned)n_ktiles;
  stream_pair_bwd_dkv_kernel<T, DH, BQ><<<blocks, BM, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), geo,
      n_ktiles, sq, sk, sv, sdo, sdk, sdv, qscale, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// is_bf16: 0 = fp32 tensors (the FMA kernel: n_ktiles = ceil(ceil(ck /
// kstep) / 32), query tiles staged 64 rows at a time, or 32 above a head
// width of 64), 1 = bf16 (the tensor-core kernel: n_ktiles = ceil(ceil(ck
// / kstep) / 64); every pointer and every stride times 2 bytes a multiple
// of 16). geometry as gp_stream_pair_fwd; strides: 18 element strides
// (batch, row, head) of q, k, v, dout, dk and dv; B * H * n_ktiles blocks
// below 2^31.
extern "C" int gp_stream_pair_bwd_dkv(const void* q, const void* k, const void* v,
                                      const void* dout, const float* lse, const float* delta,
                                      void* dk, void* dv, int is_bf16, int B, int Dh,
                                      const int* geometry, int n_ktiles,
                                      const long long* strides, float qscale, float scale,
                                      void* stream) {
  constexpr int BQ = GP_HEAD_DIM > 64 ? 32 : 64;
  const PairGeom geo = read_geom(geometry);
  if (Dh != GP_HEAD_DIM || B <= 0 || geo.H <= 0 || n_ktiles <= 0 || geo.g <= 0 || geo.r <= 0 ||
      geo.hpg <= 0 || geo.qstep <= 0 || geo.kstep <= 0 ||
      (long long)B * geo.H * n_ktiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_mma<GP_HEAD_DIM>(q, k, v, dout, lse, delta, dk, dv, B, geo, n_ktiles, strides, qscale,
                                   scale, st);
  return launch<float, GP_HEAD_DIM, BQ>(q, k, v, dout, lse, delta, dk, dv, B, geo, n_ktiles,
                                        strides, qscale, scale, st);
}
