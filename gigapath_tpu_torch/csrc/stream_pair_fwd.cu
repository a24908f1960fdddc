// Forward of one streaming chunk pair: one dilated branch's attention of a
// query block against one resident key block, returning the pair's
// chunk-normalized output and its log-sum-exp.
//
// Replaces the Pallas kernel gigapath_tpu/ops/pallas_streaming.py:_fwd_kernel
// (called by _fwd_impl). Inputs q [B, cq, H, Dh], k and v [B, ck, H, Dh] (fp32
// or bf16, each through its (batch, row, head) strides, the head width
// contiguous) and the int32 geometry of csrc/stream_common.cuh (global
// offsets q0 and k0, segment length, ratio, valid bound, lattices). Outputs:
// out [B, cq, H, Dh] in q's dtype through its strides, lse fp32 [B, H, cq]
// (natural log). The TPU kernel's [B, H, c, D] transposes and 128-lane lse
// slab are TPU layouts and are not copied.
//
// Numerics: fp32 scores from q widened to fp32 and scaled by Dh^-1/2*log2(e)
// (the Pallas kernel rounds the scaled q back to bf16; the jnp tier, which
// the plain version reproduces, scales fp32 logits: this kernel does the
// latter), a base-2 online softmax in fp32 with the running max floored at
// -1e20, masked scores selected to -1e30 before the max, so they underflow to
// an exact 0. A row with no visible key gives out = 0 and lse ~ -6.9e19.
//
// Bound on the H100: operations, 4*Dh per (query, key) pair the masks admit
// (QK^T and PV); the bytes are each block read once and out written once.
// This first version runs on the fp32 FMA pipes (67 TFLOP/s), not the bf16
// tensor cores the bound is stated against; tensor cores are later work.
// What the design does about the bound: a block of 64 threads owns 64 rows of
// one head's phase lattice (1/r of the block's rows) and loops over the key
// lattice (1/r of the keys) in 64-key tiles, so only 1/r^2 of the dense
// [cq, ck] tile is computed; a key tile whose segments cannot meet the query
// tile's is skipped whole. One thread per query row keeps q, the output
// accumulator and the tile's scores in registers; each K/V tile is staged once
// in shared memory as fp32 and read with broadcast float4 loads. No atomics:
// every output row is written by one thread, so results repeat bit for bit.

#include <cstdint>

#include "stream_common.cuh"

// The head width is a compile-time constant (q, the accumulator and the
// score strip live in registers): one library per head width,
// -DGP_HEAD_DIM=<Dh>.
#ifndef GP_HEAD_DIM
#error "compile with -DGP_HEAD_DIM=<head width>"
#endif
static_assert(GP_HEAD_DIM % 8 == 0 && GP_HEAD_DIM <= 128, "head width: a multiple of 8, at most 128");

namespace {

using namespace gp;

template <typename T, int DH, int BN>
__global__ void __launch_bounds__(BM)
    stream_pair_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           float* __restrict__ lse, PairGeom geo, int n_qtiles,
                           Strides sq, Strides sk, Strides sv, Strides so, float qscale) {
  static_assert(2 * BN >= BM, "the q and out tiles are staged in the K/V buffer");
  __shared__ __align__(16) float smem[2 * BN * DH];
  __shared__ int kseg[BN];
  float* ks = smem;
  float* vs = smem + BN * DH;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x / n_qtiles;  // b * H + h
  const int n0 = (blockIdx.x - bh * n_qtiles) * BM;
  const int b = bh / geo.H, h = bh - b * geo.H;
  const int phase = h / geo.hpg;

  const Lattice ql = lattice(phase, geo.q0, geo.cq, geo.qstep, geo.qshift);
  if (n0 >= ql.count) return;  // this head's lattice has fewer rows
  const int n1 = min(n0 + BM, ql.count);
  const bool on_block = n0 + tid < ql.count;
  const int row = ql.row(n0 + tid);
  const int tseg = row_segment(on_block, geo.q0 + row, phase, geo);

  // q rows: coalesced into shared memory, then one row per thread
  stage_rows<T, DH>(q + b * sq.b + h * sq.h, sq.l, ql, n0, BM, smem, BM);
  __syncthreads();
  float qr[DH];
#pragma unroll
  for (int d = 0; d < DH; d += 4) {
    const float4 x4 = *reinterpret_cast<const float4*>(smem + tid * DH + d);
    qr[d] = x4.x * qscale;
    qr[d + 1] = x4.y * qscale;
    qr[d + 2] = x4.z * qscale;
    qr[d + 3] = x4.w * qscale;
  }

  float acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;
  float m_run = STREAM_M_FLOOR;
  float l_run = 0.f;

  const Lattice kl = key_lattice(phase, geo);
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const int n_ktiles = (kl.count + BN - 1) / BN;
  for (int kt = 0; kt < n_ktiles; ++kt) {
    const int m0 = kt * BN, m1 = min(m0 + BN, kl.count);
    if (!segments_meet(ql, geo.q0, n0, n1, kl, geo.k0, m0, m1, geo.g)) continue;
    __syncthreads();  // the previous tile (or the q staging) is consumed
    stage_rows<T, DH>(kb, sk.l, kl, m0, BN, ks, BM);
    stage_rows<T, DH>(vb, sv.l, kl, m0, BN, vs, BM);
    if (tid < BN) {
      const bool key_on = m0 + tid < kl.count;
      kseg[tid] = key_segment(key_on, geo.k0 + kl.row(m0 + tid), phase, geo);
    }
    __syncthreads();

    float s[BN];
    float tmax = STREAM_M_FLOOR;
#pragma unroll
    for (int j = 0; j < BN; ++j) {
      const float a = dot_smem<DH>(qr, ks + j * DH);
      s[j] = kseg[j] == tseg ? a : STREAM_NEG_INF;
      tmax = fmaxf(tmax, s[j]);
    }
    const float m_new = fmaxf(m_run, tmax);
    const float alpha = exp2f(m_run - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BN; ++j) {
      s[j] = exp2f(s[j] - m_new);
      psum += s[j];
    }
    l_run = l_run * alpha + psum;
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < BN; ++j) axpy_smem<DH>(s[j], vs + j * DH, acc);
    m_run = m_new;
  }

  const float safe_l = fmaxf(l_run, 1e-30f);
  if (on_block) lse[(long long)bh * geo.cq + row] = (m_run + log2f(safe_l)) * LN2;

  // output rows: one per thread into shared memory, coalesced store
  __syncthreads();
#pragma unroll
  for (int d = 0; d < DH; ++d) smem[tid * DH + d] = acc[d] / safe_l;
  __syncthreads();
  store_rows<T, DH>(smem, ql, n0, BM, out + b * so.b + h * so.h, so.l, BM);
}

template <typename T, int DH, int BN>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int B,
           const PairGeom& geo, int n_qtiles, const long long* st, float qscale,
           cudaStream_t stream) {
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]}, sv{st[6], st[7], st[8]},
      so{st[9], st[10], st[11]};
  const unsigned blocks = (unsigned)B * (unsigned)geo.H * (unsigned)n_qtiles;
  stream_pair_fwd_kernel<T, DH, BN><<<blocks, BM, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, geo, n_qtiles, sq, sk, sv, so, qscale);
  return (int)cudaGetLastError();
}

}  // namespace

// is_bf16: 0 = fp32 q, k, v and out, 1 = bf16. geometry: the 13 int32 of
// PairGeom (stream_common.cuh); strides: 12 element strides (batch, row,
// head) of q, k, v and out; n_qtiles = ceil(ceil(cq / qstep) / 64); B * H *
// n_qtiles blocks below 2^31; Dh == GP_HEAD_DIM; qscale = Dh^-1/2 * log2(e).
// Key tiles are 64 rows, or 32 above a head width of 64.
extern "C" int gp_stream_pair_fwd(const void* q, const void* k, const void* v, void* out,
                                  float* lse, int is_bf16, int B, int Dh, const int* geometry,
                                  int n_qtiles, const long long* strides, float qscale,
                                  void* stream) {
  constexpr int BN = GP_HEAD_DIM > 64 ? 32 : 64;
  const PairGeom geo = read_geom(geometry);
  if (Dh != GP_HEAD_DIM || B <= 0 || geo.H <= 0 || n_qtiles <= 0 || geo.g <= 0 || geo.r <= 0 ||
      geo.hpg <= 0 || geo.qstep <= 0 || geo.kstep <= 0 ||
      (long long)B * geo.H * n_qtiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16, GP_HEAD_DIM, BN>(q, k, v, out, lse, B, geo, n_qtiles, strides,
                                                  qscale, st);
  return launch<float, GP_HEAD_DIM, BN>(q, k, v, out, lse, B, geo, n_qtiles, strides, qscale, st);
}
