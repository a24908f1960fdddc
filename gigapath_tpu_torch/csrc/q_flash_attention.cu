// Flash attention with int8 Q/K logits (the '+attn' rider of the quantized
// tile tier).
//
// Replaces the Pallas kernel gigapath_tpu/quant/qflash.py:_qflash_kernel
// (called by q_flash_attention_pallas). Inputs: q and k int8 and v (bf16 or
// fp32), each addressed as [B, H, L, D] through the strides the caller
// passes (the head width contiguous), and cs fp32 [B*H], the combined
// scale sq*sk*D^-1/2*log2(e) of each (batch, head). Outputs: out [B, H, L,
// D] through its own strides, in bf16 or fp32, and lse fp32 [B*H, L] in
// natural log.
//
// Numerics follow the Pallas kernel: the int8 dot products over D are
// integers of magnitude at most 127^2 * D < 2^24, exact in fp32, so the
// logits equal the reference's before the one multiply by cs; base-2
// online softmax with the running max floored at M_FLOOR = -1e20; the
// probabilities are rounded to v's dtype before the PV product (as
// `pp.astype(v_ref.dtype)`), the row sum and the PV sum stay fp32. Unlike
// the Pallas tier, which needs L % 128 == 0, any L runs: key slots at or
// past L in the last key tile are masked by select (-1e30) before the max,
// so they contribute exactly 0, and query rows past L are not written.
//
// Bound on the H100: bytes at the tile encoder's shapes (L = 197, D = 64,
// bf16 v and out): each (b, h) moves 6*L*D bytes of q, k, v and out and
// 4*L of lse for 4*L^2*D operations, about 130 operations per byte, under
// the card's ~295. This first version runs on the fp32 FMA pipes, whose
// 67 TFLOP/s make it operations-bound in practice. The design: one block of 64
// threads per (b, h, 64-row query tile), one query row per thread holding
// its q row, the fp32 output accumulator and one key tile's scores in
// registers; each key tile of K and V is converted to fp32 once and staged
// in shared memory, read by all 64 rows with broadcast float4 loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#ifndef GP_HEAD_DIM
#error "compile with -DGP_HEAD_DIM=<head width>"
#endif
static_assert(GP_HEAD_DIM % 4 == 0 && GP_HEAD_DIM <= 128, "head width: a multiple of 4, at most 128");

namespace {

constexpr int BQ = 64;  // query rows per block, one per thread
constexpr float M_FLOOR = -1e20f;
constexpr float NEG_INF = -1e30f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
// a probability rounded to v's dtype, as the reference casts it
__device__ __forceinline__ float round_as(float p, const float*) { return p; }
__device__ __forceinline__ float round_as(float p, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(p));
}

struct Strides {  // element strides of batch, head and row; the head width is contiguous
  long long b, h, l;
};

template <typename TV, typename TO, int DH, int BN>
__global__ void __launch_bounds__(BQ)
    q_flash_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ k,
                   const TV* __restrict__ v, const float* __restrict__ cs,
                   TO* __restrict__ out, float* __restrict__ lse, int H, int L,
                   Strides sq, Strides sk, Strides sv, Strides so) {
  constexpr int SMEM = (2 * BN * DH > BQ * DH) ? 2 * BN * DH : BQ * DH;
  __shared__ __align__(16) float smem[SMEM];
  float* ks = smem;
  float* vs = smem + BN * DH;

  const int tid = threadIdx.x;
  const int n_qtiles = (L + BQ - 1) / BQ;
  const int bh = blockIdx.x / n_qtiles;
  const int row0 = (blockIdx.x - bh * n_qtiles) * BQ;
  const int b = bh / H, h = bh - b * H;
  const int8_t* qb = q + b * sq.b + h * sq.h;
  const int8_t* kb = k + b * sk.b + h * sk.h;
  const TV* vb = v + b * sv.b + h * sv.h;
  const float scale = cs[bh];

  // q tile: coalesced rows into shared memory (zeros past L), then one row
  // per thread into registers
  for (int e = tid; e < BQ * DH; e += BQ) {
    const int i = e / DH, d = e - i * DH;
    smem[e] = row0 + i < L ? to_f32(qb[(row0 + i) * sq.l + d]) : 0.f;
  }
  __syncthreads();
  float qr[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) qr[d] = smem[tid * DH + d];

  float acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;
  float m_run = M_FLOOR;
  float l_run = 0.f;

  const int n_ktiles = (L + BN - 1) / BN;
  for (int kt = 0; kt < n_ktiles; ++kt) {
    const int key0 = kt * BN;
    __syncthreads();  // the previous tile (or the q staging) is consumed
    for (int e = tid; e < BN * DH; e += BQ) {
      const int j = e / DH, d = e - j * DH;
      const bool ok = key0 + j < L;
      ks[e] = ok ? to_f32(kb[(key0 + j) * sk.l + d]) : 0.f;
      vs[e] = ok ? to_f32(vb[(key0 + j) * sv.l + d]) : 0.f;
    }
    __syncthreads();

    float s[BN];
    float tmax = M_FLOOR;
#pragma unroll
    for (int j = 0; j < BN; ++j) {
      float a = 0.f;  // an exact integer: |a| <= 127^2 * DH < 2^24
#pragma unroll
      for (int d = 0; d < DH; d += 4) {
        const float4 k4 = *reinterpret_cast<const float4*>(ks + j * DH + d);
        a = fmaf(qr[d], k4.x, a);
        a = fmaf(qr[d + 1], k4.y, a);
        a = fmaf(qr[d + 2], k4.z, a);
        a = fmaf(qr[d + 3], k4.w, a);
      }
      s[j] = key0 + j < L ? a * scale : NEG_INF;  // log2-unit logits
      tmax = fmaxf(tmax, s[j]);
    }
    const float m_new = fmaxf(m_run, tmax);
    const float alpha = exp2f(m_run - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BN; ++j) {
      const float p = exp2f(s[j] - m_new);
      psum += p;
      s[j] = round_as(p, v);
    }
    l_run = l_run * alpha + psum;
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < BN; ++j) {
      const float pj = s[j];
#pragma unroll
      for (int d = 0; d < DH; d += 4) {
        const float4 v4 = *reinterpret_cast<const float4*>(vs + j * DH + d);
        acc[d] = fmaf(pj, v4.x, acc[d]);
        acc[d + 1] = fmaf(pj, v4.y, acc[d + 1]);
        acc[d + 2] = fmaf(pj, v4.z, acc[d + 2]);
        acc[d + 3] = fmaf(pj, v4.w, acc[d + 3]);
      }
    }
    m_run = m_new;
  }

  const float safe_l = fmaxf(l_run, 1e-30f);
  const int row = row0 + tid;
  if (row < L) lse[(long long)bh * L + row] = (m_run + log2f(safe_l)) * LN2;

  // output tile: one row per thread into shared memory, coalesced store
  __syncthreads();
#pragma unroll
  for (int d = 0; d < DH; ++d) smem[tid * DH + d] = acc[d] / safe_l;
  __syncthreads();
  TO* ob = out + b * so.b + h * so.h;
  for (int e = tid; e < BQ * DH; e += BQ) {
    const int i = e / DH, d = e - i * DH;
    if (row0 + i < L) store(ob + (row0 + i) * so.l + d, smem[e]);
  }
}

template <typename TV, typename TO>
int launch(const void* q, const void* k, const void* v, const float* cs, void* out,
           float* lse, int BH, int H, int L, const long long* st, cudaStream_t stream) {
  constexpr int DH = GP_HEAD_DIM;
  constexpr int BN = DH > 32 ? 32 : 64;  // key rows per tile: registers hold BN scores
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]}, sv{st[6], st[7], st[8]},
      so{st[9], st[10], st[11]};
  const unsigned blocks = (unsigned)BH * (unsigned)((L + BQ - 1) / BQ);
  q_flash_kernel<TV, TO, DH, BN><<<blocks, BQ, 0, stream>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(k), static_cast<const TV*>(v),
      cs, static_cast<TO*>(out), lse, H, L, sq, sk, sv, so);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k: int8; v: fp32 (v_bf16 = 0) or bf16 (1); out: fp32 (out_bf16 = 0) or
// bf16 (1); strides: 12 element strides (batch, head, row) of q, k, v and
// out in that order, the head width contiguous in each; BH = B*H blocks of
// ceil(L/64) query tiles, below 2^31; D == GP_HEAD_DIM.
extern "C" int gp_q_flash_attention(const void* q, const void* k, const void* v,
                                    const float* cs, void* out, float* lse,
                                    int v_bf16, int out_bf16, int BH, int H, int L,
                                    int D, const long long* strides, void* stream) {
  if (D != GP_HEAD_DIM || BH <= 0 || H <= 0 || L <= 0 ||
      (long long)BH * ((L + BQ - 1) / BQ) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (v_bf16 && out_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, cs, out, lse, BH, H, L, strides, st);
  if (v_bf16)
    return launch<__nv_bfloat16, float>(q, k, v, cs, out, lse, BH, H, L, strides, st);
  if (out_bf16)
    return launch<float, __nv_bfloat16>(q, k, v, cs, out, lse, BH, H, L, strides, st);
  return launch<float, float>(q, k, v, cs, out, lse, BH, H, L, strides, st);
}
