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
// the card's ~295.
//
// Two kernels, chosen by v's dtype (and the head width):
// - bf16 v (the main path), head widths that are multiples of 16: the
//   tensor cores. A block of 4 warps owns one (b, h) and 64 query rows, 16
//   per warp; Q.K^T runs on the int8 MMA (mma.sync m16n8k32 s8.s8.s32: the
//   int32 sums are the same integers, so the logits stay bit-equal after
//   the multiply by cs), P.V on the bf16 MMA (m16n8k16, fp32 sums) with P
//   packed from the score fragments into the A fragment in registers and V
//   read with ldmatrix.trans; row max and sum through quad shuffles. Key
//   tiles of 64 (K int8, V bf16) arrive by 16-byte cp.async into a
//   two-stage ring (rows past L zero-filled), so the next tile loads while
//   the current one computes; row pitches are padded so the fragment loads
//   hit distinct banks.
// - fp32 v (a tensor-core P.V in fp32 would be TF32, another function) and
//   other head widths: the fp32 FMA pipes, one block of 64 threads per (b,
//   h, 64-row query tile), one query row per thread holding its q row, the
//   fp32 output accumulator and one key tile's scores in registers; each key
//   tile of K and V is converted to fp32 once and staged in shared memory,
//   read by all 64 rows with broadcast float4 loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_common.cuh"  // mma_bf16, ldmatrix_x4_trans, pack_bf16, cp_async16_zfill
#include "pipe_common.cuh"  // cp_async_commit, cp_async_wait

#ifndef GP_HEAD_DIM
#error "compile with -DGP_HEAD_DIM=<head width>"
#endif
static_assert(GP_HEAD_DIM % 4 == 0 && GP_HEAD_DIM <= 128, "head width: a multiple of 4, at most 128");

namespace {

using gp::cp_async16_zfill;
using gp::ldmatrix_x4_trans;
using gp::mma_bf16;
using gp::pack_bf16;

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

// ---------------------------------------------------------------------------
// the tensor-core kernel (bf16 v)
// ---------------------------------------------------------------------------

constexpr int MQ = 64;    // query rows per block: 4 warps x 16
constexpr int MKEY = 64;  // keys per tile

// D[16 x 8] += A[16 x 32] . B[32 x 8], int8 in, int32 sums
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) { *reinterpret_cast<float2*>(p) = make_float2(a, b); }
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename TO, int DH>
__global__ void __launch_bounds__(128)
    q_flash_mma_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, const float* __restrict__ cs,
                       TO* __restrict__ out, float* __restrict__ lse, int H, int L, Strides sq,
                       Strides sk, Strides sv, Strides so) {
  static_assert(DH % 16 == 0, "the tensor-core kernel takes head widths that are multiples of 16");
  constexpr int DK = (DH + 31) / 32 * 32;  // Q.K^T depth, zero-padded to the k32 step
  constexpr int QKP = DK + 16;             // q and k row pitch in bytes (bank padding)
  constexpr int VP = 2 * DH + 16;          // v row pitch in bytes
  constexpr int NT = MKEY / 8;             // score tiles of 8 keys
  constexpr int DT = DH / 8;               // output tiles of 8 columns
  __shared__ __align__(16) int8_t qs[MQ * QKP];
  __shared__ __align__(16) int8_t ks[2][MKEY * QKP];
  __shared__ __align__(16) uint8_t vs[2][MKEY * VP];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, c = lane & 3;
  const int n_qblocks = (L + MQ - 1) / MQ;
  const int bh = blockIdx.x / n_qblocks;
  const int row0 = (blockIdx.x - bh * n_qblocks) * MQ;
  const int b = bh / H, h = bh - b * H;
  const int8_t* qb = q + b * sq.b + h * sq.h;
  const int8_t* kb = k + b * sk.b + h * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + h * sv.h;
  const float scale = cs[bh];

  // 16-byte pieces: q and k rows carry DK / 16 (zeros past DH), v rows DH / 8
  constexpr int QK_CHUNKS = DK / 16, V_CHUNKS = DH / 8;
  auto load_tile = [&](int kt, int stage) {
    const int key0 = kt * MKEY;
    for (int e = tid; e < MKEY * QK_CHUNKS; e += 128) {
      const int j = e / QK_CHUNKS, d = 16 * (e - j * QK_CHUNKS);
      const bool ok = key0 + j < L && d < DH;
      cp_async16_zfill(&ks[stage][j * QKP + d], ok ? kb + (long long)(key0 + j) * sk.l + d : kb, ok);
    }
    for (int e = tid; e < MKEY * V_CHUNKS; e += 128) {
      const int j = e / V_CHUNKS, d = 8 * (e - j * V_CHUNKS);
      const bool ok = key0 + j < L;
      cp_async16_zfill(&vs[stage][j * VP + 2 * d], ok ? vb + (long long)(key0 + j) * sv.l + d : vb, ok);
    }
  };
  for (int e = tid; e < MQ * QK_CHUNKS; e += 128) {
    const int i = e / QK_CHUNKS, d = 16 * (e - i * QK_CHUNKS);
    const bool ok = row0 + i < L && d < DH;
    cp_async16_zfill(&qs[i * QKP + d], ok ? qb + (long long)(row0 + i) * sq.l + d : qb, ok);
  }
  load_tile(0, 0);
  gp::cp_async_commit();

  // this thread's rows of the warp's 16: g (fragments 0, 1) and g + 8 (2, 3)
  uint32_t qa[DK / 32][4];
  float o[DT][4];
#pragma unroll
  for (int t = 0; t < DT; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
  float m_run[2] = {M_FLOOR, M_FLOOR};
  float l_run[2] = {0.f, 0.f};

  const int n_ktiles = (L + MKEY - 1) / MKEY;
  for (int kt = 0; kt < n_ktiles; ++kt) {
    const int stage = kt & 1;
    if (kt + 1 < n_ktiles) load_tile(kt + 1, stage ^ 1);
    gp::cp_async_commit();
    gp::cp_async_wait<1>();
    __syncthreads();
    if (kt == 0) {
      const int8_t* qr = qs + (16 * warp + g) * QKP + 4 * c;
#pragma unroll
      for (int kk = 0; kk < DK / 32; ++kk) {
        qa[kk][0] = *reinterpret_cast<const uint32_t*>(qr + 32 * kk);
        qa[kk][1] = *reinterpret_cast<const uint32_t*>(qr + 8 * QKP + 32 * kk);
        qa[kk][2] = *reinterpret_cast<const uint32_t*>(qr + 32 * kk + 16);
        qa[kk][3] = *reinterpret_cast<const uint32_t*>(qr + 8 * QKP + 32 * kk + 16);
      }
    }

    // scores: int32 sums of the warp's 16 rows against the tile's 64 keys
    float sc[NT][4];
    const int key0 = kt * MKEY;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      int acc[4] = {0, 0, 0, 0};
      const int8_t* kr = ks[stage] + (8 * t + g) * QKP + 4 * c;
#pragma unroll
      for (int kk = 0; kk < DK / 32; ++kk)
        mma_s8(acc, qa[kk], *reinterpret_cast<const uint32_t*>(kr + 32 * kk),
               *reinterpret_cast<const uint32_t*>(kr + 32 * kk + 16));
      const int key = key0 + 8 * t + 2 * c;
#pragma unroll
      for (int e = 0; e < 4; ++e)  // log2-unit logits; exact integers times cs
        sc[t][e] = key + (e & 1) < L ? static_cast<float>(acc[e]) * scale : NEG_INF;
    }

    // online softmax per row (e < 2: row g; e >= 2: row g + 8)
    float m_new[2], alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float tmax = M_FLOOR;
#pragma unroll
      for (int t = 0; t < NT; ++t) tmax = fmaxf(tmax, fmaxf(sc[t][2 * half], sc[t][2 * half + 1]));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      m_new[half] = fmaxf(m_run[half], tmax);
      alpha[half] = exp2f(m_run[half] - m_new[half]);
    }
    uint32_t pa[NT][2];  // the probabilities as bf16 pairs: row g, row g + 8
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const float p0 = exp2f(sc[t][0] - m_new[0]), p1 = exp2f(sc[t][1] - m_new[0]);
      const float p2 = exp2f(sc[t][2] - m_new[1]), p3 = exp2f(sc[t][3] - m_new[1]);
      psum[0] += p0 + p1;
      psum[1] += p2 + p3;
      pa[t][0] = pack_bf16(p0, p1);
      pa[t][1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      psum[half] += __shfl_xor_sync(0xffffffffu, psum[half], 1);
      psum[half] += __shfl_xor_sync(0xffffffffu, psum[half], 2);
      l_run[half] = l_run[half] * alpha[half] + psum[half];
      m_run[half] = m_new[half];
    }
#pragma unroll
    for (int t = 0; t < DT; ++t) {
      o[t][0] *= alpha[0];
      o[t][1] *= alpha[0];
      o[t][2] *= alpha[1];
      o[t][3] *= alpha[1];
    }

    // P.V: 16 keys per step; V's 8 x 8 blocks transposed into B fragments
    const int mi = lane >> 3, rr = lane & 7;
#pragma unroll
    for (int s16 = 0; s16 < MKEY / 16; ++s16) {
      const uint32_t a[4] = {pa[2 * s16][0], pa[2 * s16][1], pa[2 * s16 + 1][0], pa[2 * s16 + 1][1]};
      const uint8_t* vrow = vs[stage] + (16 * s16 + rr + 8 * (mi & 1)) * VP + 16 * (mi >> 1);
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vrow + 32 * dp);
        mma_bf16(o[2 * dp], a, bv[0], bv[1]);
        mma_bf16(o[2 * dp + 1], a, bv[2], bv[3]);
      }
    }
    __syncthreads();  // the stage is consumed before the next loads overwrite it
  }

  const float safe_l[2] = {fmaxf(l_run[0], 1e-30f), fmaxf(l_run[1], 1e-30f)};
  TO* ob = out + b * so.b + h * so.h;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 16 * warp + g + 8 * half;
    if (row >= L) continue;
    if (c == 0) lse[(long long)bh * L + row] = (m_run[half] + log2f(safe_l[half])) * LN2;
    TO* orow = ob + (long long)row * so.l + 2 * c;
#pragma unroll
    for (int t = 0; t < DT; ++t)
      store_pair(orow + 8 * t, o[t][2 * half] / safe_l[half], o[t][2 * half + 1] / safe_l[half]);
  }
}

template <typename TO>
int launch_mma(const void* q, const void* k, const void* v, const float* cs, void* out, float* lse, int BH,
               int H, int L, const long long* st, cudaStream_t stream) {
  constexpr int DH = GP_HEAD_DIM;
  if constexpr (DH % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  } else {
    const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]}, sv{st[6], st[7], st[8]},
        so{st[9], st[10], st[11]};
    const unsigned blocks = (unsigned)BH * (unsigned)((L + MQ - 1) / MQ);
    q_flash_mma_kernel<TO, DH><<<blocks, 128, 0, stream>>>(
        static_cast<const int8_t*>(q), static_cast<const int8_t*>(k), static_cast<const __nv_bfloat16*>(v),
        cs, static_cast<TO*>(out), lse, H, L, sq, sk, sv, so);
    return (int)cudaGetLastError();
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
// ceil(L/64) query tiles, below 2^31; D == GP_HEAD_DIM. bf16 v at a head
// width that is a multiple of 16 takes the tensor-core kernel, which needs
// q, k and v 16-byte aligned with strides of whole 16-byte pieces and out
// aligned to a pair of its elements; everything else the FMA kernel.
extern "C" int gp_q_flash_attention(const void* q, const void* k, const void* v,
                                    const float* cs, void* out, float* lse,
                                    int v_bf16, int out_bf16, int BH, int H, int L,
                                    int D, const long long* strides, void* stream) {
  if (D != GP_HEAD_DIM || BH <= 0 || H <= 0 || L <= 0 ||
      (long long)BH * ((L + BQ - 1) / BQ) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (v_bf16 && GP_HEAD_DIM % 16 == 0)
    return out_bf16 ? launch_mma<__nv_bfloat16>(q, k, v, cs, out, lse, BH, H, L, strides, st)
                    : launch_mma<float>(q, k, v, cs, out, lse, BH, H, L, strides, st);
  if (v_bf16 && out_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, cs, out, lse, BH, H, L, strides, st);
  if (v_bf16)
    return launch<__nv_bfloat16, float>(q, k, v, cs, out, lse, BH, H, L, strides, st);
  if (out_bf16)
    return launch<float, __nv_bfloat16>(q, k, v, cs, out, lse, BH, H, L, strides, st);
  return launch<float, float>(q, k, v, cs, out, lse, BH, H, L, strides, st);
}
