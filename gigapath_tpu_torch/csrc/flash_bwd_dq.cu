// dQ of segment-batched flash attention, in the segmented [B, H, S, M, D] or
// the flat [B, H, L, D] layout (see flash_common.cuh).
//
// Replaces the Pallas kernel gigapath_tpu/ops/pallas_flash.py:_dq_kernel,
// both where _bwd_impl calls it on segments (PERF.md row 12) and where
// _flat_bwd_impl calls it with flat=True (row 14). Inputs q, k, v and the
// output cotangent dout (fp32 or bf16); lse (the forward's) and delta =
// rowsum(dout * out), fp32, row for row with q; kvlen int32 [B, H, S] or null
// (flat: counts from real_len). Output dq in q's layout and dtype.
//
// For query row i and each valid key j (j < kv, and j <= i when causal),
// with the probabilities recomputed from the saved lse as the Pallas kernel
// does:
//   p_ij  = exp2((q_i.k_j) * scale*log2(e) - lse_i*log2(e))
//   ds_ij = p_ij * (dout_i.v_j - delta_i)
//   dq_i  = scale * sum_j round(ds_ij) k_j
// where round() is the Pallas kernel's cast of ds to k's dtype (bf16 for
// bf16 tensors). Key tiles at or past kv are never loaded (a row with no
// valid key, lse ~ -6.9e19, gets dq = 0). In the flat layout the rows of a
// segment at or past its count are computed like the others (the Pallas
// kernel leaves them unspecified).
//
// Bound on the H100: operations, 6*D per admitted (query, key) pair (q.k,
// dout.v, ds*k) at the dtype's peak, next to about 4*D elements moved per
// row; and one exp2 per admitted pair on the MUFU pipes (16 a clock per SM),
// as much time as the bf16 tensor cores' bound at D = 48.
//
// Two kernels, chosen by the tensors' dtype:
// - bf16 tensors (head widths that are multiples of 8): the tensor cores.
//   A block of 4 warps owns 64 query rows of one cell, 16 per warp, and
//   loops over the cell's valid key tiles of 64 (no atomics: the same
//   result from run to run). The Q and dO tiles arrive once by cp.async and
//   stay in registers as A fragments (ldmatrix); K and V tiles stream
//   through a two-stage cp.async ring, the next tile in flight while the
//   current one computes, key rows at or past kv zero-filled without a
//   read and tiles past kv never loaded. S = Q.K^T and dP = dO.V^T come
//   from mma.sync.m16n8k16 (bf16 products, fp32 sums, as the Pallas
//   kernel's dots with preferred_element_type fp32; D zero-padded to a
//   multiple of 16 in shared memory); the scale and the lse go on in one
//   FMA, p is one ex2.approx (MUFU), the mask is one select; dS is rounded
//   to bf16 (the Pallas kernel's cast to k's dtype) and packed straight
//   from the C fragments into the A fragments of dQ += dS.K, K's B
//   fragments by ldmatrix.trans. The epilogue multiplies by the scale and
//   stores through a padded shared tile as 16-byte stores. Registers are
//   capped for 4 blocks an SM up to D = 64 (16 warps to hide latency).
// - fp32 tensors (a tensor-core product in fp32 would be TF32, another
//   function): the fp32 FMA pipes. One block owns a 64-row query tile and
//   loops over the key tiles itself; one thread per query row keeps q,
//   dout and the dq accumulator in registers; each K/V tile is staged once
//   in shared memory as fp32, rows past the count as zeros, and read by all
//   rows with broadcast float4 loads.

#include <cstdint>

#include "flash_common.cuh"
#include "pipe_common.cuh"  // cp_async_commit, cp_async_wait

// The head width is a compile-time constant (q, dout and the accumulator
// live in registers): one library per head width, -DGP_HEAD_DIM=<D>.
#ifndef GP_HEAD_DIM
#error "compile with -DGP_HEAD_DIM=<head width>"
#endif
static_assert(GP_HEAD_DIM % 4 == 0 && GP_HEAD_DIM <= 128, "head width: a multiple of 4, at most 128");

namespace {

using namespace gp;

template <typename T, int DH, int BN>
__global__ void __launch_bounds__(BM)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        const int* __restrict__ kvlen, T* __restrict__ dq, int S, int Mq,
                        int Mk, int Lq, int Lk, int real_len, int causal, float qscale,
                        float scale, int n_qtiles) {
  static_assert(DH % 4 == 0, "float4 shared-memory reads need DH % 4 == 0");
  static_assert(2 * BN >= BM, "the row tiles are staged in the K/V buffer");
  __shared__ __align__(16) float smem[2 * BN * DH];
  float* ks = smem;
  float* vs = smem + BN * DH;

  const int tid = threadIdx.x;
  const int cell = blockIdx.x / n_qtiles;
  const int row0 = (blockIdx.x - cell * n_qtiles) * BM;
  const FlashCell c = flash_cell(cell, S, Mq, Mk, Lq, Lk, kvlen, real_len);
  if (row0 >= c.nq) return;  // past a flat layout's ragged last segment
  const int row = row0 + tid;
  const bool row_ok = row < c.nq;
  int kv = c.kv;
  if (causal && kv > row0 + BM) kv = row0 + BM;

  float qr[DH], dor[DH], acc[DH];
  stage_rows<T, DH, BM>(q + (c.q0 + row0) * DH, c.nq - row0, smem);
  __syncthreads();
  row_from_smem<DH>(smem, qr, 1.f);
  __syncthreads();
  stage_rows<T, DH, BM>(dout + (c.q0 + row0) * DH, c.nq - row0, smem);
  __syncthreads();
  row_from_smem<DH>(smem, dor, 1.f);
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;
  const float lse2 = row_ok ? lse[c.q0 + row] * LOG2E : 0.f;
  const float dlt = row_ok ? delta[c.q0 + row] : 0.f;

  const int n_tiles = (kv + BN - 1) / BN;
  for (int kt = 0; kt < n_tiles; ++kt) {
    __syncthreads();  // the previous tile (or the row staging) is consumed
    const int key0 = kt * BN;
    stage_rows<T, DH, BN>(k + (c.k0 + key0) * DH, kv - key0, ks);
    stage_rows<T, DH, BN>(v + (c.k0 + key0) * DH, kv - key0, vs);
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BN; ++j) {
      const float* kj = ks + j * DH;
      const float s = dot_smem<DH>(qr, kj) * qscale;
      const float dp = dot_smem<DH>(dor, vs + j * DH);
      const int col = key0 + j;
      const bool ok = col < kv && (!causal || col <= row);
      const float p = ok ? exp2f(s - lse2) : 0.f;
      axpy_smem<DH>(round_to<T>(p * (dp - dlt)), kj, acc);
    }
  }

  store_rows<T, DH>(acc, scale, smem, dq + (c.q0 + row0) * DH, c.nq - row0);
}

template <typename T, int DH, int BN>
int launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
           const float* delta, const int* kvlen, void* dq, int n_bh, int S, int Mq, int Mk,
           int Lq, int Lk, int real_len, int causal, float qscale, float scale,
           cudaStream_t stream) {
  const int n_qtiles = (Mq + BM - 1) / BM;
  const unsigned blocks = (unsigned)n_bh * (unsigned)S * (unsigned)n_qtiles;
  flash_bwd_dq_kernel<T, DH, BN><<<blocks, BM, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, kvlen, static_cast<T*>(dq), S, Mq, Mk, Lq, Lk,
      real_len, causal, qscale, scale, n_qtiles);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the tensor-core kernel (bf16 tensors)
// ---------------------------------------------------------------------------

template <int DH>
__global__ void __launch_bounds__(128, DH > 64 ? 2 : 4)
    flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            const int* __restrict__ kvlen, __nv_bfloat16* __restrict__ dq, int S, int Mq,
                            int Mk, int Lq, int Lk, int real_len, int causal, float qscale, float scale,
                            int n_qtiles) {
  using Tile = MmaTile<DH>;
  constexpr int PITCH = Tile::PITCH;
  constexpr int KS = Tile::DK / 16;  // steps of the D contractions
  constexpr int NT = 64 / 8;         // score tiles of 8 keys
  constexpr int DT = Tile::DK / 8;   // dq tiles of 8 columns (even)
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* qs = smem;                      // Q tile, then the dq tile
  unsigned char* dos = smem + Tile::BYTES;       // dO tile
  unsigned char* ring = smem + 2 * Tile::BYTES;  // stage s: K, then V

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, c = lane & 3;
  const int lr = lane & 7, lm = lane >> 3;  // ldmatrix: row and matrix of this lane's address
  const int cell = blockIdx.x / n_qtiles;
  const int row0 = (blockIdx.x - cell * n_qtiles) * 64;
  const FlashCell fc = flash_cell(cell, S, Mq, Mk, Lq, Lk, kvlen, real_len);
  if (row0 >= fc.nq) return;  // past a flat layout's ragged last segment
  int kv = fc.kv;
  if (causal && kv > row0 + 64) kv = row0 + 64;
  const int n_tiles = (kv + 63) / 64;
  const __nv_bfloat16* kc = k + fc.k0 * DH;
  const __nv_bfloat16* vc = v + fc.k0 * DH;

  Tile::load(qs, q + (fc.q0 + row0) * DH, fc.nq - row0);
  Tile::load(dos, dout + (fc.q0 + row0) * DH, fc.nq - row0);
  if (n_tiles > 0) {
    Tile::load(ring, kc, kv);
    Tile::load(ring + Tile::BYTES, vc, kv);
  }
  cp_async_commit();

  // this thread's rows: g and g + 8 of the warp's 16
  int row[2];
  float lse2[2], dlt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = row0 + 16 * warp + g + 8 * h;
    const bool ok = row[h] < fc.nq;
    lse2[h] = ok ? lse[fc.q0 + row[h]] * LOG2E : 0.f;
    dlt[h] = ok ? delta[fc.q0 + row[h]] : 0.f;
  }
  uint32_t qa[KS][4], da[KS][4];
  float acc[DT][4];
#pragma unroll
  for (int t = 0; t < DT; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int stage = kt & 1;
    if (kt + 1 < n_tiles) {
      unsigned char* next = ring + (stage ^ 1) * 2 * Tile::BYTES;
      Tile::load(next, kc + (long long)(kt + 1) * 64 * DH, kv - (kt + 1) * 64);
      Tile::load(next + Tile::BYTES, vc + (long long)(kt + 1) * 64 * DH, kv - (kt + 1) * 64);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (kt == 0) {  // A fragments: rows 0-7 / 8-15 of the warp's 16, columns lo / hi of each step
      const int off = (16 * warp + lr + 8 * (lm & 1)) * PITCH + 16 * (lm >> 1);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        ldmatrix_x4(qa[kk], qs + off + 32 * kk);
        ldmatrix_x4(da[kk], dos + off + 32 * kk);
      }
    }
    const unsigned char* ks = ring + stage * 2 * Tile::BYTES;
    const unsigned char* vs = ks + Tile::BYTES;

    // S and dP of the warp's 16 rows against the tile's 64 keys; B
    // fragments of key tiles (t, t + 1), columns lo / hi of each step
    float sc[NT][4], dp[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[t][e] = dp[t][e] = 0.f;
    const int boff = (lr + 8 * (lm >> 1)) * PITCH + 16 * (lm & 1);
#pragma unroll
    for (int tp = 0; tp < NT / 2; ++tp) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t b[4];
        ldmatrix_x4(b, ks + boff + 16 * tp * PITCH + 32 * kk);
        mma_bf16(sc[2 * tp], qa[kk], b[0], b[1]);
        mma_bf16(sc[2 * tp + 1], qa[kk], b[2], b[3]);
        ldmatrix_x4(b, vs + boff + 16 * tp * PITCH + 32 * kk);
        mma_bf16(dp[2 * tp], da[kk], b[0], b[1]);
        mma_bf16(dp[2 * tp + 1], da[kk], b[2], b[3]);
      }
    }

    // ds = p (dp - delta), p recomputed from the lse, masked keys 0; bf16
    // pairs in the A-fragment order of the keys-deep product
    const int key0 = kt * 64;
    uint32_t pa[NT][2];
#pragma unroll
    for (int t = 0; t < NT; ++t) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = key0 + 8 * t + 2 * c + e;
          const bool ok = col < kv && (!causal || col <= row[h]);
          const float p = ok ? exp2_approx(fmaf(sc[t][2 * h + e], qscale, -lse2[h])) : 0.f;
          ds[e] = p * (dp[t][2 * h + e] - dlt[h]);
        }
        pa[t][h] = pack_bf16(ds[0], ds[1]);
      }
    }

    // dq += ds . K: 16 keys a step; K's 8 x 8 blocks transposed into B
    // fragments of column tiles (2 j, 2 j + 1)
    const int toff = (lr + 8 * (lm & 1)) * PITCH + 16 * (lm >> 1);
#pragma unroll
    for (int s16 = 0; s16 < 4; ++s16) {
      const uint32_t a[4] = {pa[2 * s16][0], pa[2 * s16][1], pa[2 * s16 + 1][0], pa[2 * s16 + 1][1]};
#pragma unroll
      for (int j = 0; j < DT / 2; ++j) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, ks + toff + 16 * s16 * PITCH + 32 * j);
        mma_bf16(acc[2 * j], a, b[0], b[1]);
        mma_bf16(acc[2 * j + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // the stage is consumed before the next loads overwrite it
  }

  cp_async_wait<0>();  // no copy may land in the Q tile once it holds dq
  __syncthreads();
  Tile::put(qs, acc, scale);
  __syncthreads();
  Tile::store(dq + (fc.q0 + row0) * DH, qs, fc.nq - row0);
}

template <int DH>
int launch_mma(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, const int* kvlen, void* dq, int n_bh, int S, int Mq, int Mk, int Lq,
               int Lk, int real_len, int causal, float qscale, float scale, cudaStream_t stream) {
  if constexpr (DH % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  } else {
    constexpr int SMEM = 6 * MmaTile<DH>::BYTES;  // Q, dO, two stages of K and V
    const cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_mma_kernel<DH>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return (int)err;
    const int n_qtiles = (Mq + 63) / 64;
    const unsigned blocks = (unsigned)n_bh * (unsigned)S * (unsigned)n_qtiles;
    flash_bwd_dq_mma_kernel<DH><<<blocks, 128, SMEM, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), lse, delta, kvlen,
        static_cast<__nv_bfloat16*>(dq), S, Mq, Mk, Lq, Lk, real_len, causal, qscale, scale, n_qtiles);
    return (int)cudaGetLastError();
  }
}

}  // namespace

// is_bf16: 0 = fp32 tensors, 1 = bf16 tensors. n_bh = B*H; the layout as in
// flash_common.cuh; kvlen may be null (then real_len bounds the keys); fewer
// than 2^31 query tiles; D == GP_HEAD_DIM; qscale = D^-0.5 * log2(e), scale =
// D^-0.5. bf16 tensors take the tensor-core kernel, which needs a head width
// that is a multiple of 8 and q, k, v, dout and dq 16-byte aligned; fp32
// tensors the FMA kernel, whose key tiles are 64 rows, or 32 above a head
// width of 64.
extern "C" int gp_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                               const float* lse, const float* delta, const int* kvlen,
                               void* dq, int is_bf16, int n_bh, int S, int Mq, int Mk, int Lq,
                               int Lk, int real_len, int causal, float qscale, float scale,
                               void* stream) {
  constexpr int BN = GP_HEAD_DIM > 64 ? 32 : 64;
  if (!flash_layout_ok(n_bh, S, Mq, Mk, Lq, Lk, Mq, real_len))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_mma<GP_HEAD_DIM>(q, k, v, dout, lse, delta, kvlen, dq, n_bh, S, Mq, Mk, Lq, Lk,
                                   real_len, causal, qscale, scale, st);
  return launch<float, GP_HEAD_DIM, BN>(q, k, v, dout, lse, delta, kvlen, dq, n_bh, S, Mq, Mk,
                                        Lq, Lk, real_len, causal, qscale, scale, st);
}
