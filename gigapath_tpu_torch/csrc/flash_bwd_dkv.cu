// dK and dV of segment-batched flash attention, in the segmented [B, H, S, M,
// D] or the flat [B, H, L, D] layout (see flash_common.cuh).
//
// Replaces the Pallas kernel gigapath_tpu/ops/pallas_flash.py:_dkv_kernel,
// both where _bwd_impl calls it on segments (PERF.md row 12) and where
// _flat_bwd_impl calls it with flat=True (row 14). Inputs as
// flash_bwd_dq.cu; outputs dk, dv in k's layout and dtype.
//
// For key row j < kv of a segment and each contributing query row i (i >= j
// when causal), with p_ij and ds_ij as in the dq kernel (the FMA kernel
// folds the scale into k's registers, not into each logit), both fp32 as in
// the Pallas kernel:
//   dv_j = sum_i p_ij dout_i
//   dk_j = scale * sum_i ds_ij q_i
// The contributing query rows are the segment's rows (segmented) or, with
// `flat`, only its rows below the valid count: in the flat layout a row at
// or past real_len adds nothing to dK/dV, whatever its cotangent (the Pallas
// kernel's flat=True row mask). Key rows at or past kv are written as exact
// zeros, and a tile of them is skipped.
//
// Bound on the H100: operations, 8*D per admitted (query, key) pair (q.k,
// dout.v, p*dout, ds*q) at the dtype's peak, next to about 4*D elements
// moved per row; and one exp2 per admitted pair on the MUFU pipes (16 a
// clock per SM).
//
// Two kernels, chosen by the tensors' dtype:
// - bf16 tensors (head widths that are multiples of 8): the tensor cores.
//   A block of 4 warps owns 64 keys of one cell, 16 per warp, and loops over
//   the contributing query tiles of 64 (no atomics). The K and V tiles
//   arrive once by cp.async and stay in registers as A fragments; Q, dO, lse
//   and delta stream through a two-stage cp.async ring, the next tile in
//   flight while the current one computes, rows past the contributing count
//   zero-filled without a read. The block computes S^T = K.Q^T and dP^T =
//   V.dO^T on mma.sync.m16n8k16 with the keys as the M dimension, so P^T
//   and dS^T come out of the C fragments already in the A-fragment layout
//   of dV += P^T.dO and dK += dS^T.Q (dO's and Q's B fragments by
//   ldmatrix.trans): no transpose goes through shared memory. p is one
//   ex2.approx (MUFU), the mask one select. The Pallas kernel keeps p and
//   ds in fp32 for these two products; rounding them to bf16 would be
//   another function, so each is split into two bf16 values, hi = bf16(x)
//   and lo = bf16(x - hi), whose products go into one fp32 accumulator:
//   about 16 bits of mantissa, each term within ~2^-17 of the fp32
//   product, for 2 more MMAs on the 4 a tile has. The epilogue multiplies
//   dk by the scale and stores both through padded shared tiles as 16-byte
//   stores. Registers are capped for 3 blocks an SM up to D = 48; above a
//   head width of 64 a query tile is taken in two passes of 32 columns.
// - fp32 tensors: the fp32 FMA pipes. One block owns
//   a 64-row key tile and loops over the query tiles itself; one thread
//   per key row keeps k, v and the dk/dv accumulators in registers; each
//   query tile's q, dout, lse and delta are staged once in shared memory as
//   fp32 (rows past the contributing count as zeros) and read by all rows
//   with broadcast float4 loads.

#include <cstdint>

#include "flash_common.cuh"
#include "pipe_common.cuh"  // cp_async_commit, cp_async_wait

// The head width is a compile-time constant (k, v and the accumulators live
// in registers): one library per head width, -DGP_HEAD_DIM=<D>.
#ifndef GP_HEAD_DIM
#error "compile with -DGP_HEAD_DIM=<head width>"
#endif
static_assert(GP_HEAD_DIM % 4 == 0 && GP_HEAD_DIM <= 128, "head width: a multiple of 4, at most 128");

namespace {

using namespace gp;

template <typename T, int DH, int BQ>
__global__ void __launch_bounds__(BM)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         const int* __restrict__ kvlen, T* __restrict__ dk,
                         T* __restrict__ dv, int S, int Mq, int Mk, int Lq, int Lk,
                         int real_len, int causal, int flat, float qscale, float scale,
                         int n_ktiles) {
  static_assert(DH % 4 == 0, "float4 shared-memory reads need DH % 4 == 0");
  static_assert(2 * BQ >= BM, "the key tiles are staged in the query buffers");
  __shared__ __align__(16) float smem[2 * BQ * DH + 2 * BQ];
  float* qs = smem;
  float* dos = smem + BQ * DH;
  float* ls = dos + BQ * DH;
  float* dls = ls + BQ;

  const int tid = threadIdx.x;
  const int cell = blockIdx.x / n_ktiles;
  const int key0 = (blockIdx.x - cell * n_ktiles) * BM;
  const FlashCell c = flash_cell(cell, S, Mq, Mk, Lq, Lk, kvlen, real_len);
  if (key0 >= c.nk) return;  // past a flat layout's ragged last segment
  T* dkt = dk + (c.k0 + key0) * DH;
  T* dvt = dv + (c.k0 + key0) * DH;
  const int kv = c.kv;
  if (key0 >= kv) {  // no valid key in this tile: exact zeros, no work
    const int lim = min(BM, c.nk - key0) * DH;
    for (int e = tid; e < lim; e += BM) {
      store_f32(dkt + e, 0.f);
      store_f32(dvt + e, 0.f);
    }
    return;
  }
  const int key = key0 + tid;
  const bool key_ok = key < kv;

  float kr[DH], vr[DH], dk_acc[DH], dv_acc[DH];
  stage_rows<T, DH, BM>(k + (c.k0 + key0) * DH, kv - key0, smem);
  __syncthreads();
  row_from_smem<DH>(smem, kr, qscale);
  __syncthreads();
  stage_rows<T, DH, BM>(v + (c.k0 + key0) * DH, kv - key0, smem);
  __syncthreads();
  row_from_smem<DH>(smem, vr, 1.f);
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    dk_acc[d] = 0.f;
    dv_acc[d] = 0.f;
  }

  const int q_end = flat ? kv : c.nq;  // query rows that contribute
  // causal: query rows below the key tile see none of its keys
  const int q_start = causal ? (key0 / BQ) * BQ : 0;
  for (int q0 = q_start; q0 < q_end; q0 += BQ) {
    __syncthreads();  // the previous tile (or the row staging) is consumed
    const int n_i = min(BQ, q_end - q0);
    stage_rows<T, DH, BQ>(q + (c.q0 + q0) * DH, n_i, qs);
    stage_rows<T, DH, BQ>(dout + (c.q0 + q0) * DH, n_i, dos);
    for (int e = tid; e < BQ; e += BM) {
      ls[e] = e < n_i ? lse[c.q0 + q0 + e] * LOG2E : 0.f;
      dls[e] = e < n_i ? delta[c.q0 + q0 + e] : 0.f;
    }
    __syncthreads();

    // not unrolled: the 4*D accumulator registers leave no room to hold a
    // second query row's operands; a constant trip count (the rows past
    // n_i are staged as zeros and masked) keeps the loop's own registers few
#pragma unroll 1
    for (int i = 0; i < BQ; ++i) {
      const float* qi = qs + i * DH;
      const float* doi = dos + i * DH;
      const float s = dot_smem<DH>(kr, qi);
      const float dp = dot_smem<DH>(vr, doi);
      const bool ok = key_ok && i < n_i && (!causal || key <= q0 + i);
      const float p = ok ? exp2f(s - ls[i]) : 0.f;
      const float ds = p * (dp - dls[i]);
      axpy_smem<DH>(p, doi, dv_acc);
      axpy_smem<DH>(ds, qi, dk_acc);
    }
  }

  store_rows<T, DH>(dk_acc, scale, smem, dkt, c.nk - key0);
  store_rows<T, DH>(dv_acc, 1.f, smem, dvt, c.nk - key0);
}

template <typename T, int DH, int BQ>
int launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
           const float* delta, const int* kvlen, void* dk, void* dv, int n_bh, int S, int Mq,
           int Mk, int Lq, int Lk, int real_len, int causal, int flat, float qscale,
           float scale, cudaStream_t stream) {
  const int n_ktiles = (Mk + BM - 1) / BM;
  const unsigned blocks = (unsigned)n_bh * (unsigned)S * (unsigned)n_ktiles;
  flash_bwd_dkv_kernel<T, DH, BQ><<<blocks, BM, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, kvlen, static_cast<T*>(dk),
      static_cast<T*>(dv), S, Mq, Mk, Lq, Lk, real_len, causal, flat, qscale, scale,
      n_ktiles);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the tensor-core kernel (bf16 tensors)
// ---------------------------------------------------------------------------

// x0, x1 as bf16 pairs hi = bf16(x) and lo = bf16(x - hi): hi + lo carries
// about 16 bits of x's mantissa
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

template <int DH>
__global__ void __launch_bounds__(128, DH > 48 ? 2 : 3)
    flash_bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             const int* __restrict__ kvlen, __nv_bfloat16* __restrict__ dk,
                             __nv_bfloat16* __restrict__ dv, int S, int Mq, int Mk, int Lq, int Lk,
                             int real_len, int causal, int flat, float qscale, float scale, int n_ktiles) {
  using Tile = MmaTile<DH>;
  constexpr int PITCH = Tile::PITCH;
  constexpr int KS = Tile::DK / 16;      // steps of the D contractions
  constexpr int DT = Tile::DK / 8;       // dk / dv tiles of 8 columns (even)
  constexpr int QN = DH > 64 ? 32 : 64;  // query columns of one pass (registers)
  constexpr int NT = QN / 8;             // score tiles of 8 queries in a pass
  constexpr int STAGE = 2 * Tile::BYTES + 2 * 64 * 4;  // Q, dO, lse, delta
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ks = smem;                      // K tile, then the dk tile
  unsigned char* vs = smem + Tile::BYTES;        // V tile, then the dv tile
  unsigned char* ring = smem + 2 * Tile::BYTES;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, c = lane & 3;
  const int lr = lane & 7, lm = lane >> 3;  // ldmatrix: row and matrix of this lane's address
  const int cell = blockIdx.x / n_ktiles;
  const int key0 = (blockIdx.x - cell * n_ktiles) * 64;
  const FlashCell fc = flash_cell(cell, S, Mq, Mk, Lq, Lk, kvlen, real_len);
  if (key0 >= fc.nk) return;  // past a flat layout's ragged last segment
  __nv_bfloat16* dkt = dk + (fc.k0 + key0) * DH;
  __nv_bfloat16* dvt = dv + (fc.k0 + key0) * DH;
  const int kv = fc.kv;
  if (key0 >= kv) {  // no valid key in this tile: exact zeros, no work
    Tile::store(dkt, nullptr, fc.nk - key0, true);
    Tile::store(dvt, nullptr, fc.nk - key0, true);
    return;
  }
  const int q_end = flat ? kv : fc.nq;  // query rows that contribute
  // causal: query rows below the key tile see none of its keys
  const int q_start = causal ? key0 : 0;
  const int n_tiles = q_end > q_start ? (q_end - q_start + 63) / 64 : 0;
  const __nv_bfloat16* qc = q + fc.q0 * DH;
  const __nv_bfloat16* dc = dout + fc.q0 * DH;
  const float* lc = lse + fc.q0;
  const float* tc = delta + fc.q0;

  // query tile at row i0 of the cell into a ring stage
  auto issue = [&](int i0, unsigned char* st) {
    Tile::load(st, qc + (long long)i0 * DH, q_end - i0);
    Tile::load(st + Tile::BYTES, dc + (long long)i0 * DH, q_end - i0);
    const int e = tid & 63;
    const bool ok = i0 + e < q_end;
    const float* src = tid < 64 ? lc : tc;
    cp_async4_zfill(st + 2 * Tile::BYTES + 4 * tid, ok ? src + i0 + e : src, ok);
  };
  Tile::load(ks, k + (fc.k0 + key0) * DH, kv - key0);
  Tile::load(vs, v + (fc.k0 + key0) * DH, kv - key0);
  if (n_tiles > 0) issue(q_start, ring);
  cp_async_commit();

  int key[2];  // this thread's keys: rows g and g + 8 of the warp's 16
  key[0] = key0 + 16 * warp + g;
  key[1] = key[0] + 8;
  uint32_t ka[KS][4], va[KS][4];
  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int t = 0; t < DT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[t][e] = dva[t][e] = 0.f;
  const int aoff = (16 * warp + lr + 8 * (lm & 1)) * PITCH + 16 * (lm >> 1);
  const int boff = (lr + 8 * (lm >> 1)) * PITCH + 16 * (lm & 1);
  const int toff = (lr + 8 * (lm & 1)) * PITCH + 16 * (lm >> 1);

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    const int i0 = q_start + 64 * it;
    if (it + 1 < n_tiles) issue(i0 + 64, ring + (stage ^ 1) * STAGE);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        ldmatrix_x4(ka[kk], ks + aoff + 32 * kk);
        ldmatrix_x4(va[kk], vs + aoff + 32 * kk);
      }
    }
    const unsigned char* qs = ring + stage * STAGE;
    const unsigned char* dos = qs + Tile::BYTES;
    const float* ls = reinterpret_cast<const float*>(qs + 2 * Tile::BYTES);
    const float* dls = ls + 64;

#pragma unroll 1
    for (int pass = 0; pass < 64 / QN; ++pass) {
      const int c0 = pass * QN;  // first query column of the pass in the tile
      // S^T and dP^T of the warp's 16 keys against the pass's queries
      float sc[NT][4], dp[NT][4];
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[t][e] = dp[t][e] = 0.f;
#pragma unroll
      for (int tp = 0; tp < NT / 2; ++tp) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          uint32_t b[4];
          ldmatrix_x4(b, qs + boff + (c0 + 16 * tp) * PITCH + 32 * kk);
          mma_bf16(sc[2 * tp], ka[kk], b[0], b[1]);
          mma_bf16(sc[2 * tp + 1], ka[kk], b[2], b[3]);
          ldmatrix_x4(b, dos + boff + (c0 + 16 * tp) * PITCH + 32 * kk);
          mma_bf16(dp[2 * tp], va[kk], b[0], b[1]);
          mma_bf16(dp[2 * tp + 1], va[kk], b[2], b[3]);
        }
      }
      // p and ds in fp32 (sc and dp take them), masked pairs exactly 0
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int col = c0 + 8 * t + 2 * c;  // query column in the tile
        const float2 l2 = *reinterpret_cast<const float2*>(ls + col);
        const float2 d2 = *reinterpret_cast<const float2*>(dls + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = i0 + col + (e & 1);
          const int kj = key[e >> 1];
          const bool ok = kj < kv && qi < q_end && (!causal || kj <= qi);
          const float p = ok ? exp2_approx(fmaf(sc[t][e], qscale, -((e & 1) ? l2.y : l2.x) * LOG2E)) : 0.f;
          sc[t][e] = p;
          dp[t][e] = p * (dp[t][e] - ((e & 1) ? d2.y : d2.x));
        }
      }
      // dv += p^T . dO and dk += ds^T . Q, 16 queries a step, each of p and
      // ds as hi + lo; dO's and Q's 8 x 8 blocks transposed into B fragments
#pragma unroll
      for (int s16 = 0; s16 < QN / 16; ++s16) {
        uint32_t ph[4], pl[4], dh[4], dl[4];
        split_bf16(sc[2 * s16][0], sc[2 * s16][1], ph[0], pl[0]);
        split_bf16(sc[2 * s16][2], sc[2 * s16][3], ph[1], pl[1]);
        split_bf16(sc[2 * s16 + 1][0], sc[2 * s16 + 1][1], ph[2], pl[2]);
        split_bf16(sc[2 * s16 + 1][2], sc[2 * s16 + 1][3], ph[3], pl[3]);
        split_bf16(dp[2 * s16][0], dp[2 * s16][1], dh[0], dl[0]);
        split_bf16(dp[2 * s16][2], dp[2 * s16][3], dh[1], dl[1]);
        split_bf16(dp[2 * s16 + 1][0], dp[2 * s16 + 1][1], dh[2], dl[2]);
        split_bf16(dp[2 * s16 + 1][2], dp[2 * s16 + 1][3], dh[3], dl[3]);
        const int row = (c0 + 16 * s16) * PITCH + toff;
#pragma unroll
        for (int j = 0; j < DT / 2; ++j) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, dos + row + 32 * j);
          mma_bf16(dva[2 * j], ph, b[0], b[1]);
          mma_bf16(dva[2 * j], pl, b[0], b[1]);
          mma_bf16(dva[2 * j + 1], ph, b[2], b[3]);
          mma_bf16(dva[2 * j + 1], pl, b[2], b[3]);
          ldmatrix_x4_trans(b, qs + row + 32 * j);
          mma_bf16(dka[2 * j], dh, b[0], b[1]);
          mma_bf16(dka[2 * j], dl, b[0], b[1]);
          mma_bf16(dka[2 * j + 1], dh, b[2], b[3]);
          mma_bf16(dka[2 * j + 1], dl, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // the stage is consumed before the next loads overwrite it
  }

  cp_async_wait<0>();  // no copy may land in the K/V tiles once they hold dk/dv
  __syncthreads();
  Tile::put(ks, dka, scale);
  Tile::put(vs, dva, 1.f);
  __syncthreads();
  Tile::store(dkt, ks, fc.nk - key0);
  Tile::store(dvt, vs, fc.nk - key0);
}

template <int DH>
int launch_mma(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, const int* kvlen, void* dk, void* dv, int n_bh, int S, int Mq, int Mk,
               int Lq, int Lk, int real_len, int causal, int flat, float qscale, float scale,
               cudaStream_t stream) {
  if constexpr (DH % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  } else {
    // K, V, two stages of Q, dO, lse and delta
    constexpr int SMEM = 6 * MmaTile<DH>::BYTES + 2 * 2 * 64 * 4;
    const cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_mma_kernel<DH>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return (int)err;
    const int n_ktiles = (Mk + 63) / 64;
    const unsigned blocks = (unsigned)n_bh * (unsigned)S * (unsigned)n_ktiles;
    flash_bwd_dkv_mma_kernel<DH><<<blocks, 128, SMEM, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), lse, delta, kvlen,
        static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), S, Mq, Mk, Lq, Lk, real_len, causal,
        flat, qscale, scale, n_ktiles);
    return (int)cudaGetLastError();
  }
}

}  // namespace

// is_bf16: 0 = fp32 tensors, 1 = bf16 tensors. n_bh = B*H; the layout as in
// flash_common.cuh; kvlen may be null (then real_len bounds the keys); flat:
// only a segment's query rows below its valid count contribute; fewer than
// 2^31 key tiles; D == GP_HEAD_DIM; qscale = D^-0.5 * log2(e), scale =
// D^-0.5. bf16 tensors take the tensor-core kernel, which needs a head width
// that is a multiple of 8 and q, k, v, dout, dk and dv 16-byte aligned;
// fp32 tensors the FMA kernel, which stages query tiles of 64 rows, or 32
// above a head width of 64.
extern "C" int gp_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                const float* lse, const float* delta, const int* kvlen,
                                void* dk, void* dv, int is_bf16, int n_bh, int S, int Mq,
                                int Mk, int Lq, int Lk, int real_len, int causal, int flat,
                                float qscale, float scale, void* stream) {
  constexpr int BQ = GP_HEAD_DIM > 64 ? 32 : 64;
  if (!flash_layout_ok(n_bh, S, Mq, Mk, Lq, Lk, Mk, real_len))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_mma<GP_HEAD_DIM>(q, k, v, dout, lse, delta, kvlen, dk, dv, n_bh, S, Mq, Mk, Lq, Lk,
                                   real_len, causal, flat, qscale, scale, st);
  return launch<float, GP_HEAD_DIM, BQ>(q, k, v, dout, lse, delta, kvlen, dk, dv, n_bh, S, Mq,
                                        Mk, Lq, Lk, real_len, causal, flat, qscale, scale, st);
}
