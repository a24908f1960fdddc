// The tile steps of the bf16 tensor-core attention backward, dq and dkv,
// shared by the segment-flash kernels (flash_bwd_dq.cu, flash_bwd_dkv.cu;
// PERF.md rows 12 and 14), the dilated-branch kernels on the phase-major
// packed layout, serial (dilated_branch_bwd_dq.cu, dilated_branch_bwd_dkv.cu;
// row 7) and pipelined (dilated_branch_bwd_dq_pipe.cu,
// dilated_branch_bwd_dkv_pipe.cu; row 8), and the streaming chunk-pair
// kernels (stream_pair_bwd_dq.cu, stream_pair_bwd_dkv.cu; row 16). The
// Pallas pairs pallas_flash.py:_dq_kernel / _dkv_kernel,
// pallas_dilated.py:_dq_kernel / _dkv_kernel, pallas_dilated.py:_dq_kernel_pipe
// / _dkv_kernel_pipe and pallas_streaming.py:_dq_kernel / _dkv_kernel
// differ in their index maps and masks and, the pipelined pair, in one
// rounding of the logits (the Logits parameter below), so each file
// supplies its cell map and that parameter and these steps do the rest.
//
// The cell map is a compile-time parameter, the type of the cell. A
// FlashCell (flash_common.cuh, the default) gives its first query and key
// row q0, k0 (rows of DH elements; lse and delta rows are q0 + i), the rows
// it holds in memory nq, nk, and its valid keys [0, kv). flash_cell maps a
// segment of either flash layout; branch_cell a packed dilated cell
// ((b*S + s)*r + p)*hb + t, a contiguous [Mp, Dh] block: q0 = k0 =
// cell*Mp, nq = nk = Mp, kv = min(kvlen[cell / hb], Mp). `flat` (the flash
// flat layout's rule) drops the query rows at or past kv from dK/dV. A
// StreamCell (stream_common.cuh) is one (batch, head) of a chunk pair:
// tile rows are indices on the head's phase lattices, at rows start +
// step*n of strided [c, Dh] views (MmaTile::load_rows / store_rows), lse
// and delta at the lattice row, and the mask is the segment equality
// q_seg(i) == k_seg(j) (-2 and -1 for masked rows and keys) from per-stage
// int arrays of the streamed tile's segments beside the ring, in place of
// `col < kv`; a block visits only the tiles whose segments can meet its
// own, and writes nothing past the lattice or valid. Each arm is chosen at
// compile time, so a FlashCell's kernels compile as they did without it.
//
// For query row i and each valid key j (j < kv, and j <= i when causal),
// with the probabilities recomputed from the saved lse as the Pallas
// kernels do:
//   p_ij  = exp2((q_i.k_j) * scale*log2(e) - lse_i*log2(e))    (UNROUNDED_Q)
//   p_ij  = exp2(bf16(q_i * scale*log2(e)).k_j - lse_i*log2(e)) (ROUNDED_Q)
//   ds_ij = p_ij * (dout_i.v_j - delta_i)
//   dq_i  = scale * sum_j bf16(ds_ij) k_j
//   dv_j  = sum_i p_ij dout_i,  dk_j = scale * sum_i ds_ij q_i  (p, ds fp32)
//
// dq: a block of 4 warps owns 64 query rows of one cell, 16 per warp, and
// loops over the cell's valid key tiles of 64 (no atomics: the same result
// from run to run). The Q and dO tiles arrive once by cp.async and stay in
// registers as A fragments (ldmatrix); K and V tiles stream through a
// two-stage cp.async ring, the next tile in flight while the current one
// computes, key rows at or past kv zero-filled without a read and tiles
// past kv never loaded (a row with no valid key, lse ~ -6.9e19, gets dq = 0
// and no exp2). S = Q.K^T and dP = dO.V^T come from mma.sync.m16n8k16
// (bf16 products, fp32 sums, as the Pallas dots with preferred_element_type
// fp32; D zero-padded to a multiple of 16 in shared memory); the scale and
// the lse go on in one FMA (ROUNDED_Q: Q's A fragments are scaled and
// rounded in registers once, as the forward's load_q, and the lse is one
// subtraction), p is one ex2.approx (MUFU), the mask is one select; dS is
// rounded to bf16 (the Pallas cast to k's dtype) and packed
// straight from the C fragments into the A fragments of dQ += dS.K, K's B
// fragments by ldmatrix.trans. Causal: keys stop at the query tile's
// diagonal tile. The epilogue multiplies by the scale and stores through a
// padded shared tile as 16-byte stores.
//
// dkv: a block of 4 warps owns 64 keys of one cell, 16 per warp, and loops
// over the contributing query tiles of 64 (no atomics). The K and V tiles
// arrive once by cp.async and stay in registers as A fragments; Q, dO, lse
// and delta stream through a two-stage cp.async ring, rows past the
// contributing count zero-filled without a read. S^T = K.Q^T and dP^T =
// V.dO^T come out with the keys as the M dimension, so P^T and dS^T are
// already in the A-fragment layout of dV += P^T.dO and dK += dS^T.Q (dO's
// and Q's B fragments by ldmatrix.trans): no transpose goes through shared
// memory. The Pallas kernels keep p and ds in fp32 for these two products;
// rounding them to bf16 would be another function, so each is split into
// two bf16 values, hi = bf16(x) and lo = bf16(x - hi), whose products go
// into one fp32 accumulator: about 16 bits of mantissa, each term within
// ~2^-17 of the fp32 product, for 2 more MMAs on the 4 a tile has. A key
// tile at or past kv is written as exact zeros with no work; causal query
// tiles start at the key tile's diagonal. Above a head width of 64 a query
// tile is taken in two passes of 32 columns (registers). The epilogue
// multiplies dk by the scale and stores both through padded shared tiles.
// ROUNDED_Q: only S^T = K.Q^T takes the rounded q; dK += dS^T.Q keeps the
// plain one. After each query tile lands, the block writes Q times
// scale*log2(e), rounded to bf16, into one more shared tile (one 16-byte
// piece of 8 elements a thread per pass over the tile, then a barrier), and
// S^T's B fragments are read from that copy, dK's ldmatrix.trans from the
// ring stage. Scaling each B fragment in registers after its ldmatrix would
// need no shared memory, but every one of the 4 warps reads the whole Q
// tile for S^T, so it would scale each element four times: by a count of
// the source's operations, 20 more ALU instructions a thread per B
// fragment (12 fragments a tile at Dh = 48), about a third more than the
// rest of a tile's non-MMA work, against 3 pieces a thread and one barrier
// a tile for the copy.
//
// Pad rows of a packed cell (zero q and dout, delta 0, a finite lse) add
// exactly 0: their ds is p * 0, and their p meets a zero dout row. A
// StreamCell's masked pair has p = 0 by the select, whatever its row's lse
// (a row with no visible key has lse ~ -6.9e19).

#pragma once

#include <type_traits>

#include "flash_common.cuh"
#include "pipe_common.cuh"  // cp_async_commit, cp_async_wait

namespace gp {

// cell ((b*S + s)*r + p)*hb + t of the phase-major packed layout [B, S, r,
// hb, Mp, Dh]: all Mp rows in memory, valid keys from the [B, S, r] table
__device__ __forceinline__ FlashCell branch_cell(int cell, int HB, int Mp, const int* kvlen) {
  FlashCell c;
  c.q0 = c.k0 = (long long)cell * Mp;
  c.nq = c.nk = Mp;
  c.kv = max(0, min(kvlen[cell / HB], Mp));
  return c;
}

// How a backward forms its base-2 logits (compile time, see the top):
// UNROUNDED_Q for the Pallas _dq_kernel / _dkv_kernel of both families,
// ROUNDED_Q for pallas_dilated.py:_dq_kernel_pipe / _dkv_kernel_pipe.
enum class Logits { UNROUNDED_Q, ROUNDED_Q };

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
struct BwdMma {
  using Tile = MmaTile<DH>;
  static constexpr int PITCH = Tile::PITCH;
  static constexpr int KS = Tile::DK / 16;  // steps of the D contractions
  static constexpr int DT = Tile::DK / 8;   // dq / dk / dv tiles of 8 columns (even)
  // dynamic shared memory: Q, dO and two stages of K and V (dq); K, V and
  // two stages of Q, dO, lse and delta (dkv), and for ROUNDED_Q the scaled
  // copy of the landed Q tile
  static constexpr int DQ_SMEM = 6 * Tile::BYTES;
  static constexpr int DKV_STAGE = 2 * Tile::BYTES + 2 * 64 * 4;
  static constexpr int DKV_SMEM = 2 * Tile::BYTES + 2 * DKV_STAGE;
  static constexpr int DKV_SMEM_ROUNDED_Q = DKV_SMEM + Tile::BYTES;
  // a StreamCell adds a per-stage int array of the tile's key (dq) or
  // query (dkv) segments: after the six tiles (dq), or at the end of each
  // stage (dkv)
  static constexpr int DQ_SMEM_STREAM = DQ_SMEM + 2 * 64 * 4;
  static constexpr int DKV_STAGE_STREAM = DKV_STAGE + 64 * 4;
  static constexpr int DKV_SMEM_STREAM = 2 * Tile::BYTES + 2 * DKV_STAGE_STREAM;

  // dq of query rows [row0, row0 + 64) of cell fc (smem: DQ_SMEM bytes,
  // DQ_SMEM_STREAM for a StreamCell, whose rows are lattice indices)
  template <Logits LG = Logits::UNROUNDED_Q, class Cell = FlashCell>
  __device__ __forceinline__ static void dq(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                                            const __nv_bfloat16* __restrict__ v,
                                            const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                                            const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
                                            const Cell& fc, int row0, int causal, float qscale, float scale,
                                            unsigned char* smem) {
    constexpr bool FLASH = std::is_same<Cell, FlashCell>::value;
    constexpr int NT = 64 / 8;  // score tiles of 8 keys
    unsigned char* qs = smem;                      // Q tile, then the dq tile
    unsigned char* dos = smem + Tile::BYTES;       // dO tile
    unsigned char* ring = smem + 2 * Tile::BYTES;  // stage s: K, then V
    int* kseg = reinterpret_cast<int*>(smem + DQ_SMEM);  // StreamCell: stage s's key segments at 64 s

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane >> 2, c = lane & 3;
    const int lr = lane & 7, lm = lane >> 3;  // ldmatrix: row and matrix of this lane's address
    if (row0 >= fc.nq) return;  // past a flat layout's ragged last segment
    int kv = fc.kv;
    if (causal && kv > row0 + 64) kv = row0 + 64;
    int kt0 = 0, n_tiles = (kv + 63) / 64;  // the key tiles [kt0, kt0 + n_tiles) this block visits
    const __nv_bfloat16* kc = k;
    const __nv_bfloat16* vc = v;
    if constexpr (FLASH) {
      kc = k + fc.k0 * DH;
      vc = v + fc.k0 * DH;
      Tile::load(qs, q + (fc.q0 + row0) * DH, fc.nq - row0);
      Tile::load(dos, dout + (fc.q0 + row0) * DH, fc.nq - row0);
      if (n_tiles > 0) {
        Tile::load(ring, kc, kv);
        Tile::load(ring + Tile::BYTES, vc, kv);
      }
    } else {
      fc.key_tiles(row0, kt0, n_tiles);
      Tile::load_rows(qs, q + fc.ql.row(row0) * fc.ld_q, fc.ql.step * fc.ld_q, fc.nq - row0);
      Tile::load_rows(dos, dout + fc.ql.row(row0) * fc.ld_do, fc.ql.step * fc.ld_do, fc.nq - row0);
      if (n_tiles > 0) stream_kv(fc, k, v, 64 * kt0, ring, kseg);
    }
    cp_async_commit();

    // this thread's rows: g and g + 8 of the warp's 16
    int row[2], tseg[2];  // tseg: a StreamCell's row segments
    float lse2[2], dlt[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      row[h] = row0 + 16 * warp + g + 8 * h;
      const bool ok = row[h] < fc.nq;
      if constexpr (FLASH) {
        lse2[h] = ok ? lse[fc.q0 + row[h]] * LOG2E : 0.f;
        dlt[h] = ok ? delta[fc.q0 + row[h]] : 0.f;
      } else {
        const int i = fc.ql.row(row[h]);
        lse2[h] = ok ? lse[i] * LOG2E : 0.f;
        dlt[h] = ok ? delta[i] : 0.f;
        tseg[h] = fc.q_seg(row[h]);
      }
    }
    uint32_t qa[KS][4], da[KS][4];
    float acc[DT][4];
#pragma unroll
    for (int t = 0; t < DT; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;

    for (int kt = 0; kt < n_tiles; ++kt) {
      const int stage = kt & 1;
      if (kt + 1 < n_tiles) {
        unsigned char* next = ring + (stage ^ 1) * 2 * Tile::BYTES;
        if constexpr (FLASH) {
          Tile::load(next, kc + (long long)(kt + 1) * 64 * DH, kv - (kt + 1) * 64);
          Tile::load(next + Tile::BYTES, vc + (long long)(kt + 1) * 64 * DH, kv - (kt + 1) * 64);
        } else {
          stream_kv(fc, k, v, 64 * (kt0 + kt + 1), next, kseg + 64 * (stage ^ 1));
        }
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
          if constexpr (LG == Logits::ROUNDED_Q) scale_bf16(qa[kk], qscale);
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
        int2 useg = make_int2(0, 0);  // a StreamCell's segments of keys 8 t + 2 c, + 1
        if constexpr (!FLASH) useg = *reinterpret_cast<const int2*>(kseg + 64 * stage + 8 * t + 2 * c);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = key0 + 8 * t + 2 * c + e;
            bool ok;
            if constexpr (FLASH) {
              ok = col < kv && (!causal || col <= row[h]);
            } else {
              ok = (e ? useg.y : useg.x) == tseg[h];
            }
            const float p = ok ? exp2_approx(LG == Logits::ROUNDED_Q ? sc[t][2 * h + e] - lse2[h]
                                                                     : fmaf(sc[t][2 * h + e], qscale, -lse2[h]))
                               : 0.f;
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
    if constexpr (FLASH) {
      Tile::store(dq + (fc.q0 + row0) * DH, qs, fc.nq - row0);
    } else {
      Tile::store_rows(dq + fc.ql.row(row0) * fc.ld_o1, fc.ql.step * fc.ld_o1, qs, fc.nq - row0);
    }
  }

  // A StreamCell's key tile of lattice keys [m0, m0 + 64) into a dq ring
  // stage (K, then V), and its keys' segments into seg, by the block
  template <class Cell>
  __device__ __forceinline__ static void stream_kv(const Cell& fc, const __nv_bfloat16* k, const __nv_bfloat16* v,
                                                   int m0, unsigned char* st, int* seg) {
    Tile::load_rows(st, k + fc.kl.row(m0) * fc.ld_k, fc.kl.step * fc.ld_k, fc.kv - m0);
    Tile::load_rows(st + Tile::BYTES, v + fc.kl.row(m0) * fc.ld_v, fc.kl.step * fc.ld_v, fc.kv - m0);
    if (threadIdx.x < 64) seg[threadIdx.x] = fc.k_seg(m0 + threadIdx.x);
  }

  // dk and dv of keys [key0, key0 + 64) of cell fc (smem: DKV_SMEM bytes,
  // DKV_SMEM_ROUNDED_Q for ROUNDED_Q, DKV_SMEM_STREAM for a StreamCell,
  // whose keys are lattice indices and whose keys past kv are not written)
  template <Logits LG = Logits::UNROUNDED_Q, class Cell = FlashCell>
  __device__ __forceinline__ static void dkv(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                                             const __nv_bfloat16* __restrict__ v,
                                             const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                                             const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                                             __nv_bfloat16* __restrict__ dv, const Cell& fc, int key0, int causal,
                                             int flat, float qscale, float scale, unsigned char* smem) {
    constexpr bool FLASH = std::is_same<Cell, FlashCell>::value;
    constexpr int STAGE = FLASH ? DKV_STAGE : DKV_STAGE_STREAM;  // bytes of a ring stage
    static_assert(FLASH || LG == Logits::UNROUNDED_Q, "a StreamCell's logits take the unrounded q");
    constexpr int QN = DH > 64 ? 32 : 64;  // query columns of one pass (registers)
    constexpr int NT = QN / 8;             // score tiles of 8 queries in a pass
    unsigned char* ks = smem;                      // K tile, then the dk tile
    unsigned char* vs = smem + Tile::BYTES;        // V tile, then the dv tile
    unsigned char* ring = smem + 2 * Tile::BYTES;

    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int c = lane & 3;
    const int lr = lane & 7, lm = lane >> 3;  // ldmatrix: row and matrix of this lane's address
    if (key0 >= fc.nk) return;  // past a flat layout's ragged last segment
    __nv_bfloat16* dkt = dk;  // a StreamCell's rows are placed at the store
    __nv_bfloat16* dvt = dv;
    if constexpr (FLASH) {
      dkt = dk + (fc.k0 + key0) * DH;
      dvt = dv + (fc.k0 + key0) * DH;
    }
    const int kv = fc.kv;
    if constexpr (FLASH) {
      if (key0 >= kv) {  // no valid key in this tile: exact zeros, no work
        Tile::store(dkt, nullptr, fc.nk - key0, true);
        Tile::store(dvt, nullptr, fc.nk - key0, true);
        return;
      }
    }
    const int q_end = flat ? kv : fc.nq;  // query rows that contribute
    // causal: query rows below the key tile see none of its keys; a
    // StreamCell's query tiles start at the first that can meet the keys
    int q_start = causal ? key0 : 0;
    int n_tiles = q_end > q_start ? (q_end - q_start + 63) / 64 : 0;
    if constexpr (!FLASH) {
      fc.query_tiles(key0, q_start, n_tiles);
      q_start *= 64;
    }
    const __nv_bfloat16* qc = q;
    const __nv_bfloat16* dc = dout;
    const float* lc = lse;
    const float* tc = delta;
    if constexpr (FLASH) {
      qc = q + fc.q0 * DH;
      dc = dout + fc.q0 * DH;
      lc = lse + fc.q0;
      tc = delta + fc.q0;
    }

    // query tile at row i0 of the cell into a ring stage
    auto load_query_tile = [&](int i0, unsigned char* st) {
      if constexpr (FLASH) {
        Tile::load(st, qc + (long long)i0 * DH, q_end - i0);
        Tile::load(st + Tile::BYTES, dc + (long long)i0 * DH, q_end - i0);
        const int e = tid & 63;
        const bool ok = i0 + e < q_end;
        const float* src = tid < 64 ? lc : tc;
        cp_async4_zfill(st + 2 * Tile::BYTES + 4 * tid, ok ? src + i0 + e : src, ok);
      } else {
        Tile::load_rows(st, qc + fc.ql.row(i0) * fc.ld_q, fc.ql.step * fc.ld_q, q_end - i0);
        Tile::load_rows(st + Tile::BYTES, dc + fc.ql.row(i0) * fc.ld_do, fc.ql.step * fc.ld_do, q_end - i0);
        const int e = tid & 63;
        const bool ok = i0 + e < q_end;
        const float* src = tid < 64 ? lc : tc;
        cp_async4_zfill(st + 2 * Tile::BYTES + 4 * tid, ok ? src + fc.ql.row(i0 + e) : src, ok);
        if (tid < 64) reinterpret_cast<int*>(st + DKV_STAGE)[tid] = fc.q_seg(i0 + tid);
      }
    };
    if constexpr (FLASH) {
      Tile::load(ks, k + (fc.k0 + key0) * DH, kv - key0);
      Tile::load(vs, v + (fc.k0 + key0) * DH, kv - key0);
    } else {
      Tile::load_rows(ks, k + fc.kl.row(key0) * fc.ld_k, fc.kl.step * fc.ld_k, kv - key0);
      Tile::load_rows(vs, v + fc.kl.row(key0) * fc.ld_v, fc.kl.step * fc.ld_v, kv - key0);
    }
    if (n_tiles > 0) load_query_tile(q_start, ring);
    cp_async_commit();

    int key[2], kseg[2];  // this thread's keys: rows g and g + 8 of the warp's 16; a StreamCell's key segments
    key[0] = key0 + 16 * warp + (lane >> 2);
    key[1] = key[0] + 8;
    if constexpr (!FLASH) {
      kseg[0] = fc.k_seg(key[0]);
      kseg[1] = fc.k_seg(key[1]);
    }
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
      if (it + 1 < n_tiles) load_query_tile(i0 + 64, ring + (stage ^ 1) * STAGE);
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
      // ROUNDED_Q: the Q operand of S^T is the landed tile times qscale in
      // bf16, written after the previous tile's closing barrier; dK +=
      // dS^T.Q reads the stage
      if constexpr (LG == Logits::ROUNDED_Q) {
        Tile::scaled_copy(smem + DKV_SMEM, qs, qscale);
        __syncthreads();
      }

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
            ldmatrix_x4(b, (LG == Logits::ROUNDED_Q ? smem + DKV_SMEM : qs) + boff + (c0 + 16 * tp) * PITCH + 32 * kk);
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
          int2 qseg = make_int2(0, 0);  // a StreamCell's segments of query columns col, col + 1
          if constexpr (!FLASH) qseg = *reinterpret_cast<const int2*>(qs + DKV_STAGE + 4 * col);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = i0 + col + (e & 1);
            const int kj = key[e >> 1];
            bool ok;
            if constexpr (FLASH) {
              ok = kj < kv && qi < q_end && (!causal || kj <= qi);
            } else {
              ok = ((e & 1) ? qseg.y : qseg.x) == kseg[e >> 1];
            }
            const float p = ok ? exp2_approx(LG == Logits::ROUNDED_Q
                                                 ? sc[t][e] - ((e & 1) ? l2.y : l2.x) * LOG2E
                                                 : fmaf(sc[t][e], qscale, -((e & 1) ? l2.y : l2.x) * LOG2E))
                               : 0.f;
            sc[t][e] = p;
            dp[t][e] = p * (dp[t][e] - ((e & 1) ? d2.y : d2.x));
          }
        }
        // dv += p^T . dO and dk += ds^T . Q, 16 queries a step, each of p
        // and ds as hi + lo; dO's and Q's 8 x 8 blocks transposed into B
        // fragments
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
    if constexpr (FLASH) {
      Tile::store(dkt, ks, fc.nk - key0);
      Tile::store(dvt, vs, fc.nk - key0);
    } else {
      Tile::store_rows(dk + fc.kl.row(key0) * fc.ld_o1, fc.kl.step * fc.ld_o1, ks, fc.nk - key0);
      Tile::store_rows(dv + fc.kl.row(key0) * fc.ld_o2, fc.kl.step * fc.ld_o2, vs, fc.nk - key0);
    }
  }
};

}  // namespace gp
