// The tile steps of the bf16 tensor-core forward of one dilated branch on
// the phase-major packed layout, shared by the serial kernel
// (dilated_branch_fwd.cu, PERF.md row 1) and the pipelined one
// (dilated_branch_fwd_pipe.cu, row 6), which compute the same function and
// differ only in how they order the steps, and by the segment-flash
// forward (flash_fwd.cu, rows 11 and 13), which runs them on a FlashCell
// and stores a ragged last query tile's rows only (finish<true>), and by
// the streaming pair forward (stream_pair_fwd.cu, row 15), which runs
// load_q, scores, softmax (its segment mask applied before, by select)
// and pv on a StreamCell, with its own epilogue to the lattice rows.
//
// A block of 4 warps owns 64 query rows of one cell, 16 a warp; thread
// (warp, lane = 4 g + c) holds rows g and g + 8 of its warp's 16 (index h =
// 0, 1 below) and, of each 8-key score tile, columns 2c and 2c + 1 (the C
// fragment of mma.sync.m16n8k16, mma_common.cuh). Per 64-key tile:
//   scores   S = Q.K^T on the tensor cores (bf16 products, fp32 sums), Q as
//            A fragments held for the whole key loop, K as B fragments by
//            ldmatrix;
//   softmax  the masks by select (-1e30 past kvlen, and past the diagonal
//            when causal) before the row max (quad shuffles), the running
//            max floored at -1e20 so masked keys underflow to an exact 0,
//            p = 2^(s - m) on MUFU (ex2.approx), the rescale of O and of
//            the thread's share of l by 2^(m_old - m_new); l sums the fp32
//            p, and P is rounded to bf16 and packed straight from the C
//            fragments into the A fragments of P.V;
//   pv       O += P.V on the tensor cores, V as B fragments by
//            ldmatrix.trans.
// The roundings are the Pallas kernels' in bf16: q*scale*log2(e) rounded
// once before the key loop (load_q), p before P.V; the products sum in
// fp32. The epilogue (finish) writes O / l and lse = (m + log2 l) ln2; a
// row with no valid key gives O = 0 and lse ~ -6.9e19.
//
// Which function this is in bf16: p is rounded relative to the running
// max, so where the max is taken decides the rounding. Here it is taken
// per 64-key tile, as in the plain version (ops/dilated_kernels.py:
// dilated_branch_fwd_reference). The Pallas kernels take it per block (one
// block per cell up to m = 1024 in the serial forward, 512 keys in the
// pipelined one); matching them would need each row's max over a whole
// block before any P.V, a second Q.K^T pass. Past one key tile the two
// differ by a few bf16 roundings of p (tests/test_torch_dilated.py::
// test_serial_bf16_multi_tile_matches_jax); in fp32 they are one function.

#pragma once

#include "branch_common.cuh"
#include "mma_common.cuh"

namespace gp {

template <int DH>
struct BranchFwdMma {
  using Tile = MmaTile<DH>;
  static constexpr int PITCH = Tile::PITCH;
  static constexpr int KS = Tile::DK / 16;  // steps of the Q.K^T contraction
  static constexpr int NT = 64 / 8;         // score tiles of 8 keys
  static constexpr int DT = Tile::DK / 8;   // output tiles of 8 columns (even)
  static constexpr float M_FLOOR = -1e20f;
  static constexpr float NEG_INF = -1e30f;

  // A fragments of the warp's 16 rows of the Q tile at qs, each element
  // times qscale and rounded to bf16
  __device__ __forceinline__ static void load_q(uint32_t (&qa)[KS][4], const unsigned char* qs, float qscale) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int lr = lane & 7, lm = lane >> 3;  // ldmatrix: row and matrix of this lane's address
    const int off = (16 * warp + lr + 8 * (lm & 1)) * PITCH + 16 * (lm >> 1);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      ldmatrix_x4(qa[kk], qs + off + 32 * kk);
      scale_bf16(qa[kk], qscale);
    }
  }

  // S of the warp's 16 rows against the 64 keys of the K tile at ks; B
  // fragments of key tiles (t, t + 1), columns lo / hi of each step
  __device__ __forceinline__ static void scores(float (&sc)[NT][4], const uint32_t (&qa)[KS][4],
                                                const unsigned char* ks) {
    const int lane = threadIdx.x % 32;
    const int lr = lane & 7, lm = lane >> 3;
    const int boff = (lr + 8 * (lm >> 1)) * PITCH + 16 * (lm & 1);
#pragma unroll
    for (int t = 0; t < NT; ++t) sc[t][0] = sc[t][1] = sc[t][2] = sc[t][3] = 0.f;
#pragma unroll
    for (int tp = 0; tp < NT / 2; ++tp) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t b[4];
        ldmatrix_x4(b, ks + boff + 16 * tp * PITCH + 32 * kk);
        mma_bf16(sc[2 * tp], qa[kk], b[0], b[1]);
        mma_bf16(sc[2 * tp + 1], qa[kk], b[2], b[3]);
      }
    }
  }

  // One online-softmax step on the scores of keys [key0, key0 + 64): with
  // `masked`, keys at or past kv (and past row[h] when causal) get -1e30
  // first. Updates the running max m, this thread's share of l and O, and
  // leaves bf16 P in the A-fragment order of the keys-deep product.
  __device__ __forceinline__ static void softmax(float (&sc)[NT][4], float (&m)[2], float (&l)[2],
                                                 float (&acc)[DT][4], uint32_t (&pa)[NT][2], bool masked, int key0,
                                                 int kv, bool causal, const int (&row)[2]) {
    const int c = threadIdx.x % 4;
    if (masked) {
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = key0 + 8 * t + 2 * c + e;
            const bool ok = col < kv && (!causal || col <= row[h]);
            sc[t][2 * h + e] = ok ? sc[t][2 * h + e] : NEG_INF;
          }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      mx[0] = fmaxf(mx[0], fmaxf(sc[t][0], sc[t][1]));
      mx[1] = fmaxf(mx[1], fmaxf(sc[t][2], sc[t][3]));
    }
    float alpha[2], ps[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      alpha[h] = exp2_approx(m[h] - mx[h]);
      m[h] = mx[h];
    }
#pragma unroll
    for (int t = 0; t < NT; ++t) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float p0 = exp2_approx(sc[t][2 * h] - mx[h]);
        const float p1 = exp2_approx(sc[t][2 * h + 1] - mx[h]);
        ps[h] += p0 + p1;
        pa[t][h] = pack_bf16(p0, p1);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + ps[h];
#pragma unroll
    for (int t = 0; t < DT; ++t) {
      acc[t][0] *= alpha[0];
      acc[t][1] *= alpha[0];
      acc[t][2] *= alpha[1];
      acc[t][3] *= alpha[1];
    }
  }

  // O += P.V for the V tile at vs: 16 keys a step; V's 8 x 8 blocks
  // transposed into B fragments of output tiles (2 j, 2 j + 1)
  __device__ __forceinline__ static void pv(float (&acc)[DT][4], const uint32_t (&pa)[NT][2], const unsigned char* vs) {
    const int lane = threadIdx.x % 32;
    const int lr = lane & 7, lm = lane >> 3;
    const int toff = (lr + 8 * (lm & 1)) * PITCH + 16 * (lm >> 1);
#pragma unroll
    for (int s16 = 0; s16 < 4; ++s16) {
      const uint32_t a[4] = {pa[2 * s16][0], pa[2 * s16][1], pa[2 * s16 + 1][0], pa[2 * s16 + 1][1]};
#pragma unroll
      for (int j = 0; j < DT / 2; ++j) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vs + toff + 16 * s16 * PITCH + 32 * j);
        mma_bf16(acc[2 * j], a, b[0], b[1]);
        mma_bf16(acc[2 * j + 1], a, b[2], b[3]);
      }
    }
  }

  // The epilogue, after every copy into shared memory has landed and a
  // barrier: O / l of the 64 rows through the tile at os (16-byte stores
  // to out), lse = (m + log2 l) ln2 of each row to lse_rows. With RAGGED,
  // only rows [0, rows) reach out and lse_rows (the segment-flash forward,
  // whose last query tile of a segment may hold fewer than 64 rows); the
  // packed branch kernels store all 64. The branch without RAGGED keeps
  // the statements of the epilogue before the parameter: computing the row
  // index ahead of the lane test there changed row 6's SASS at Dh = 48.
  template <bool RAGGED = false>
  __device__ __forceinline__ static void finish(float (&acc)[DT][4], const float (&m)[2], float (&l)[2],
                                                unsigned char* os, __nv_bfloat16* out, float* lse_rows,
                                                int rows = 64) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    float safe[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      safe[h] = fmaxf(l[h], 1e-30f);
      if constexpr (RAGGED) {
        const int row = 16 * warp + (lane >> 2) + 8 * h;
        if ((lane & 3) == 0 && row < rows) lse_rows[row] = (m[h] + log2f(safe[h])) * LN2;
      } else {
        if ((lane & 3) == 0) lse_rows[16 * warp + (lane >> 2) + 8 * h] = (m[h] + log2f(safe[h])) * LN2;
      }
    }
#pragma unroll
    for (int t = 0; t < DT; ++t) {
      acc[t][0] /= safe[0];
      acc[t][1] /= safe[0];
      acc[t][2] /= safe[1];
      acc[t][3] /= safe[1];
    }
    Tile::put(os, acc, 1.f);
    __syncthreads();
    if constexpr (RAGGED) {
      Tile::store(out, os, rows);
    } else {
      Tile::store(out, os, 64);
    }
  }
};

}  // namespace gp
