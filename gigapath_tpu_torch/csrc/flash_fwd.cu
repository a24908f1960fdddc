// Forward of segment-batched flash attention with log-sum-exp output, in the
// segmented [B, H, S, M, D] or the flat [B, H, L, D] layout (see
// flash_common.cuh).
//
// Replaces the Pallas kernel gigapath_tpu/ops/pallas_flash.py:_fwd_kernel,
// both where _fwd_impl calls it on segments (PERF.md row 11) and where
// _flat_fwd_impl calls it on flat segments (row 13). Inputs q, k, v (fp32 or
// bf16); kvlen int32 [B, H, S] or null (flat: counts from real_len).
// Outputs: out in q's layout and dtype, lse fp32 [B, H, S, Mq] (flat: [B, H,
// L]), row for row with q.
//
// Numerics follow the Pallas kernel: q * scale*log2(e) rounded to the input
// dtype, fp32 scores and an online softmax in base 2, the running max
// floored at -1e20 so masked keys (-1e30, selected before the max) underflow
// to an exact 0, the probabilities rounded to the input dtype before p @ v
// (their sum l stays fp32), out = acc / max(l, 1e-30) and lse = (m +
// log2(max(l, 1e-30))) * ln 2: a row with no valid key gives out = 0 and lse
// ~ -6.9e19. Causal masks key j > query i within a segment. In bf16 the
// running max moves per 64-key tile (branch_mma.cuh says why), as in the
// plain version (ops/flash_kernels.py:flash_fwd_reference).
//
// Bound on the H100: operations, 4*D per admitted (query, key) pair (q.k and
// p.v), next to about 4*D elements moved per row; and one exp2 per admitted
// pair on the MUFU pipes (16 a clock per SM), more time than the bf16
// tensor cores' bound at D = 48.
//
// Two kernels, chosen by the tensors' dtype:
// - bf16 tensors (head widths that are multiples of 8): the tensor cores,
//   through the tile steps of the dilated branch forward (branch_mma.cuh,
//   BranchFwdMma) on a FlashCell. A block of 4 warps owns one (segment,
//   64-row query tile), 16 rows a warp. The Q tile arrives once by cp.async
//   (rows past the segment's count zero-filled without a read) and stays
//   in registers as A fragments (times the scale, rounded to bf16); K and V
//   tiles of 64 keys stream through a two-stage cp.async ring, rows at or
//   past the valid count zero-filled without a read (a flat segment's keys
//   past real_len are real rows of the next tokens, and a ragged last
//   segment ends at L), and staging stops at the first tile past the count
//   (in a causal call, past the query tile's last row, so the diagonal tile
//   is the last and the only one masked for causality). Only the tile
//   holding the count or the diagonal pays for the masks. The output goes
//   through the Q tile's shared memory as 16-byte stores of the segment's
//   rows only, and lse of those rows: a ragged query tile's other rows
//   belong to the next segment or (b, h) pair, or lie past the tensor.
//   Registers are capped for 4 blocks an SM below D = 64, 3 at 64, 2
//   above.
// - fp32 tensors (a tensor-core product in fp32 would be TF32, another
//   function): the fp32 FMA pipes. One block per 64-row query tile of a
//   segment, one thread per query row holding q, the output accumulator
//   and a strip of scores in registers; each key tile is staged once in
//   shared memory as fp32 (rows at or past the valid count as zeros) and
//   read by all rows with broadcast float4 loads; key tiles past the count
//   (or past the tile's last row when causal) are never loaded.
//
// Both keep one flat grid, the query tiles of a segment adjacent, so they
// share its K/V in L2, and a block whose tile starts past the segment's
// rows (a flat layout's ragged last segment) returns at once.

#include <cstdint>

#include "branch_mma.cuh"
#include "flash_common.cuh"
#include "pipe_common.cuh"  // cp_async_commit, cp_async_wait, aligned16

// The head width is a compile-time constant (q, the accumulator and the
// score strip live in registers): one library per head width a model uses,
// -DGP_HEAD_DIM=<D>.
#ifndef GP_HEAD_DIM
#error "compile with -DGP_HEAD_DIM=<head width>"
#endif
static_assert(GP_HEAD_DIM % 4 == 0 && GP_HEAD_DIM <= 128, "head width: a multiple of 4, at most 128");

namespace {

using namespace gp;

template <typename T, int DH, int BN>
__global__ void __launch_bounds__(BM)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ kvlen,
                     T* __restrict__ out, float* __restrict__ lse, int S, int Mq,
                     int Mk, int Lq, int Lk, int real_len, int causal, float qscale,
                     int n_qtiles) {
  static_assert(DH % 4 == 0, "float4 shared-memory reads need DH % 4 == 0");
  static_assert(2 * BN >= BM, "the q tile is staged in the K/V buffer");
  __shared__ __align__(16) float smem[2 * BN * DH];
  float* ks = smem;
  float* vs = smem + BN * DH;

  // one flat grid, the query tiles of a segment adjacent (they share its
  // K/V in L2)
  const int tid = threadIdx.x;
  const int cell = blockIdx.x / n_qtiles;
  const int row0 = (blockIdx.x - cell * n_qtiles) * BM;
  const FlashCell c = flash_cell(cell, S, Mq, Mk, Lq, Lk, kvlen, real_len);
  if (row0 >= c.nq) return;  // past a flat layout's ragged last segment
  const int row = row0 + tid;
  int kv = c.kv;
  if (causal && kv > row0 + BM) kv = row0 + BM;

  stage_rows<T, DH, BM>(q + (c.q0 + row0) * DH, c.nq - row0, smem);
  __syncthreads();
  float qr[DH];
  row_from_smem<DH>(smem, qr, qscale);
#pragma unroll
  for (int d = 0; d < DH; ++d) qr[d] = round_to<T>(qr[d]);

  float acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;
  float m_run = FLASH_M_FLOOR;
  float l_run = 0.f;

  const int n_tiles = (kv + BN - 1) / BN;
  for (int kt = 0; kt < n_tiles; ++kt) {
    __syncthreads();  // the previous tile (or the q staging) is consumed
    const int key0 = kt * BN;
    stage_rows<T, DH, BN>(k + (c.k0 + key0) * DH, kv - key0, ks);
    stage_rows<T, DH, BN>(v + (c.k0 + key0) * DH, kv - key0, vs);
    __syncthreads();

    float s[BN];
    float tmax = FLASH_M_FLOOR;
#pragma unroll
    for (int j = 0; j < BN; ++j) {
      const float a = dot_smem<DH>(qr, ks + j * DH);
      const int col = key0 + j;
      const bool ok = col < kv && (!causal || col <= row);
      s[j] = ok ? a : FLASH_NEG_INF;
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
    for (int j = 0; j < BN; ++j) axpy_smem<DH>(round_to<T>(s[j]), vs + j * DH, acc);
    m_run = m_new;
  }

  const float safe_l = fmaxf(l_run, 1e-30f);
  if (row < c.nq) lse[c.q0 + row] = (m_run + log2f(safe_l)) * LN2;
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] /= safe_l;
  store_rows<T, DH>(acc, 1.f, smem, out + (c.q0 + row0) * DH, c.nq - row0);
}

template <typename T, int DH, int BN>
int launch(const void* q, const void* k, const void* v, const int* kvlen, void* out,
           float* lse, int n_bh, int S, int Mq, int Mk, int Lq, int Lk, int real_len,
           int causal, float qscale, cudaStream_t stream) {
  const int n_qtiles = (Mq + BM - 1) / BM;
  const unsigned blocks = (unsigned)n_bh * (unsigned)S * (unsigned)n_qtiles;
  flash_fwd_kernel<T, DH, BN><<<blocks, BM, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), kvlen,
      static_cast<T*>(out), lse, S, Mq, Mk, Lq, Lk, real_len, causal, qscale, n_qtiles);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the tensor-core kernel (bf16 tensors)
// ---------------------------------------------------------------------------

// The key loop is dilated_branch_fwd.cu's, on a FlashCell; it stays a copy
// because moving it into branch_mma.cuh changed row 1's SASS at Dh = 48.
template <int DH>
__global__ void __launch_bounds__(128, DH < 64 ? 4 : DH == 64 ? 3 : 2)
    flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, const int* __restrict__ kvlen,
                         __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int S, int Mq, int Mk,
                         int Lq, int Lk, int real_len, int causal, float qscale, int n_qtiles) {
  using F = BranchFwdMma<DH>;
  using Tile = typename F::Tile;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* qs = smem;                  // Q tile, then the output tile
  unsigned char* ring = smem + Tile::BYTES;  // stage s: K, then V

  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) >> 2;
  const int cell = blockIdx.x / n_qtiles;
  const int row0 = (blockIdx.x - cell * n_qtiles) * 64;
  const FlashCell c = flash_cell(cell, S, Mq, Mk, Lq, Lk, kvlen, real_len);
  if (row0 >= c.nq) return;  // past a flat layout's ragged last segment
  const __nv_bfloat16* kc = k + c.k0 * DH;
  const __nv_bfloat16* vc = v + c.k0 * DH;
  int kv = c.kv;
  if (causal && kv > row0 + 64) kv = row0 + 64;
  const int n_tiles = (kv + 63) / 64;

  Tile::load(qs, q + (c.q0 + row0) * DH, c.nq - row0);
  if (n_tiles > 0) {
    Tile::load(ring, kc, kv);
    Tile::load(ring + Tile::BYTES, vc, kv);
  }
  cp_async_commit();

  const int row[2] = {row0 + 16 * warp + g, row0 + 16 * warp + g + 8};
  uint32_t qa[F::KS][4];
  float acc[F::DT][4];
#pragma unroll
  for (int t = 0; t < F::DT; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
  float m[2] = {F::M_FLOOR, F::M_FLOOR}, l[2] = {0.f, 0.f};

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int stage = kt & 1;
    if (kt + 1 < n_tiles) {
      unsigned char* next = ring + (stage ^ 1) * 2 * Tile::BYTES;
      const int rows = kv - (kt + 1) * 64;
      Tile::load(next, kc + (long long)(kt + 1) * 64 * DH, rows);
      Tile::load(next + Tile::BYTES, vc + (long long)(kt + 1) * 64 * DH, rows);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (kt == 0) F::load_q(qa, qs, qscale);
    const unsigned char* ks = ring + stage * 2 * Tile::BYTES;
    float sc[F::NT][4];
    uint32_t pa[F::NT][2];
    F::scores(sc, qa, ks);
    const bool masked = (kt + 1) * 64 > kv || (causal && kt == n_tiles - 1);
    F::softmax(sc, m, l, acc, pa, masked, kt * 64, kv, causal, row);
    F::pv(acc, pa, ks + Tile::BYTES);
    __syncthreads();  // the stage is consumed before the next loads overwrite it
  }

  cp_async_wait<0>();  // no copy may land in the Q tile once it holds the output
  __syncthreads();
  F::template finish<true>(acc, m, l, qs, out + (c.q0 + row0) * DH, lse + c.q0 + row0, c.nq - row0);
}

template <int DH>
int launch_mma(const void* q, const void* k, const void* v, const int* kvlen, void* out, float* lse,
               int n_bh, int S, int Mq, int Mk, int Lq, int Lk, int real_len, int causal, float qscale,
               cudaStream_t stream) {
  if constexpr (DH % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  } else {
    constexpr int SMEM = 5 * MmaTile<DH>::BYTES;  // Q, two stages of K and V
    const cudaError_t err =
        cudaFuncSetAttribute(flash_fwd_mma_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return (int)err;
    const int n_qtiles = (Mq + 63) / 64;
    const unsigned blocks = (unsigned)n_bh * (unsigned)S * (unsigned)n_qtiles;
    flash_fwd_mma_kernel<DH><<<blocks, 128, SMEM, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), kvlen, static_cast<__nv_bfloat16*>(out), lse, S, Mq, Mk, Lq, Lk,
        real_len, causal, qscale, n_qtiles);
    return (int)cudaGetLastError();
  }
}

}  // namespace

// is_bf16: 0 = fp32 tensors, 1 = bf16 tensors. n_bh = B*H; the layout as in
// flash_common.cuh; kvlen may be null (then real_len bounds the keys); fewer
// than 2^31 query tiles; D == GP_HEAD_DIM; qscale = D^-0.5 * log2(e). bf16
// tensors take the tensor-core kernel, which needs a head width that is a
// multiple of 8 and q, k, v and out 16-byte aligned; fp32 tensors the FMA
// kernel, whose key tiles are 64 rows, or 32 above a head width of 64 to
// keep the K/V tiles and registers in bounds.
extern "C" int gp_flash_fwd(const void* q, const void* k, const void* v, const int* kvlen,
                            void* out, float* lse, int is_bf16, int n_bh, int S, int Mq,
                            int Mk, int Lq, int Lk, int real_len, int causal, float qscale,
                            void* stream) {
  constexpr int BN = GP_HEAD_DIM > 64 ? 32 : 64;
  if (!flash_layout_ok(n_bh, S, Mq, Mk, Lq, Lk, Mq, real_len))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (!gp::aligned16({q, k, v, out})) return (int)cudaErrorMisalignedAddress;
    return launch_mma<GP_HEAD_DIM>(q, k, v, kvlen, out, lse, n_bh, S, Mq, Mk, Lq, Lk, real_len, causal,
                                   qscale, st);
  }
  return launch<float, GP_HEAD_DIM, BN>(q, k, v, kvlen, out, lse, n_bh, S, Mq, Mk, Lq, Lk,
                                        real_len, causal, qscale, st);
}
