// Forward attention of one dilated branch on the phase-major packed layout.
//
// Replaces the Pallas kernel gigapath_tpu/ops/pallas_dilated.py:_fwd_kernel
// (called by _fwd_impl; PERF.md row 1). Inputs q, k, v are packed [B, S, r,
// hb, Mp, Dh] (fp32 or bf16); kvlen is int32 [B, S, r]. Cell (b, s, p, t) is
// one head of band p attending the phase-p tokens of segment s: query row i
// attends key rows j < kvlen[b, s, p] (and j <= i when causal). Outputs: out
// in the packed layout and input dtype, lse as fp32 [B, S, r, hb, Mp] (the
// TPU kernel's 128-lane lse slab is a TPU layout and is not copied).
//
// Numerics follow the Pallas kernel: fp32 scores and online softmax in base
// 2 (log2(e) folded into the q scale), the running max floored at -1e20 so
// masked keys (-1e30, applied by select before the max) underflow to an
// exact 0, and a row with no valid key gives out = 0 and lse ~ -6.9e19. In
// bf16 the Pallas kernel rounds q*scale*log2(e) to bf16 before QK^T and the
// probabilities before PV (the denominator sums them unrounded); the bf16
// kernel here rounds at the same places. In fp32 both roundings are no-ops.
//
// Bound on the H100: operations, 4*m*kvlen*Dh per cell (QK^T and PV), next
// to about 4*m*Dh elements moved; and one exp2 per admitted (query, key)
// pair on the MUFU pipes (16 a clock per SM), more time than the bf16
// tensor cores' bound at Dh = 48.
//
// Two kernels, chosen by the tensors' dtype:
// - bf16 tensors (head widths that are multiples of 8): the tensor cores,
//   through the tile steps of branch_mma.cuh. A block of 4 warps owns one
//   (cell, 64-row query tile), 16 rows a warp. The Q tile arrives once by
//   cp.async and stays in registers as A fragments (times the scale,
//   rounded to bf16); K and V tiles of 64 keys stream through a two-stage
//   cp.async ring, the next tile in flight while the current one computes,
//   rows at or past kvlen zero-filled without a read, and staging stops at
//   the first tile past kvlen (in a causal call, past the query tile's
//   last row, so the diagonal tile is the last and the only one masked for
//   causality). Only the tile holding kvlen or the diagonal pays for the
//   masks. The output goes through the Q tile's shared memory (after every
//   copy has landed) as 16-byte stores. Registers are capped for 4 blocks
//   an SM below Dh = 64 (125 at the flagship's 48), 3 at 64, 2 above.
// - fp32 tensors (a tensor-core product in fp32 would be TF32, another
//   function): the fp32 FMA pipes. One thread per query row (a 64-row query
//   tile per block) keeps q, the output accumulator and a 64-key score
//   strip in registers; each K/V tile is staged once in shared memory and
//   read by all 64 rows with broadcast float4 loads, so every shared-memory
//   load feeds four FMAs; key tiles past kvlen (or past the tile's last row
//   when causal) are never loaded or computed.
//
// Both keep one flat grid, the query tiles of a cell adjacent, so they run
// close together and share the cell's K/V in L2; a flat grid also puts no
// 65535 cap (gridDim.y's) on the number of cells.

#include <cstdint>

#include "branch_mma.cuh"
#include "pipe_common.cuh"  // cp_async_commit, cp_async_wait

// The head width is a compile-time constant (q, the accumulator and the
// scores live in registers): the build compiles one library per head width
// a model uses, with -DGP_HEAD_DIM=<Dh>.
#ifndef GP_HEAD_DIM
#error "compile with -DGP_HEAD_DIM=<head width>"
#endif
static_assert(GP_HEAD_DIM % 4 == 0 && GP_HEAD_DIM <= 128, "head width: a multiple of 4, at most 128");

namespace {

using namespace gp;

constexpr float M_FLOOR = -1e20f;
constexpr float NEG_INF = -1e30f;

template <typename T, int DH, int BN>
__global__ void __launch_bounds__(BM)
    dilated_branch_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v,
                              const int* __restrict__ kvlen,
                              T* __restrict__ out, float* __restrict__ lse,
                              int HB, int Mp, int causal, float qscale) {
  static_assert(DH % 4 == 0, "float4 shared-memory reads need DH % 4 == 0");
  static_assert(2 * BN >= BM, "the q tile is staged in the K/V buffer");
  __shared__ __align__(16) float smem[2 * BN * DH];
  float* ks = smem;
  float* vs = smem + BN * DH;

  const int tid = threadIdx.x;
  const int n_qtiles = Mp / BM;
  const int cell = blockIdx.x / n_qtiles;  // ((b*S + s)*r + p)*hb + t
  const int row0 = (blockIdx.x - cell * n_qtiles) * BM;
  const int row = row0 + tid;
  const long long base = (long long)cell * Mp * DH;

  int kv = kvlen[cell / HB];
  kv = kv < Mp ? kv : Mp;
  if (causal && kv > row0 + BM) kv = row0 + BM;

  // q tile: coalesced load into shared memory, then one row per thread
  const T* qt = q + base + (long long)row0 * DH;
  for (int e = tid; e < BM * DH; e += BM) smem[e] = load_f32(qt + e);
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
  float m_run = M_FLOOR;
  float l_run = 0.f;

  const int n_tiles = (kv + BN - 1) / BN;
  for (int kt = 0; kt < n_tiles; ++kt) {
    __syncthreads();  // the previous tile (or the q staging) is consumed
    const long long off = base + (long long)kt * BN * DH;
    for (int e = tid; e < BN * DH; e += BM) {
      ks[e] = load_f32(k + off + e);
      vs[e] = load_f32(v + off + e);
    }
    __syncthreads();

    const int key0 = kt * BN;
    float s[BN];
    float tmax = M_FLOOR;
#pragma unroll
    for (int j = 0; j < BN; ++j) {
      float a = 0.f;
#pragma unroll
      for (int d = 0; d < DH; d += 4) {
        const float4 k4 = *reinterpret_cast<const float4*>(ks + j * DH + d);
        a = fmaf(qr[d], k4.x, a);
        a = fmaf(qr[d + 1], k4.y, a);
        a = fmaf(qr[d + 2], k4.z, a);
        a = fmaf(qr[d + 3], k4.w, a);
      }
      const int col = key0 + j;
      const bool ok = col < kv && (!causal || col <= row);
      s[j] = ok ? a : NEG_INF;
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
  lse[(long long)cell * Mp + row] = (m_run + log2f(safe_l)) * LN2;

  // output tile: one row per thread into shared memory, coalesced store
  __syncthreads();
#pragma unroll
  for (int d = 0; d < DH; ++d) smem[tid * DH + d] = acc[d] / safe_l;
  __syncthreads();
  T* ot = out + base + (long long)row0 * DH;
  for (int e = tid; e < BM * DH; e += BM) store_f32(ot + e, smem[e]);
}

template <typename T, int DH, int BN>
int launch(const void* q, const void* k, const void* v, const int* kvlen,
           void* out, float* lse, int n_cells, int HB, int Mp, int causal,
           float qscale, cudaStream_t stream) {
  const unsigned blocks = (unsigned)n_cells * (unsigned)(Mp / BM);
  dilated_branch_fwd_kernel<T, DH, BN><<<blocks, BM, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kvlen, static_cast<T*>(out), lse, HB, Mp,
      causal, qscale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the tensor-core kernel (bf16 tensors)
// ---------------------------------------------------------------------------

template <int DH>
__global__ void __launch_bounds__(128, DH < 64 ? 4 : DH == 64 ? 3 : 2)
    dilated_branch_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                                  const __nv_bfloat16* __restrict__ v, const int* __restrict__ kvlen,
                                  __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int HB, int Mp,
                                  int causal, float qscale) {
  using F = BranchFwdMma<DH>;
  using Tile = typename F::Tile;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* qs = smem;                  // Q tile, then the output tile
  unsigned char* ring = smem + Tile::BYTES;  // stage s: K, then V

  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) >> 2;
  const int n_qtiles = Mp / 64;
  const int cell = blockIdx.x / n_qtiles;  // ((b*S + s)*r + p)*hb + t
  const int row0 = (blockIdx.x - cell * n_qtiles) * 64;
  const long long base = (long long)cell * Mp * DH;
  const __nv_bfloat16* kc = k + base;
  const __nv_bfloat16* vc = v + base;
  int kv = min(kvlen[cell / HB], Mp);
  if (causal && kv > row0 + 64) kv = row0 + 64;
  const int n_tiles = (kv + 63) / 64;

  Tile::load(qs, q + base + (long long)row0 * DH, 64);
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
  F::finish(acc, m, l, qs, out + base + (long long)row0 * DH, lse + (long long)cell * Mp + row0);
}

template <int DH>
int launch_mma(const void* q, const void* k, const void* v, const int* kvlen, void* out, float* lse,
               int n_cells, int HB, int Mp, int causal, float qscale, cudaStream_t stream) {
  if constexpr (DH % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  } else {
    constexpr int SMEM = 5 * MmaTile<DH>::BYTES;  // Q, two stages of K and V
    const cudaError_t err = cudaFuncSetAttribute(dilated_branch_fwd_mma_kernel<DH>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return (int)err;
    const unsigned blocks = (unsigned)n_cells * (unsigned)(Mp / 64);
    dilated_branch_fwd_mma_kernel<DH><<<blocks, 128, SMEM, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), kvlen, static_cast<__nv_bfloat16*>(out), lse, HB, Mp, causal,
        qscale);
    return (int)cudaGetLastError();
  }
}

}  // namespace

// is_bf16: 0 = fp32 tensors, 1 = bf16 tensors. n_cells = B*S*r*hb, Mp a
// positive multiple of 64, n_cells * Mp/64 blocks below 2^31, Dh ==
// GP_HEAD_DIM; qscale = Dh^-0.5 * log2(e). bf16 tensors take the
// tensor-core kernel, which needs a head width that is a multiple of 8 and
// q, k, v and out 16-byte aligned; fp32 tensors the FMA kernel, whose key
// tiles are 64 rows, or 32 above a head width of 64 to keep the K/V tiles
// and registers in bounds.
extern "C" int gp_dilated_branch_fwd(const void* q, const void* k,
                                     const void* v, const int* kvlen,
                                     void* out, float* lse, int is_bf16,
                                     int n_cells, int HB, int Mp, int Dh,
                                     int causal, float qscale, void* stream) {
  constexpr int BN = GP_HEAD_DIM > 64 ? 32 : 64;
  if (Dh != GP_HEAD_DIM || Mp <= 0 || Mp % BM != 0 || n_cells <= 0 ||
      (long long)n_cells * (Mp / BM) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (!gp::aligned16({q, k, v, out})) return (int)cudaErrorMisalignedAddress;
    return launch_mma<GP_HEAD_DIM>(q, k, v, kvlen, out, lse, n_cells, HB, Mp, causal, qscale, st);
  }
  return launch<float, GP_HEAD_DIM, BN>(q, k, v, kvlen, out, lse, n_cells, HB,
                                        Mp, causal, qscale, st);
}
