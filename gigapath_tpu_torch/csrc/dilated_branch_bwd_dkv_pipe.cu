// dK and dV of one dilated branch on the phase-major packed layout,
// pipelined: the next query tile's loads overlap the current tile's math.
//
// Replaces the Pallas kernel gigapath_tpu/ops/pallas_dilated.py:_dkv_kernel_pipe
// (called by _bwd_impl_pipe). Inputs as csrc/dilated_branch_bwd_dq_pipe.cu
// (non-causal only); outputs dk, dv in the packed layout and input dtype.
//
// Numerics follow the pipelined Pallas kernel, for key row j < kvlen and
// every query row i:
//   s_ij  = round(q_i * scale*log2(e)) . k_j          (fp32 sum)
//   p_ij  = exp2(s_ij - lse_i*log2(e))
//   ds_ij = p_ij * (dout_i . v_j - delta_i)
//   dv_j  = sum_i p_ij dout_i                          (fp32, p unrounded)
//   dk_j  = scale * sum_i ds_ij q_i                    (fp32, q unscaled)
// where round() is the rounding to the input dtype (a no-op in fp32). A key
// tile at or past kvlen is written as zeros and its work skipped; inside the
// partial tile the keys past kvlen get p = 0 by select, so their rows are
// exactly 0. Padded query rows (zero q and dout, delta 0) add exactly 0.
//
// Pipelining: one block per (cell, 64-row key tile), as the serial kernel;
// it streams every query tile of the cell through a two-stage cp.async ring
// (pipe_common.cuh) holding the tile's q and dout rows and its lse and delta
// values, tile i+1 in flight while tile i's math runs. After a stage lands,
// q*scale*log2(e) is rounded into an fp32 work tile (and, for bf16, q and
// dout are widened into fp32 work tiles).
//
// Query-stage width BQ = 64 rows (32 above a head width of 64). Dynamic
// shared memory: 2 stages x (q, dout rows in the input dtype + lse, delta in
// fp32), the rounded q work tile and lse*log2(e) in fp32, and for bf16 the
// fp32 q and dout work tiles: 61.25 KiB at Dh = 48 in both dtypes (fp32
// 2*(2*64*48*4 + 2*64*4) + 64*48*4 + 64*4 B; bf16 2*(2*64*48*2 + 2*64*4) +
// 3*64*48*4 + 64*4 B).
//
// Bound on the H100: operations, 8*Dh per valid (query, key) pair (q.k,
// dout.v, p*dout, ds*q); fp32 FMA pipes here, one thread per key row with k,
// v and the dk/dv accumulators in registers (4*Dh values: 242 registers and
// no spill at Dh = 48, where the serial kernel, which stages each tile with
// plain loads, spills; at Dh = 96 both spill). Later work: warp-specialised
// TMA + mbarrier + wgmma.

#include <cstdint>

#include "pipe_common.cuh"

#ifndef GP_HEAD_DIM
#error "compile with -DGP_HEAD_DIM=<head width>"
#endif
static_assert(GP_HEAD_DIM % 4 == 0 && GP_HEAD_DIM <= 128, "head width: a multiple of 4, at most 128");

namespace {

using namespace gp;

// The ring over a cell's query tiles: per stage the q and dout rows (T) and
// the lse and delta values (fp32); then the fp32 work tiles.
template <typename T, int DH, int BQ>
struct QRing {
  static constexpr int TILE = BQ * DH;  // elements of one q or dout tile
  static constexpr int TILE_BYTES = TILE * (int)sizeof(T);
  static constexpr int VEC_BYTES = BQ * 4;  // one tile's lse or delta
  static constexpr int STAGE = 2 * TILE_BYTES + 2 * VEC_BYTES;
  static constexpr bool WIDEN = !std::is_same<T, float>::value;
  static constexpr int WORK = 2 * STAGE;  // byte offset of the work tiles
  static constexpr int BYTES = WORK + TILE * 4 + VEC_BYTES + (WIDEN ? 2 * TILE * 4 : 0);
  // a cell's rows start at a multiple of Mp*DH elements and its lse at a
  // multiple of Mp floats (Mp a multiple of BM), a query tile at a multiple
  // of TILE / BQ: all 16-byte aligned from the tensors' bases
  static_assert((BM * DH * sizeof(T)) % 16 == 0 && TILE_BYTES % 16 == 0 && VEC_BYTES % 16 == 0,
                "16-byte aligned tiles");
  static_assert(BYTES >= BM * DH * 4, "the key rows are staged in the ring's memory");
};

template <typename T, int DH, int BQ>
__device__ __forceinline__ void issue_q_tile(unsigned char* smem, int stage, const T* q,
                                             const T* dout, const float* lse,
                                             const float* delta) {
  using Ring = QRing<T, DH, BQ>;
  unsigned char* st = smem + stage * Ring::STAGE;
  cp_async_tile<Ring::TILE_BYTES>(st, q);
  cp_async_tile<Ring::TILE_BYTES>(st + Ring::TILE_BYTES, dout);
  cp_async_tile<Ring::VEC_BYTES>(st + 2 * Ring::TILE_BYTES, lse);
  cp_async_tile<Ring::VEC_BYTES>(st + 2 * Ring::TILE_BYTES + Ring::VEC_BYTES, delta);
}

template <typename T, int DH, int BQ>
__global__ void __launch_bounds__(BM)
    dilated_branch_bwd_dkv_pipe_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                       const T* __restrict__ v,
                                       const T* __restrict__ dout,
                                       const float* __restrict__ lse,
                                       const float* __restrict__ delta,
                                       const int* __restrict__ kvlen,
                                       T* __restrict__ dk, T* __restrict__ dv, int HB,
                                       int Mp, float qscale, float scale) {
  using Ring = QRing<T, DH, BQ>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* smem_f = reinterpret_cast<float*>(smem);
  float* qh_w = reinterpret_cast<float*>(smem + Ring::WORK);  // round(q * qscale)
  float* ls_w = qh_w + Ring::TILE;                            // lse * log2(e)
  float* q_w = ls_w + BQ;                                     // bf16 only: q, dout
  float* do_w = q_w + Ring::TILE;

  const int tid = threadIdx.x;
  const int n_ktiles = Mp / BM;
  const int cell = blockIdx.x / n_ktiles;  // ((b*S + s)*r + p)*hb + t
  const int key0 = (blockIdx.x - cell * n_ktiles) * BM;
  const int key = key0 + tid;
  const long long base = (long long)cell * Mp * DH;
  const long long tile = base + (long long)key0 * DH;

  int kv = kvlen[cell / HB];
  kv = kv < Mp ? kv : Mp;
  if (key0 >= kv) {  // no valid key in this tile: exact zeros, no work
    for (int e = tid; e < BM * DH; e += BM) {
      store_f32(dk + tile + e, 0.f);
      store_f32(dv + tile + e, 0.f);
    }
    return;
  }
  const bool key_ok = key < kv;

  float kr[DH], vr[DH], dk_acc[DH], dv_acc[DH];
  load_row<T, DH>(k + tile, smem_f, kr, 1.f);
  load_row<T, DH>(v + tile, smem_f, vr, 1.f);
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    dk_acc[d] = 0.f;
    dv_acc[d] = 0.f;
  }

  const long long lbase = (long long)cell * Mp;
  const int n_tiles = Mp / BQ;
  __syncthreads();  // the key staging is consumed before the ring overwrites it
  issue_q_tile<T, DH, BQ>(smem, 0, q + base, dout + base, lse + lbase, delta + lbase);
  cp_async_commit();
  for (int it = 0; it < n_tiles; ++it) {
    __syncthreads();  // every thread is done with tile it - 1: its stage may refill
    if (it + 1 < n_tiles) {
      const long long off = (long long)(it + 1) * BQ;
      issue_q_tile<T, DH, BQ>(smem, (it + 1) & 1, q + base + off * DH, dout + base + off * DH,
                              lse + lbase + off, delta + lbase + off);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of tile it have landed
    __syncthreads();     // and every thread's

    const unsigned char* st = smem + (it & 1) * Ring::STAGE;
    const T* q_st = reinterpret_cast<const T*>(st);
    const T* do_st = reinterpret_cast<const T*>(st + Ring::TILE_BYTES);
    const float* lse_st = reinterpret_cast<const float*>(st + 2 * Ring::TILE_BYTES);
    const float* dls = lse_st + BQ;  // delta, read in place
    widen_tile<T, Ring::TILE, true>(q_st, qh_w, qscale);
    if (tid < BQ) ls_w[tid] = lse_st[tid] * LOG2E;
    const float* qs;
    const float* dos;
    if constexpr (Ring::WIDEN) {
      widen_tile<T, Ring::TILE, false>(q_st, q_w, 1.f);
      widen_tile<T, Ring::TILE, false>(do_st, do_w, 1.f);
      qs = q_w;
      dos = do_w;
    } else {
      qs = reinterpret_cast<const float*>(q_st);
      dos = reinterpret_cast<const float*>(do_st);
    }
    __syncthreads();

    // not unrolled: the 4*Dh accumulator registers leave no room to hold
    // a second query row's operands (as the serial kernel)
#pragma unroll 1
    for (int i = 0; i < BQ; ++i) {
      const float* doi = dos + i * DH;
      const float s = dot_smem<DH>(kr, qh_w + i * DH);
      const float dp = dot_smem<DH>(vr, doi);
      const float p = key_ok ? exp2f(s - ls_w[i]) : 0.f;
      const float ds = p * (dp - dls[i]);
      axpy_smem<DH>(p, doi, dv_acc);
      axpy_smem<DH>(ds, qs + i * DH, dk_acc);
    }
  }
  cp_async_wait<0>();

  store_row<T, DH>(dk_acc, scale, smem_f, dk + tile);
  store_row<T, DH>(dv_acc, 1.f, smem_f, dv + tile);
}

template <typename T, int DH, int BQ>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, const int* kvlen, void* dk,
           void* dv, int n_cells, int HB, int Mp, float qscale, float scale,
           cudaStream_t stream) {
  constexpr int bytes = QRing<T, DH, BQ>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(dilated_branch_bwd_dkv_pipe_kernel<T, DH, BQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         bytes);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)n_cells * (unsigned)(Mp / BM);
  dilated_branch_bwd_dkv_pipe_kernel<T, DH, BQ><<<blocks, BM, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, kvlen, static_cast<T*>(dk), static_cast<T*>(dv),
      HB, Mp, qscale, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// is_bf16: 0 = fp32 tensors, 1 = bf16 tensors. n_cells = B*S*r*hb, Mp a
// positive multiple of 64, n_cells * Mp/64 blocks below 2^31, Dh ==
// GP_HEAD_DIM, q/dout/lse/delta 16-byte aligned (the ring's cp.async
// copies); qscale = Dh^-0.5 * log2(e), scale = Dh^-0.5.
extern "C" int gp_dilated_branch_bwd_dkv_pipe(const void* q, const void* k,
                                              const void* v, const void* dout,
                                              const float* lse, const float* delta,
                                              const int* kvlen, void* dk, void* dv,
                                              int is_bf16, int n_cells, int HB, int Mp,
                                              int Dh, float qscale, float scale,
                                              void* stream) {
  constexpr int BQ = GP_HEAD_DIM > 64 ? 32 : 64;
  if (Dh != GP_HEAD_DIM || Mp <= 0 || Mp % BM != 0 || n_cells <= 0 ||
      (long long)n_cells * (Mp / BM) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (!gp::aligned16({q, dout, lse, delta})) return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16, GP_HEAD_DIM, BQ>(q, k, v, dout, lse, delta, kvlen, dk, dv,
                                                  n_cells, HB, Mp, qscale, scale, st);
  return launch<float, GP_HEAD_DIM, BQ>(q, k, v, dout, lse, delta, kvlen, dk, dv, n_cells, HB,
                                        Mp, qscale, scale, st);
}
