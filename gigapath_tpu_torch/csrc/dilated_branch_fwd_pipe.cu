// Forward attention of one dilated branch on the phase-major packed layout,
// pipelined: the next key tile's work overlaps the current tile's.
//
// Replaces the Pallas kernel
// gigapath_tpu/ops/pallas_dilated.py:_fwd_kernel_pipe (called by
// _fwd_impl_pipe; PERF.md row 6). The contract is csrc/dilated_branch_fwd.cu's,
// non-causal only: q, k, v packed [B, S, r, hb, Mp, Dh] (fp32 or bf16),
// kvlen int32 [B, S, r]; out in the packed layout and input dtype, lse fp32
// [B, S, r, hb, Mp].
//
// Numerics: those of the serial kernel, whose function this is. In bf16 the
// pipelined and the serial Pallas kernels both round q*scale*log2(e) to the
// input dtype before QK^T and the probabilities before PV (products summed
// in fp32; the softmax denominator sums the unrounded probabilities). The
// online softmax is fp32 in base 2, its running max floored at -1e20,
// masked keys set to -1e30 by select before the max, lse = (m +
// log2(max(l, 1e-30))) * ln2, and a row with no valid key gives out 0 and
// lse ~ -6.9e19. In fp32 every rounding is a no-op.
//
// Pipelining. A TPU grid runs its steps in order, so the Pallas kernel
// flattens (head, key block) into one grid axis and computes step n's
// logits on the MXU while step n-1's softmax runs on the VPU. That grid is
// a TPU scheduling device and is not carried over: the heads of a band are
// independent blocks here. A block owns one (cell, 64-row query tile), as
// the serial kernel, and loops over the cell's key tiles; staging stops at
// the first tile past kvlen. The idea is carried over inside that loop.
//
// Bound on the H100: operations, 4*m*kvlen*Dh per cell (QK^T and PV), as
// the serial kernel, and one exp2 per admitted pair on the MUFU pipes (16 a
// clock per SM), more time than the bf16 tensor cores' bound at Dh = 48; so
// the tensor cores and MUFU have to overlap.
//
// Two kernels, chosen by the tensors' dtype:
// - bf16 tensors (head widths that are multiples of 8): the tensor cores,
//   through the serial kernel's tile steps (branch_mma.cuh), 4 warps of 16
//   query rows. Each step j first issues S_{j+1} = Q.K_{j+1}^T on the
//   tensor cores into a second set of score fragments, then runs tile j's
//   softmax (MUFU and FMA) and P.V: the warp issues the exponentials while
//   the HMMA pipe works on the next tile's scores, inside one warp and not
//   only across warps. K and V tiles stream through a three-stage cp.async
//   ring, tile j+2 issued while tile j computes, with one barrier a tile
//   (the stage refilled at step j held tile j-1, which every warp finished
//   before that barrier). Registers are capped for 3 blocks an SM below
//   Dh = 64 (two score sets of 32 registers each; 168 at the flagship's
//   48), 2 from 64.
// - fp32 tensors: the fp32 FMA pipes, one thread per query row (q, the
//   accumulator and a BN-key score strip in registers), K/V tiles in a
//   two-stage cp.async ring (pipe_common.cuh) while tile j computes, tile
//   j+1's copies are in flight. Key-stage width BN = 64 keys (32 above a
//   head width of 64); dynamic shared memory 2 stages x (K, V) x BN x Dh
//   floats, 48 KiB at the flagship's Dh = 48.

#include <cstdint>

#include "branch_mma.cuh"
#include "pipe_common.cuh"

// The head width is a compile-time constant: one library per head width,
// -DGP_HEAD_DIM=<Dh>.
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
    dilated_branch_fwd_pipe_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                   const T* __restrict__ v,
                                   const int* __restrict__ kvlen,
                                   T* __restrict__ out, float* __restrict__ lse,
                                   int HB, int Mp, float qscale) {
  using Ring = KVRing<T, DH, BN>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* smem_f = reinterpret_cast<float*>(smem);

  // one flat grid, the query tiles of a cell adjacent (as the serial kernel)
  const int tid = threadIdx.x;
  const int n_qtiles = Mp / BM;
  const int cell = blockIdx.x / n_qtiles;  // ((b*S + s)*r + p)*hb + t
  const int row0 = (blockIdx.x - cell * n_qtiles) * BM;
  const int row = row0 + tid;
  const long long base = (long long)cell * Mp * DH;

  int kv = kvlen[cell / HB];
  kv = kv < Mp ? kv : Mp;

  // q * scale*log2(e), rounded to the input dtype
  float qr[DH];
  load_row<T, DH>(q + base + (long long)row0 * DH, smem_f, qr, qscale);
#pragma unroll
  for (int d = 0; d < DH; ++d) qr[d] = round_to<T>(qr[d]);

  float acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;
  float m_run = M_FLOOR;
  float l_run = 0.f;

  const int n_tiles = (kv + BN - 1) / BN;
  __syncthreads();  // the q staging is consumed before the ring overwrites it
  if (n_tiles > 0) Ring::issue(smem, 0, k + base, v + base);
  cp_async_commit();
  for (int kt = 0; kt < n_tiles; ++kt) {
    __syncthreads();  // every thread is done with tile kt - 1: its stage may refill
    if (kt + 1 < n_tiles) {
      const long long off = base + (long long)(kt + 1) * Ring::TILE;
      Ring::issue(smem, (kt + 1) & 1, k + off, v + off);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of tile kt have landed
    __syncthreads();     // and every thread's
    const float* ks = Ring::land(smem, kt & 1);
    const float* vs = ks + Ring::TILE;

    const int key0 = kt * BN;
    float s[BN];
    float tmax = M_FLOOR;
#pragma unroll
    for (int j = 0; j < BN; ++j) {
      const float a = dot_smem<DH>(qr, ks + j * DH);
      s[j] = key0 + j < kv ? a : NEG_INF;
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
  cp_async_wait<0>();

  const float safe_l = fmaxf(l_run, 1e-30f);
  lse[(long long)cell * Mp + row] = (m_run + log2f(safe_l)) * LN2;
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = acc[d] / safe_l;
  store_row<T, DH>(acc, 1.f, smem_f, out + base + (long long)row0 * DH);
}

template <typename T, int DH, int BN>
int launch(const void* q, const void* k, const void* v, const int* kvlen,
           void* out, float* lse, int n_cells, int HB, int Mp, float qscale,
           cudaStream_t stream) {
  constexpr int bytes = KVRing<T, DH, BN>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(dilated_branch_fwd_pipe_kernel<T, DH, BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)n_cells * (unsigned)(Mp / BM);
  dilated_branch_fwd_pipe_kernel<T, DH, BN><<<blocks, BM, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), kvlen,
      static_cast<T*>(out), lse, HB, Mp, qscale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the tensor-core kernel (bf16 tensors)
// ---------------------------------------------------------------------------

constexpr int RING = 3;  // stages of the K/V ring

template <int DH>
struct PipeStep {
  using F = BranchFwdMma<DH>;
  using Tile = typename F::Tile;
  static constexpr int STAGE = 2 * Tile::BYTES;  // K, then V

  // Step j of the key loop: tile j's scores are in cur; leaves tile j+1's
  // in nxt. Waits for tile j+1's copies (issued one step earlier), refills
  // the stage of tile j-1 with tile j+2, issues S_{j+1} before tile j's
  // softmax and P.V.
  __device__ __forceinline__ static void run(int j, float (&cur)[F::NT][4], float (&nxt)[F::NT][4],
                                             const uint32_t (&qa)[F::KS][4], float (&m)[2], float (&l)[2],
                                             float (&acc)[F::DT][4], unsigned char* ring, const __nv_bfloat16* kc,
                                             const __nv_bfloat16* vc, int kv, int n_tiles, const int (&row)[2]) {
    cp_async_wait<0>();
    __syncthreads();  // tile j+1 landed; every warp is done with tile j-1's stage
    if (j + 2 < n_tiles) {
      unsigned char* st = ring + ((j + 2) % RING) * STAGE;
      const int rows = kv - (j + 2) * 64;
      Tile::load(st, kc + (long long)(j + 2) * 64 * DH, rows);
      Tile::load(st + Tile::BYTES, vc + (long long)(j + 2) * 64 * DH, rows);
    }
    cp_async_commit();
    if (j + 1 < n_tiles) F::scores(nxt, qa, ring + ((j + 1) % RING) * STAGE);
    uint32_t pa[F::NT][2];
    F::softmax(cur, m, l, acc, pa, (j + 1) * 64 > kv, j * 64, kv, false, row);
    F::pv(acc, pa, ring + (j % RING) * STAGE + Tile::BYTES);
  }
};

template <int DH>
__global__ void __launch_bounds__(128, DH < 64 ? 3 : 2)
    dilated_branch_fwd_pipe_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                                       const __nv_bfloat16* __restrict__ v, const int* __restrict__ kvlen,
                                       __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int HB, int Mp,
                                       float qscale) {
  using P = PipeStep<DH>;
  using F = typename P::F;
  using Tile = typename P::Tile;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* qs = smem;                  // Q tile, then the output tile
  unsigned char* ring = smem + Tile::BYTES;  // RING stages of (K, V)

  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) >> 2;
  const int n_qtiles = Mp / 64;
  const int cell = blockIdx.x / n_qtiles;  // ((b*S + s)*r + p)*hb + t
  const int row0 = (blockIdx.x - cell * n_qtiles) * 64;
  const long long base = (long long)cell * Mp * DH;
  const __nv_bfloat16* kc = k + base;
  const __nv_bfloat16* vc = v + base;
  const int kv = min(kvlen[cell / HB], Mp);
  const int n_tiles = (kv + 63) / 64;

  // prologue: Q and tile 0 in one commit group, tile 1 in the next
  Tile::load(qs, q + base + (long long)row0 * DH, 64);
  for (int j = 0; j < 2; ++j) {
    if (j < n_tiles) {
      Tile::load(ring + j * P::STAGE, kc + (long long)j * 64 * DH, kv - j * 64);
      Tile::load(ring + j * P::STAGE + Tile::BYTES, vc + (long long)j * 64 * DH, kv - j * 64);
    }
    cp_async_commit();
  }

  const int row[2] = {row0 + 16 * warp + g, row0 + 16 * warp + g + 8};
  float acc[F::DT][4];
#pragma unroll
  for (int t = 0; t < F::DT; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
  float m[2] = {F::M_FLOOR, F::M_FLOOR}, l[2] = {0.f, 0.f};

  if (n_tiles > 0) {
    cp_async_wait<1>();
    __syncthreads();
    uint32_t qa[F::KS][4];
    F::load_q(qa, qs, qscale);
    float s0[F::NT][4], s1[F::NT][4];
    F::scores(s0, qa, ring);
    // two steps an iteration, so the score sets swap roles without copies
    for (int j = 0; j < n_tiles; j += 2) {
      P::run(j, s0, s1, qa, m, l, acc, ring, kc, vc, kv, n_tiles, row);
      if (j + 1 >= n_tiles) break;
      P::run(j + 1, s1, s0, qa, m, l, acc, ring, kc, vc, kv, n_tiles, row);
    }
  }

  cp_async_wait<0>();  // no copy may land in the Q tile once it holds the output
  __syncthreads();
  F::finish(acc, m, l, qs, out + base + (long long)row0 * DH, lse + (long long)cell * Mp + row0);
}

template <int DH>
int launch_mma(const void* q, const void* k, const void* v, const int* kvlen, void* out, float* lse,
               int n_cells, int HB, int Mp, float qscale, cudaStream_t stream) {
  if constexpr (DH % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  } else {
    constexpr int SMEM = (1 + 2 * RING) * MmaTile<DH>::BYTES;  // Q, RING stages of K and V
    const cudaError_t err = cudaFuncSetAttribute(dilated_branch_fwd_pipe_mma_kernel<DH>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return (int)err;
    const unsigned blocks = (unsigned)n_cells * (unsigned)(Mp / 64);
    dilated_branch_fwd_pipe_mma_kernel<DH><<<blocks, 128, SMEM, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), kvlen, static_cast<__nv_bfloat16*>(out), lse, HB, Mp, qscale);
    return (int)cudaGetLastError();
  }
}

}  // namespace

// is_bf16: 0 = fp32 tensors, 1 = bf16 tensors. n_cells = B*S*r*hb, Mp a
// positive multiple of 64, n_cells * Mp/64 blocks below 2^31, Dh ==
// GP_HEAD_DIM, q/k/v (and, bf16, out) 16-byte aligned (the rings' cp.async
// copies and the output's 16-byte stores); qscale = Dh^-0.5 * log2(e).
// bf16 tensors take the tensor-core kernel, which needs a head width that
// is a multiple of 8; fp32 tensors the FMA kernel.
extern "C" int gp_dilated_branch_fwd_pipe(const void* q, const void* k,
                                          const void* v, const int* kvlen,
                                          void* out, float* lse, int is_bf16,
                                          int n_cells, int HB, int Mp, int Dh,
                                          float qscale, void* stream) {
  constexpr int BN = GP_HEAD_DIM > 64 ? 32 : 64;
  if (Dh != GP_HEAD_DIM || Mp <= 0 || Mp % BM != 0 || n_cells <= 0 ||
      (long long)n_cells * (Mp / BM) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (!gp::aligned16({q, k, v})) return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (!gp::aligned16({out})) return (int)cudaErrorMisalignedAddress;
    return launch_mma<GP_HEAD_DIM>(q, k, v, kvlen, out, lse, n_cells, HB, Mp, qscale, st);
  }
  return launch<float, GP_HEAD_DIM, BN>(q, k, v, kvlen, out, lse, n_cells, HB, Mp, qscale, st);
}
