// Forward attention of one dilated branch on the phase-major packed layout,
// pipelined: the next key tile's loads overlap the current tile's math.
//
// Replaces the Pallas kernel
// gigapath_tpu/ops/pallas_dilated.py:_fwd_kernel_pipe (called by
// _fwd_impl_pipe). The contract is csrc/dilated_branch_fwd.cu's, non-causal
// only: q, k, v packed [B, S, r, hb, Mp, Dh] (fp32 or bf16), kvlen int32
// [B, S, r]; out in the packed layout and input dtype, lse fp32
// [B, S, r, hb, Mp].
//
// Numerics follow the pipelined Pallas kernel, which differs from the serial
// one in bf16: q*scale*log2(e) is rounded to the input dtype before QK^T,
// and the probabilities are rounded to it before PV (products summed in
// fp32; the softmax denominator sums the unrounded probabilities). The
// online softmax is fp32 in base 2, its running max floored at -1e20, masked
// keys set to -1e30 by select before the max, lse = (m + log2(max(l,
// 1e-30))) * ln2, and a row with no valid key gives out 0 and lse ~
// -6.9e19. In fp32 every rounding is a no-op and the kernel computes the
// serial kernel's function up to the order of the sums.
//
// Pipelining. A TPU grid runs its steps in order, so the Pallas kernel
// flattens (head, key block) into one grid axis and overlaps the logits of
// step n with the softmax of step n-1 by hand. That grid is a TPU
// scheduling device and is not carried over: the heads of a band are
// independent blocks here. A block owns one (cell, 64-row query tile), as
// the serial kernel, and streams the cell's key tiles through a two-stage
// shared-memory ring filled with cp.async (pipe_common.cuh): while tile j's
// QK^T, softmax and PV run, tile j+1's K and V are already in flight.
// Staging stops at the first tile past kvlen.
//
// Key-stage width BN = 64 keys (32 above a head width of 64). Dynamic
// shared memory: the ring, 2 stages x (K, V) x BN x Dh elements, and for
// bf16 the fp32 work tiles of K and V; 48 KiB at the flagship's Dh = 48 in
// both dtypes (fp32 2*2*64*48*4 B; bf16 2*2*64*48*2 + 2*64*48*4 B).
//
// Bound on the H100: operations, 4*m*kvlen*Dh per cell (QK^T and PV), as
// the serial kernel; this version runs them on the fp32 FMA pipes (one
// thread per query row, q, the accumulator and a BN-key score strip in
// registers). Later work: a warp-specialised producer/consumer kernel, TMA
// loads into an mbarrier-tracked ring and wgmma on the bf16 tiles.

#include <cstdint>

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
  cudaError_t err = cudaFuncSetAttribute(dilated_branch_fwd_pipe_kernel<T, DH, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         bytes);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)n_cells * (unsigned)(Mp / BM);
  dilated_branch_fwd_pipe_kernel<T, DH, BN><<<blocks, BM, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), kvlen,
      static_cast<T*>(out), lse, HB, Mp, qscale);
  return (int)cudaGetLastError();
}

}  // namespace

// is_bf16: 0 = fp32 tensors, 1 = bf16 tensors. n_cells = B*S*r*hb, Mp a
// positive multiple of 64, n_cells * Mp/64 blocks below 2^31, Dh ==
// GP_HEAD_DIM, q/k/v 16-byte aligned (the ring's cp.async copies);
// qscale = Dh^-0.5 * log2(e).
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
  if (is_bf16)
    return launch<__nv_bfloat16, GP_HEAD_DIM, BN>(q, k, v, kvlen, out, lse, n_cells, HB, Mp,
                                                  qscale, st);
  return launch<float, GP_HEAD_DIM, BN>(q, k, v, kvlen, out, lse, n_cells, HB, Mp, qscale, st);
}
