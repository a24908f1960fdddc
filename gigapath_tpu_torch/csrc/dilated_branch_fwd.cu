// Forward attention of one dilated branch on the phase-major packed layout.
//
// Replaces the Pallas kernel gigapath_tpu/ops/pallas_dilated.py:_fwd_kernel
// (called by _fwd_impl). Inputs q, k, v are packed [B, S, r, hb, Mp, Dh]
// (fp32 or bf16); kvlen is int32 [B, S, r]. Cell (b, s, p, t) is one head of
// band p attending the phase-p tokens of segment s: query row i attends key
// rows j < kvlen[b, s, p] (and j <= i when causal). Outputs: out in the
// packed layout and input dtype, lse as fp32 [B, S, r, hb, Mp] (the TPU
// kernel's 128-lane lse slab is a TPU layout and is not copied).
//
// Numerics follow the Pallas kernel: fp32 scores and online softmax in base
// 2 (log2(e) folded into the q scale), the running max floored at -1e20 so
// masked keys (-1e30, applied by select before the max) underflow to an
// exact 0, and a row with no valid key gives out = 0 and lse ~ -6.9e19. All
// arithmetic is fp32 for both input dtypes (bf16 is widened on load), so the
// bf16 path keeps q*scale and the probabilities unrounded where the TPU
// kernel rounded them to bf16.
//
// Bound on the H100: operations, 4*m*kvlen*Dh per cell (QK^T and PV), next
// to about 4*m*Dh elements moved. This first version runs on the fp32 FMA
// pipes, so its ceiling is the 67 TFLOP/s fp32 rate, not the 989 TFLOP/s
// bf16 tensor-core rate the bound is stated against for bf16; tensor cores
// (mma.sync / wgmma) are later work. What the design does about the bound:
// one thread per query row (a 64-row query tile per block) keeps q, the
// output accumulator and a 64-key score strip in registers; each 64-key
// K/V tile is staged once in shared memory as fp32 and read by all 64 rows
// with broadcast float4 loads, so every shared-memory load feeds four FMAs;
// key tiles past kvlen (or past the tile's last row when causal) are never
// loaded or computed.

#include <cstdint>

#include "branch_common.cuh"

// The head width is a compile-time constant (q, the accumulator and the
// score strip live in registers): the build compiles one library per head
// width a model uses, with -DGP_HEAD_DIM=<Dh>.
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

  // One flat grid, the query tiles of a cell adjacent, so they run close
  // together and share the cell's K/V in L2; a flat grid also puts no
  // 65535 cap (gridDim.y's) on the number of cells.
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

}  // namespace

// is_bf16: 0 = fp32 tensors, 1 = bf16 tensors. n_cells = B*S*r*hb, Mp a
// positive multiple of 64, n_cells * Mp/64 blocks below 2^31, Dh ==
// GP_HEAD_DIM. Key tiles are 64 rows, or 32 above a head width of 64 to keep
// the K/V tiles and registers in bounds.
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
  if (is_bf16)
    return launch<__nv_bfloat16, GP_HEAD_DIM, BN>(q, k, v, kvlen, out, lse, n_cells,
                                                  HB, Mp, causal, qscale, st);
  return launch<float, GP_HEAD_DIM, BN>(q, k, v, kvlen, out, lse, n_cells, HB,
                                        Mp, causal, qscale, st);
}
