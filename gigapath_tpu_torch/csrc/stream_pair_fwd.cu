// Forward of one streaming chunk pair: one dilated branch's attention of a
// query block against one resident key block, returning the pair's
// chunk-normalized output and its log-sum-exp.
//
// Replaces the Pallas kernel gigapath_tpu/ops/pallas_streaming.py:_fwd_kernel
// (called by _fwd_impl; PERF.md row 15). Inputs q [B, cq, H, Dh], k and v
// [B, ck, H, Dh] (fp32 or bf16, each through its (batch, row, head) strides,
// the head width contiguous) and the int32 geometry of csrc/stream_common.cuh
// (global offsets q0 and k0, segment length, ratio, valid bound, lattices).
// Outputs: out [B, cq, H, Dh] in q's dtype through its strides, lse fp32
// [B, H, cq] (natural log). The TPU kernel's [B, H, c, D] transposes and
// 128-lane lse slab are TPU layouts and are not copied.
//
// Numerics, the Pallas kernel's with this file's key tiles (the plain
// version ops/streaming_kernels.py:stream_pair_fwd_reference): q *
// Dh^-1/2*log2(e) rounded to the input dtype once, fp32 scores, masked
// scores selected to -1e30 before the max, a base-2 online softmax whose
// running max is floored at -1e20 (masked scores underflow to an exact 0)
// and moves per tile of 64 keys of the head's key lattice (lattice keys
// [64n, 64n + 64), the lattice cut at valid; JAX's moves per key block),
// p rounded to the input dtype before P.V while l sums the fp32 p, out =
// acc / max(l, 1e-30) and lse = (m + log2 max(l, 1e-30)) ln 2. A row with no
// visible key gives out = 0 and lse ~ -6.9e19. In bf16 the CPU test
// tests/test_torch_streaming.py::test_pair_fwd_bf16_matches_jax_fwd_impl
// holds the plain version against JAX's _fwd_impl: 99.98 % and 100 % of out
// bit-equal where the tiles match JAX's blocks, 93.7 % with four tiles in
// one block, lse on covered rows within 1.9e-6. In fp32 the roundings are
// no-ops.
//
// Bound on the H100: operations, 4*Dh per (query, key) pair the masks admit
// (QK^T and PV) at the dtype's peak, and one exp2 per admitted pair on the
// MUFU pipes; the bytes are each block read once and out and lse written
// once. What the design does about it: a block owns 64 rows of one head's
// phase lattice (1/r of the block's rows) and loops over the key lattice
// (1/r of the keys) in 64-key tiles, so only 1/r^2 of the dense [cq, ck]
// tile is computed; it visits only the key tiles whose segments can meet
// its rows'. No atomics: every output row is written by one block, so
// results repeat bit for bit. Two kernels, chosen by the tensors' dtype:
// - bf16 tensors: the tensor cores, through the forward tile steps of
//   branch_mma.cuh (BranchFwdMma: rows 1, 6, 11 and 13's) on this pair's
//   cell map, a StreamCell (stream_common.cuh, row 16's). 4 warps hold the
//   64 lattice rows' Q as A fragments (loaded a lattice step apart, times
//   the scale, rounded to bf16); K and V tiles of 64 lattice keys stream
//   through a two-stage cp.async ring, rows a lattice step apart (16-byte
//   pieces: the wrapper and the entry check the alignment), with the keys'
//   segments in an int array beside each stage; S = Q.K^T on
//   mma.sync.m16n8k16; the mask q_seg(row) == k_seg(key) (-2 and -1 for
//   rows and keys off the lattice or past valid, so blocks of step 1 and
//   tiles across a segment boundary come out right) by select on the C
//   fragments; then the tile steps' softmax (no mask of their own) and
//   O += P.V; the epilogue writes O / l to the lattice rows through a
//   padded shared tile as 16-byte stores, and lse at the lattice rows.
//   Rows off the lattice are never written (the wrapper fills them). The
//   epilogue's output offsets wait in shared memory through the key loop:
//   held in registers they cost 8 bytes of spill at Dh = 48 under the
//   forward kernels' 4 blocks an SM (128 registers).
// - fp32 tensors (a tensor-core product in fp32 would be TF32, another
//   function): the fp32 FMA pipes. A block of 64 threads owns 64 lattice
//   rows, one thread per row keeping q, the output accumulator and the
//   tile's scores in registers; each K/V tile (64 keys, 32 above a head
//   width of 64) is staged once in shared memory as fp32 and read with
//   broadcast float4 loads; a key tile whose segments cannot meet the
//   query tile's is skipped whole.

#include <cstdint>

#include "branch_mma.cuh"   // BranchFwdMma
#include "bwd_mma.cuh"      // BwdMma::stream_kv, the K/V ring stage of a StreamCell
#include "pipe_common.cuh"  // cp_async_commit, cp_async_wait, aligned16
#include "stream_common.cuh"

// The head width is a compile-time constant (q, the accumulator and the
// score strip live in registers): one library per head width,
// -DGP_HEAD_DIM=<Dh>.
#ifndef GP_HEAD_DIM
#error "compile with -DGP_HEAD_DIM=<head width>"
#endif
static_assert(GP_HEAD_DIM % 8 == 0 && GP_HEAD_DIM <= 128, "head width: a multiple of 8, at most 128");

namespace {

using namespace gp;

template <typename T, int DH, int BN>
__global__ void __launch_bounds__(BM)
    stream_pair_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           float* __restrict__ lse, PairGeom geo, int n_qtiles,
                           Strides sq, Strides sk, Strides sv, Strides so, float qscale) {
  static_assert(2 * BN >= BM, "the q and out tiles are staged in the K/V buffer");
  __shared__ __align__(16) float smem[2 * BN * DH];
  __shared__ int kseg[BN];
  float* ks = smem;
  float* vs = smem + BN * DH;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x / n_qtiles;  // b * H + h
  const int n0 = (blockIdx.x - bh * n_qtiles) * BM;
  const int b = bh / geo.H, h = bh - b * geo.H;
  const int phase = h / geo.hpg;

  const Lattice ql = lattice(phase, geo.q0, geo.cq, geo.qstep, geo.qshift);
  if (n0 >= ql.count) return;  // this head's lattice has fewer rows
  const int n1 = min(n0 + BM, ql.count);
  const bool on_block = n0 + tid < ql.count;
  const int row = ql.row(n0 + tid);
  const int tseg = row_segment(on_block, geo.q0 + row, phase, geo);

  // q rows: coalesced into shared memory, then one row per thread
  stage_rows<T, DH>(q + b * sq.b + h * sq.h, sq.l, ql, n0, BM, smem, BM);
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
  float m_run = STREAM_M_FLOOR;
  float l_run = 0.f;

  const Lattice kl = key_lattice(phase, geo);
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const int n_ktiles = (kl.count + BN - 1) / BN;
  for (int kt = 0; kt < n_ktiles; ++kt) {
    const int m0 = kt * BN, m1 = min(m0 + BN, kl.count);
    if (!segments_meet(ql, geo.q0, n0, n1, kl, geo.k0, m0, m1, geo.g)) continue;
    __syncthreads();  // the previous tile (or the q staging) is consumed
    stage_rows<T, DH>(kb, sk.l, kl, m0, BN, ks, BM);
    stage_rows<T, DH>(vb, sv.l, kl, m0, BN, vs, BM);
    if (tid < BN) {
      const bool key_on = m0 + tid < kl.count;
      kseg[tid] = key_segment(key_on, geo.k0 + kl.row(m0 + tid), phase, geo);
    }
    __syncthreads();

    float s[BN];
    float tmax = STREAM_M_FLOOR;
#pragma unroll
    for (int j = 0; j < BN; ++j) {
      const float a = dot_smem<DH>(qr, ks + j * DH);
      s[j] = kseg[j] == tseg ? a : STREAM_NEG_INF;
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
    for (int j = 0; j < BN; ++j) axpy_smem<DH>(s[j], vs + j * DH, acc);
    m_run = m_new;
  }

  const float safe_l = fmaxf(l_run, 1e-30f);
  if (on_block) lse[(long long)bh * geo.cq + row] = (m_run + log2f(safe_l)) * LN2;

  // output rows: one per thread into shared memory, coalesced store
  __syncthreads();
#pragma unroll
  for (int d = 0; d < DH; ++d) smem[tid * DH + d] = acc[d] / safe_l;
  __syncthreads();
  store_rows<T, DH>(smem, ql, n0, BM, out + b * so.b + h * so.h, so.l, BM);
}

// The tensor-core kernel (bf16 tensors): one block of 4 warps per 64 rows
// of one (batch, head)'s query lattice.
template <int DH>
__global__ void __launch_bounds__(128, DH < 64 ? 4 : DH == 64 ? 3 : 2)
    stream_pair_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                               const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                               float* __restrict__ lse, PairGeom geo, int n_qtiles, Strides sq, Strides sk,
                               Strides sv, Strides so, float qscale) {
  using F = BranchFwdMma<DH>;
  using Tile = typename F::Tile;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* qs = smem;                                    // Q tile, then the output tile
  unsigned char* ring = smem + Tile::BYTES;                    // stage s: K, then V
  int* kseg = reinterpret_cast<int*>(smem + 5 * Tile::BYTES);  // stage s's key segments at 64 s
  // the epilogue's places, set before the key loop so that nothing it
  // needs stays in registers through the loop: out's and lse's offsets of
  // tile row 0 (elements), then the tile's rows on the lattice
  long long* epi = reinterpret_cast<long long*>(kseg + 128);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, c = lane & 3;
  const int bh = blockIdx.x / n_qtiles;
  const int row0 = (blockIdx.x - bh * n_qtiles) * 64;
  const int b = bh / geo.H, h = bh - b * geo.H;
  const StreamCell fc = stream_cell(geo, h, sq.l, sk.l, sv.l, 0, so.l, 0);
  if (row0 >= fc.nq) return;  // this head's lattice has fewer rows
  const __nv_bfloat16* kb = k + b * sk.b + h * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + h * sv.h;
  int kt0, n_tiles;  // the key tiles [kt0, kt0 + n_tiles) whose segments can meet these rows'
  fc.key_tiles(row0, kt0, n_tiles);

  Tile::load_rows(qs, q + b * sq.b + h * sq.h + fc.ql.row(row0) * sq.l, fc.ql.step * sq.l, fc.nq - row0);
  if (n_tiles > 0) BwdMma<DH>::stream_kv(fc, kb, vb, 64 * kt0, ring, kseg);
  cp_async_commit();
  if (threadIdx.x == 0) {
    epi[0] = b * so.b + h * so.h + fc.ql.row(row0) * so.l;
    epi[1] = (long long)bh * geo.cq + fc.ql.row(row0);
    epi[2] = fc.nq - row0;
  }

  // this thread's rows: g and g + 8 of the warp's 16, and their segments
  const int row[2] = {row0 + 16 * warp + g, row0 + 16 * warp + g + 8};
  const int tseg[2] = {fc.q_seg(row[0]), fc.q_seg(row[1])};
  const int trow[2] = {16 * warp + g, 16 * warp + g + 8};  // the same rows in the tile
  uint32_t qa[F::KS][4];
  float acc[F::DT][4];
#pragma unroll
  for (int t = 0; t < F::DT; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
  float m[2] = {F::M_FLOOR, F::M_FLOOR}, l[2] = {0.f, 0.f};

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int stage = kt & 1;
    if (kt + 1 < n_tiles)
      BwdMma<DH>::stream_kv(fc, kb, vb, 64 * (kt0 + kt + 1), ring + (stage ^ 1) * 2 * Tile::BYTES,
                            kseg + 64 * (stage ^ 1));
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (kt == 0) F::load_q(qa, qs, qscale);
    const unsigned char* ks = ring + stage * 2 * Tile::BYTES;
    float sc[F::NT][4];
    uint32_t pa[F::NT][2];
    F::scores(sc, qa, ks);
    // the segment-equality mask by select, before the tile steps' max
#pragma unroll
    for (int t = 0; t < F::NT; ++t) {
      const int2 useg = *reinterpret_cast<const int2*>(kseg + 64 * stage + 8 * t + 2 * c);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        sc[t][2 * hh] = useg.x == tseg[hh] ? sc[t][2 * hh] : F::NEG_INF;
        sc[t][2 * hh + 1] = useg.y == tseg[hh] ? sc[t][2 * hh + 1] : F::NEG_INF;
      }
    }
    F::softmax(sc, m, l, acc, pa, false, 0, 0, false, row);
    F::pv(acc, pa, ks + Tile::BYTES);
    __syncthreads();  // the stage is consumed before the next loads overwrite it
  }

  cp_async_wait<0>();  // no copy may land in the Q tile once it holds the output
  __syncthreads();
  // the epilogue: O / l of the lattice rows (tile row j at block row
  // ql.row(row0) + qstep * j), lse at their block rows
  const int rows = (int)epi[2];
  float safe[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    safe[hh] = fmaxf(l[hh], 1e-30f);
    if (c == 0 && trow[hh] < rows) lse[epi[1] + geo.qstep * trow[hh]] = (m[hh] + log2f(safe[hh])) * LN2;
  }
#pragma unroll
  for (int t = 0; t < F::DT; ++t) {
    acc[t][0] /= safe[0];
    acc[t][1] /= safe[0];
    acc[t][2] /= safe[1];
    acc[t][3] /= safe[1];
  }
  Tile::put(qs, acc, 1.f);
  __syncthreads();
  Tile::store_rows(out + epi[0], geo.qstep * so.l, qs, rows);
}

template <int DH>
int launch_mma(const void* q, const void* k, const void* v, void* out, float* lse, int B, const PairGeom& geo,
               int n_qtiles, const long long* st, float qscale, cudaStream_t stream) {
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]}, sv{st[6], st[7], st[8]},
      so{st[9], st[10], st[11]};
  // Q, two stages of K and V, their key segments, the epilogue's places
  constexpr int SMEM = 5 * MmaTile<DH>::BYTES + 2 * 64 * 4 + 3 * 8;
  const cudaError_t err =
      cudaFuncSetAttribute(stream_pair_fwd_mma_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)B * (unsigned)geo.H * (unsigned)n_qtiles;
  stream_pair_fwd_mma_kernel<DH><<<blocks, 128, SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), lse, geo, n_qtiles, sq, sk, sv, so,
      qscale);
  return (int)cudaGetLastError();
}

template <typename T, int DH, int BN>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int B,
           const PairGeom& geo, int n_qtiles, const long long* st, float qscale,
           cudaStream_t stream) {
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]}, sv{st[6], st[7], st[8]},
      so{st[9], st[10], st[11]};
  const unsigned blocks = (unsigned)B * (unsigned)geo.H * (unsigned)n_qtiles;
  stream_pair_fwd_kernel<T, DH, BN><<<blocks, BM, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, geo, n_qtiles, sq, sk, sv, so, qscale);
  return (int)cudaGetLastError();
}

}  // namespace

// is_bf16: 0 = fp32 q, k, v and out (the FMA kernel), 1 = bf16 (the
// tensor-core kernel: every pointer and every stride times 2 bytes a
// multiple of 16, else cudaErrorMisalignedAddress). geometry: the 13 int32
// of PairGeom (stream_common.cuh); strides: 12 element strides (batch, row,
// head) of q, k, v and out; n_qtiles = ceil(ceil(cq / qstep) / 64); B * H *
// n_qtiles blocks below 2^31; Dh == GP_HEAD_DIM; qscale = Dh^-1/2 *
// log2(e). The FMA kernel's key tiles are 64 rows, or 32 above a head width
// of 64; the tensor-core kernel's 64.
extern "C" int gp_stream_pair_fwd(const void* q, const void* k, const void* v, void* out,
                                  float* lse, int is_bf16, int B, int Dh, const int* geometry,
                                  int n_qtiles, const long long* strides, float qscale,
                                  void* stream) {
  constexpr int BN = GP_HEAD_DIM > 64 ? 32 : 64;
  const PairGeom geo = read_geom(geometry);
  if (Dh != GP_HEAD_DIM || B <= 0 || geo.H <= 0 || n_qtiles <= 0 || geo.g <= 0 || geo.r <= 0 ||
      geo.hpg <= 0 || geo.qstep <= 0 || geo.kstep <= 0 ||
      (long long)B * geo.H * n_qtiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (!gp::aligned16({q, k, v, out})) return (int)cudaErrorMisalignedAddress;
    for (int i = 0; i < 12; ++i)
      if (strides[i] % 8 != 0) return (int)cudaErrorMisalignedAddress;
    return launch_mma<GP_HEAD_DIM>(q, k, v, out, lse, B, geo, n_qtiles, strides, qscale, st);
  }
  return launch<float, GP_HEAD_DIM, BN>(q, k, v, out, lse, B, geo, n_qtiles, strides, qscale, st);
}
