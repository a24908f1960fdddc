// Geometry shared by the streaming chunk-pair kernels (forward, dq, dkv).
//
// One dilated branch (segment length g, ratio r) restricted to one query
// block of cq rows at global token offset q0 and one key block of ck rows at
// k0, on [B, c, H, Dh] blocks addressed through (batch, row, head) strides.
// Head h belongs to phase p = h / ceil(H/r). With t = q0 + i and u = k0 + j:
//   row i is valid     iff ((t % g) % r) == p
//   column j is valid  iff ((u % g) % r) == p and u < valid
//   the pair is seen   iff both are valid and t / g == u / g.
// These are the masks of gigapath_tpu/ops/pallas_streaming.py:_pair_masks,
// evaluated per element.
//
// The phase lattice. Where the segment and ratio allow it, the valid rows of
// a head lie on a lattice i = start + step * n of the block (step = r), so a
// kernel enumerates those rows only and does 1/r of the rows' work (and of
// the keys', 1/r^2 of the pairs'). The host picks (step, shift) per block:
// step = r and shift = 0 when g % r == 0; step = r and shift = (s*g) % r when
// the whole block lies in one segment s; otherwise step = 1 (every row). The
// per-element masks above still decide what is seen, so the lattice only
// skips rows that are masked anyway. Rows and keys off the lattice are not
// touched: the wrapper allocates their outputs as zeros (and the lse as the
// fully-masked sentinel).

#pragma once

#include "branch_common.cuh"

namespace gp {

constexpr float STREAM_M_FLOOR = -1e20f;  // running-max floor: masked scores underflow to exactly 0
constexpr float STREAM_NEG_INF = -1e30f;  // a masked score, selected before the max

struct Strides {  // element strides of batch, row and head; the head width is contiguous
  long long b, l, h;
};

// The host's int32 geometry array, in this order.
struct PairGeom {
  int H, hpg, g, r;
  int q0, cq, qstep, qshift;
  int k0, ck, kstep, kshift;
  int valid;
};

inline PairGeom read_geom(const int* a) {
  return PairGeom{a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7], a[8], a[9], a[10], a[11], a[12]};
}

// The lattice rows of one block for one phase: local rows start + step*n,
// n < count.
struct Lattice {
  int start, step, count;
  __device__ __forceinline__ int row(int n) const { return start + step * n; }
};

// Rows of a c-row block at global offset off on the lattice of phase p.
__device__ __forceinline__ Lattice lattice(int p, int off, int c, int step, int shift) {
  int start = (p + shift - off) % step;
  if (start < 0) start += step;
  const int count = start < c ? (c - 1 - start) / step + 1 : 0;
  return Lattice{start, step, count};
}

// The key lattice cut at the global bound `valid`: keys at or past it are
// masked, and they lie at the lattice's end.
__device__ __forceinline__ Lattice key_lattice(int p, const PairGeom& geo) {
  Lattice kl = lattice(p, geo.k0, geo.ck, geo.kstep, geo.kshift);
  const long long room = (long long)geo.valid - geo.k0 - kl.start;  // keys below valid
  const long long below = room > 0 ? (room + kl.step - 1) / kl.step : 0;
  if (below < kl.count) kl.count = (int)below;
  return kl;
}

// Segment of a query row, or -2 when the row is masked (never equal to a
// key's segment or to the -1 of a masked key).
__device__ __forceinline__ int row_segment(bool on_block, int t, int p, const PairGeom& geo) {
  return on_block && ((t % geo.g) % geo.r) == p ? t / geo.g : -2;
}

// Segment of a key, or -1 when the key is masked.
__device__ __forceinline__ int key_segment(bool on_block, int u, int p, const PairGeom& geo) {
  return on_block && u < geo.valid && ((u % geo.g) % geo.r) == p ? u / geo.g : -1;
}

// Whether lattice rows [n0, n1) of `a` (at global offset off_a) and [m0, m1)
// of `b` (at off_b) can share a segment. Both lattices ascend, so the first
// and last rows bound each range.
__device__ __forceinline__ bool segments_meet(const Lattice& a, int off_a, int n0, int n1,
                                              const Lattice& b, int off_b, int m0, int m1,
                                              int g) {
  const int a_lo = (off_a + a.row(n0)) / g, a_hi = (off_a + a.row(n1 - 1)) / g;
  const int b_lo = (off_b + b.row(m0)) / g, b_hi = (off_b + b.row(m1 - 1)) / g;
  return !(b_hi < a_lo || b_lo > a_hi);
}

// One (batch, head) of a chunk pair as the bf16 backward tile steps of
// bwd_mma.cuh see it (the cell map of row 16): the head's query and key
// lattices, the pair's geometry for the segment mask, and the row strides
// (elements) of the tensors, whose pointers the kernel has moved to the
// (batch, head). Tile rows are lattice indices: row n of the query block
// is ql.row(n), at q + ql.row(n) * ld_q, with its lse and delta at
// ql.row(n) of the head's [cq] vectors. nq, nk and kv take FlashCell's
// names: the lattice rows, and the lattice keys below valid (nk = kv, so
// no key tile is all past valid). The mask is q_seg(n) == k_seg(m), each
// -2 or -1 where the row or key is masked (row_segment, key_segment).
struct StreamCell {
  Lattice ql, kl;  // kl cut at valid (key_lattice)
  int nq, nk, kv;
  int phase;
  PairGeom geo;
  long long ld_q, ld_k, ld_v, ld_do, ld_o1, ld_o2;  // q, k, v, dout, then dq (or dk and dv)

  __device__ __forceinline__ int q_seg(int n) const { return row_segment(n < nq, geo.q0 + ql.row(n), phase, geo); }
  __device__ __forceinline__ int k_seg(int m) const { return key_segment(m < kv, geo.k0 + kl.row(m), phase, geo); }

  // The 64-row tiles [t0, t0 + n) of lattice b (nb rows) whose segments
  // can meet rows [n0, min(n0 + 64, na)) of lattice a: a contiguous range,
  // since both lattices ascend (a tile's first and last segments do).
  __device__ static void meeting(const Lattice& a, int off_a, int n0, int na, const Lattice& b, int off_b, int nb,
                                 int g, int& t0, int& n) {
    const int n1 = min(n0 + 64, na);
    int lo = -1, hi = -1;
    for (int m0 = 0; m0 < nb; m0 += 64)
      if (segments_meet(a, off_a, n0, n1, b, off_b, m0, min(m0 + 64, nb), g)) {
        if (lo < 0) lo = m0 / 64;
        hi = m0 / 64 + 1;
      }
    t0 = max(lo, 0);
    n = lo < 0 ? 0 : hi - lo;
  }
  // the key tiles that query rows [row0, row0 + 64) can see
  __device__ __forceinline__ void key_tiles(int row0, int& t0, int& n) const {
    meeting(ql, geo.q0, row0, nq, kl, geo.k0, kv, geo.g, t0, n);
  }
  // the query tiles that can see keys [key0, key0 + 64)
  __device__ __forceinline__ void query_tiles(int key0, int& t0, int& n) const {
    meeting(kl, geo.k0, key0, kv, ql, geo.q0, nq, geo.g, t0, n);
  }
};

// The cell map of head h's phase of one (batch, head); strides as StreamCell.
__device__ __forceinline__ StreamCell stream_cell(const PairGeom& geo, int h, long long ld_q, long long ld_k,
                                                  long long ld_v, long long ld_do, long long ld_o1,
                                                  long long ld_o2) {
  StreamCell c;
  c.phase = h / geo.hpg;
  c.geo = geo;
  c.ql = lattice(c.phase, geo.q0, geo.cq, geo.qstep, geo.qshift);
  c.kl = key_lattice(c.phase, geo);
  c.nq = c.ql.count;
  c.nk = c.kv = c.kl.count;
  c.ld_q = ld_q;
  c.ld_k = ld_k;
  c.ld_v = ld_v;
  c.ld_do = ld_do;
  c.ld_o1 = ld_o1;
  c.ld_o2 = ld_o2;
  return c;
}

// Stage rows [n0, n0 + rows) of lattice `lat` (fewer past lat.count: zeros)
// of one head's [c, DH] slice `base` (row stride `ld`) into shared memory
// as fp32, with coalesced reads of each row's DH contiguous elements.
template <typename T, int DH>
__device__ __forceinline__ void stage_rows(const T* base, long long ld, const Lattice& lat,
                                           int n0, int rows, float* smem, int nthreads) {
  for (int e = threadIdx.x; e < rows * DH; e += nthreads) {
    const int n = e / DH, d = e - n * DH;
    smem[e] = n0 + n < lat.count ? load_f32(base + (long long)lat.row(n0 + n) * ld + d) : 0.f;
  }
}

// Store rows [n0, n0 + rows) (those below lat.count) from shared memory to
// one head's slice `base`.
template <typename T, int DH>
__device__ __forceinline__ void store_rows(const float* smem, const Lattice& lat, int n0, int rows,
                                           T* base, long long ld, int nthreads) {
  for (int e = threadIdx.x; e < rows * DH; e += nthreads) {
    const int n = e / DH, d = e - n * DH;
    if (n0 + n < lat.count) store_f32(base + (long long)lat.row(n0 + n) * ld + d, smem[e]);
  }
}

}  // namespace gp
