// Stream-fusion epilogue, backward: the fused output's cotangent -> every
// dilated branch's packed output cotangent, in one launch per layer.
//
// Replaces the Pallas kernel gigapath_tpu/ops/pallas_dilated.py:
// _epilogue_bwd_kernel (called by _epilogue_bwd_call, once per branch).
// Packed element (b, s, p, t, j, d) of branch (g, r) stands for token
// tok = s*g + j*r + p and lane (p*hb + t)*Dh + d. Inside the segment
// (j*r + p < g) and the sequence (tok < L) it gets
//   d_out6 = exp(lse5[b, s, p, t, j] - fused_lse[b, tok, p*hb + t]) * dY[b, tok, lane]
// in fp32, stored in dY's dtype: the fusion weight re-derived from the
// branch's lse and the forward's fused_lse, a constant of the backward (so
// no cotangent reaches the lse). Every other slot, up to Mp, is an exact 0:
// the branch's dK/dV kernel multiplies do6 by probabilities of padded rows,
// and an uninitialised slot could hold a NaN (0 * NaN poisons the sum).
//
// Bound on the H100: bytes. The layer must read dY and fused_lse once, and
// each branch's lse where it covers, and write every branch's whole packed
// tensor; it does a few operations per element (at the flagship, bf16,
// 51 MB a layer: 15.3 us at 3.35 TB/s). The design is the forward's
// (fusion_epilogue_fwd.cu) turned around, so dY is read once, not once per
// branch, and no element divides:
// - Dense blocks: a block owns 16 consecutive tokens of one batch row. It
//   first decodes each (token, branch) once into a shared table: the
//   token's phase and its packed row base (segment, phase, row j); a token
//   past L gets phase -1, which no head matches.
// - A thread owns one unit of dY (16 bytes where Dh's run and every pointer
//   allow it, 8 bytes else) of one head, fixed for the block: its head band
//   and in-band row offset for each branch are computed once. For each of
//   its tokens it loads the dY unit and fused_lse once, then every covering
//   branch's lse (unrolled over the branch count, a template parameter, and
//   predicated), and only then computes the weights and stores one unit
//   into each covering branch: about 1.9 of the flagship's 5. Threads x
//   cover a token's units, so a warp loads 512 contiguous bytes of dY and
//   stores whole Dh runs (96 bytes in bf16 at Dh = 48: three 32-byte
//   sectors).
// - Tail blocks, at the end of the same grid, write the zeros no token
//   maps to. In segment s of branch (g, r), phase p holds real rows
//   0 <= j < j0 = ceil((min(g, L - s*g) - p) / r); rows j0..Mp of every
//   head t are zeros, one contiguous run per (b, s, p, t). A tail block
//   takes a tile of those rows of one (branch, s, p) for every t: at the
//   flagship mostly the r = 1 branch's last segment (one real token, 1023
//   padded rows).
// The grid is exact, (ceil(L / 16) + tail tiles, B), and index math is
// 32-bit within the tensors (the entry checks the bound).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kMaxBranches = 8;
constexpr int kTokens = 16;     // tokens a dense block owns
constexpr int kThreads = 256;   // at most, a block
constexpr int kTailRows = 512;  // (head, row) pairs a tail tile holds

struct Branch {
  uint32_t* d6;        // [B, S, r, hb, Mp, Dh] as 32-bit words
  const float* lse5;   // [B, S, r, hb, Mp]
  int g, S, r, Mp;
  int tail0;           // this branch's first tail tile
  int sfull;           // segments with all g tokens inside L
  int nfull;           // tail tiles of one such segment (over its phases)
  int elast;           // tokens of the last segment if it is partial, else 0
  int rt;              // rows a tail tile holds of each head
};

struct Branches {
  Branch br[kMaxBranches];
};

// rows holding real tokens of phase p in a segment of e tokens
__host__ __device__ __forceinline__ int real_rows(int e, int p, int r) {
  return (e - p + r - 1) / r;  // ceil((e - p) / r), 0 if p >= e
}

__host__ __device__ __forceinline__ int tail_tiles(int e, int p, const Branch& br) {
  return (br.Mp - real_rows(e, p, br.r) + br.rt - 1) / br.rt;
}

template <int W>
__device__ __forceinline__ void load_unit(const uint32_t* p, uint32_t* w) {
  if constexpr (W == 4) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = v.x; w[1] = v.y;
  }
}

template <int W>
__device__ __forceinline__ void store_unit(uint32_t* p, const uint32_t* w) {
  if constexpr (W == 4)
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  else
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
}

// a word's lanes as fp32: two bf16 (low lane first) or one fp32
template <bool BF16>
__device__ __forceinline__ void widen(uint32_t w, float* f) {
  if (BF16) {
    f[0] = __uint_as_float(w << 16);
    f[1] = __uint_as_float(w & 0xffff0000u);
  } else {
    f[0] = __uint_as_float(w);
  }
}

template <bool BF16>
__device__ __forceinline__ uint32_t narrow(const float* f) {
  if (BF16) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(f[0], f[1]);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  return __float_as_uint(f[0]);
}

// one tail tile: rows [ja, jb) of every head of (branch k, b, s, p) set to 0
template <int W, int NB>
__device__ __forceinline__ void tail_block(const Branches& bs, int tile, int b, int H, int uDh) {
  int k = 0;
#pragma unroll
  for (int i = 1; i < NB; ++i)
    if (tile >= bs.br[i].tail0) k = i;
  const Branch& br = bs.br[k];
  int rem = tile - br.tail0;
  int s, e;
  if (rem < br.sfull * br.nfull) {
    s = rem / br.nfull;
    rem -= s * br.nfull;
    e = br.g;
  } else {
    s = br.sfull;
    rem -= br.sfull * br.nfull;
    e = br.elast;
  }
  int p = 0;
  for (; p < br.r - 1; ++p) {
    const int n = tail_tiles(e, p, br);
    if (rem < n) break;
    rem -= n;
  }
  const int ja = real_rows(e, p, br.r) + rem * br.rt;
  const int jb = min(ja + br.rt, br.Mp);
  const int hb = H / br.r;
  const int n = (jb - ja) * uDh;  // units of one head's run
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nt = blockDim.x * blockDim.y;
  const uint32_t zero[W] = {};
  for (int t = 0; t < hb; ++t) {
    uint32_t* run = br.d6 + ((((b * br.S + s) * br.r + p) * hb + t) * br.Mp + ja) * uDh * W;
    for (int u = tid; u < n; u += nt) store_unit<W>(run + u * W, zero);
  }
}

template <bool BF16, int W, int NB>
__global__ void __launch_bounds__(kThreads)
epilogue_bwd_kernel(const Branches bs, const uint32_t* __restrict__ dy,
                    const float* __restrict__ fused, int L, int H, int uDh, int dense_blocks) {
  constexpr int kLanesPerWord = BF16 ? 2 : 1;
  constexpr int kLanes = W * kLanesPerWord;
  __shared__ int2 tab[kTokens][NB];  // (phase, packed row base) of each (token, branch)
  const int b = blockIdx.y;
  if ((int)blockIdx.x >= dense_blocks) {
    tail_block<W, NB>(bs, blockIdx.x - dense_blocks, b, H, uDh);
    return;
  }
  const int t0 = blockIdx.x * kTokens;
  const int UE = H * uDh;  // units a token
  for (int i = threadIdx.y * blockDim.x + threadIdx.x; i < kTokens * NB; i += blockDim.x * blockDim.y) {
    const int tt = i / NB;
    const int k = i - tt * NB;
    const int t = t0 + tt;
    int2 d = make_int2(-1, 0);
    if (t < L) {
      const Branch& br = bs.br[k];
      const int s = t / br.g;
      const int w = t - s * br.g;
      const int p = w % br.r;
      d = make_int2(p, ((b * br.S + s) * br.r + p) * (H / br.r) * br.Mp + w / br.r);
    }
    tab[tt][k] = d;
  }
  __syncthreads();

  for (int e = threadIdx.x; e < UE; e += blockDim.x) {
    const int h = e / uDh;
    const int c = e - h * uDh;
    int band[NB], hrow[NB];  // the head's band and its row offset in the band
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      const int hb = H / bs.br[k].r;
      band[k] = h / hb;
      hrow[k] = (h - band[k] * hb) * bs.br[k].Mp;
    }
    for (int tt = threadIdx.y; tt < kTokens && t0 + tt < L; tt += blockDim.y) {
      const int bt = b * L + t0 + tt;
      uint32_t raw[W];
      load_unit<W>(dy + (bt * UE + e) * W, raw);  // dY and fused_lse once
      const float f = __ldg(fused + bt * H + h);
      float lse[NB];
      int row[NB];
      bool cov[NB];
#pragma unroll
      for (int k = 0; k < NB; ++k) {  // every covering branch's lse before any store
        const int2 d = tab[tt][k];
        row[k] = d.y + hrow[k];
        cov[k] = d.x == band[k];
        if (cov[k]) lse[k] = __ldg(bs.br[k].lse5 + row[k]);
      }
      float x[kLanes];
#pragma unroll
      for (int q = 0; q < W; ++q) widen<BF16>(raw[q], x + q * kLanesPerWord);
#pragma unroll
      for (int k = 0; k < NB; ++k) {
        if (!cov[k]) continue;
        const float wt = expf(lse[k] - f);
        float o[kLanes];
#pragma unroll
        for (int q = 0; q < kLanes; ++q) o[q] = x[q] * wt;
        uint32_t res[W];
#pragma unroll
        for (int q = 0; q < W; ++q) res[q] = narrow<BF16>(o + q * kLanesPerWord);
        store_unit<W>(bs.br[k].d6 + (row[k] * uDh + c) * W, res);
      }
    }
  }
}

template <bool BF16, int W, int NB>
void launch(const Branches& bs, int tail_blocks, const void* dy, const void* fused, int B, int L,
            int H, int uDh, cudaStream_t st) {
  const int UE = H * uDh;
  const int bx = UE < kThreads ? UE : kThreads;
  int by = kThreads / bx;
  if (by > kTokens) by = kTokens;
  const int dense_blocks = (L + kTokens - 1) / kTokens;
  epilogue_bwd_kernel<BF16, W, NB><<<dim3(dense_blocks + tail_blocks, B), dim3(bx, by), 0, st>>>(
      bs, static_cast<const uint32_t*>(dy), static_cast<const float*>(fused), L, H, uDh, dense_blocks);
}

template <bool BF16, int W>
void launch_n(int n, const Branches& bs, int tail_blocks, const void* dy, const void* fused, int B,
              int L, int H, int uDh, cudaStream_t st) {
  switch (n) {
    case 1: return launch<BF16, W, 1>(bs, tail_blocks, dy, fused, B, L, H, uDh, st);
    case 2: return launch<BF16, W, 2>(bs, tail_blocks, dy, fused, B, L, H, uDh, st);
    case 3: return launch<BF16, W, 3>(bs, tail_blocks, dy, fused, B, L, H, uDh, st);
    case 4: return launch<BF16, W, 4>(bs, tail_blocks, dy, fused, B, L, H, uDh, st);
    case 5: return launch<BF16, W, 5>(bs, tail_blocks, dy, fused, B, L, H, uDh, st);
    case 6: return launch<BF16, W, 6>(bs, tail_blocks, dy, fused, B, L, H, uDh, st);
    case 7: return launch<BF16, W, 7>(bs, tail_blocks, dy, fused, B, L, H, uDh, st);
    default: return launch<BF16, W, 8>(bs, tail_blocks, dy, fused, B, L, H, uDh, st);
  }
}

}  // namespace

extern "C" int gp_fusion_epilogue_bwd(const long long* d6_ptrs,
                                      const long long* lse_ptrs,
                                      const int* geo, int n, const void* dy,
                                      const void* fused, int is_bf16, int B,
                                      int L, int H, int Dh, void* stream) {
  const int es = is_bf16 ? 2 : 4;
  if (n < 1 || n > kMaxBranches || Dh <= 0 || Dh % 4 || H <= 0 || L < 0 || B < 0 || B > 65535 ||
      (long long)B * L * H * Dh * es / 4 >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  // the unit: 16 bytes where a head's run and every pointer allow it, else 8
  // (Dh % 4 == 0 makes a bf16 run a multiple of 8 bytes)
  int unit = (Dh * es) % 16 == 0 && (uintptr_t)dy % 16 == 0 ? 16 : 8;
  if ((uintptr_t)dy % 8 || (uintptr_t)fused % 4) return (int)cudaErrorMisalignedAddress;
  Branches bs{};
  long long tail = 0;
  for (int i = 0; i < n; ++i) {
    Branch& br = bs.br[i];
    br.d6 = reinterpret_cast<uint32_t*>(d6_ptrs[i]);
    br.lse5 = reinterpret_cast<const float*>(lse_ptrs[i]);
    br.g = geo[4 * i];
    br.S = geo[4 * i + 1];
    br.r = geo[4 * i + 2];
    br.Mp = geo[4 * i + 3];
    // every slot of the packed tensor is written: Mp rows hold a segment's
    // phase, and S segments of g tokens hold L
    if (br.g <= 0 || br.S <= 0 || br.r <= 0 || H % br.r || br.Mp <= 0 ||
        (long long)br.Mp * br.r < br.g || (long long)br.S * br.g < L || (long long)(br.S - 1) * br.g >= L ||
        (long long)B * br.S * H * br.Mp * Dh * es / 4 >= (1LL << 31))
      return (int)cudaErrorInvalidValue;
    if ((uintptr_t)d6_ptrs[i] % 8 || (uintptr_t)lse_ptrs[i] % 4) return (int)cudaErrorMisalignedAddress;
    if ((uintptr_t)d6_ptrs[i] % 16) unit = 8;
    // tail tiles: of each full segment, then of a partial last one
    const int hb = H / br.r;
    br.rt = (kTailRows + hb - 1) / hb;
    br.sfull = L / br.g;
    br.elast = L - br.sfull * br.g;
    br.tail0 = (int)tail;
    br.nfull = 0;
    long long nlast = 0;
    for (int p = 0; p < br.r; ++p) {
      br.nfull += tail_tiles(br.g, p, br);
      if (br.elast) nlast += tail_tiles(br.elast, p, br);
    }
    tail += (long long)br.sfull * br.nfull + nlast;
  }
  if ((long long)B * L == 0) return 0;
  if (tail + (L + kTokens - 1) / kTokens >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const int uDh = Dh * es / unit;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (unit == 16) launch_n<true, 4>(n, bs, (int)tail, dy, fused, B, L, H, uDh, st);
    else launch_n<true, 2>(n, bs, (int)tail, dy, fused, B, L, H, uDh, st);
  } else {
    if (unit == 16) launch_n<false, 4>(n, bs, (int)tail, dy, fused, B, L, H, uDh, st);
    else launch_n<false, 2>(n, bs, (int)tail, dy, fused, B, L, H, uDh, st);
  }
  return (int)cudaGetLastError();
}
