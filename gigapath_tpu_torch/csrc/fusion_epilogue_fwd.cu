// Stream-fusion epilogue, forward: every dilated branch's packed results
// -> the fused dense output, in one launch per layer.
//
// Replaces the Pallas kernel gigapath_tpu/ops/pallas_dilated.py:
// _epilogue_fwd_kernel (called by _epilogue_pass_call). For token t and lane
// e of head h = e / Dh, branch (g, r) covers (t, h) iff head band h / hb
// equals the token's phase p = (t % g) % r (hb = H / r); it then holds
// out6[b, s, p, h % hb, j, e % Dh] and lse5[b, s, p, h % hb, j] with
// s = t / g and j = (t % g) / r. The kernel folds the covering branches into
// a running (acc, m, l) in fp32 registers, in the plan's branch order:
// m = max(m, lse) with m starting at the branch kernels' floor of -1e20,
// acc and l rescaled by expf(m_old - m), the branch weighted by
// expf(lse - m). A branch that does not cover (t, h) weighs exactly 0, as
// its lse of -1e30 does in the dense fusion. It writes out = acc / l in the
// activations' dtype and fused_lse = m + log(l) in fp32 [B, L, H]; a pair no
// branch covers gets out 0 and fused_lse -1e30. No dense per-branch out or
// lse is ever written.
//
// Bound on the H100: bytes. The kernel must read the covered packed
// elements (L*E/r of each branch) with one lse per covered (token, head),
// and write out [B, L, E] and fused_lse; it does a few operations per
// element (at the flagship, bf16, 48 MB a layer: 14.4 us at 3.35 TB/s).
// So the design keeps as many loads in flight as the memory system needs
// and spends no instructions per element on index math:
// - A block owns 16 consecutive tokens of one batch row. It first decodes
//   each (token, branch) once into a shared table: the token's phase and its
//   packed row base (segment, phase, row j); a token past L gets phase -1,
//   which no head matches. A segment end inside the tile is just another
//   token's entry, so a tile may straddle any segment end.
// - A thread owns one unit of out (16 bytes where Dh's run and every
//   pointer allow it, 8 bytes else: 8 or 4 bf16 lanes, 4 or 2 fp32 ones) of
//   one head, fixed for the block: its head band and in-band row offset for
//   each branch are computed once. For each of its tokens it issues the
//   loads of every covering branch before the first fold (unrolled over
//   the branch count, a template parameter, and predicated, so a warp whose
//   heads differ in cover issues them together: about 1.9 of the
//   flagship's 5 a (token, head), against a dependent round trip each
//   before), then folds from registers in branch order and stores one
//   unit. The thread at a head's first unit writes fused_lse once.
// - Threads x cover a token's units, so a warp stores 512 contiguous bytes
//   and loads whole Dh runs of out6 (96 bytes in bf16 at Dh = 48: three
//   32-byte sectors); threads y split the tile's tokens. The grid is exact,
//   (ceil(L / 16), B), and index math is 32-bit within the tensors (the
//   entry checks the bound).
// The TPU kernel splits the schedule into alignment classes chained through
// HBM, because a Pallas block reads one aligned window of every branch; a
// thread here reads any branch's row at any token, so one pass serves every
// schedule.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kMaxBranches = 8;
constexpr int kTokens = 16;   // tokens a block owns
constexpr int kThreads = 256; // at most, a block
constexpr float kFloor = -1e20f;
constexpr float kNegInf = -1e30f;

struct Branch {
  const uint32_t* out6;  // [B, S, r, hb, Mp, Dh] as 32-bit words
  const float* lse5;     // [B, S, r, hb, Mp]
  int g, S, r, Mp;
};

struct Branches {
  Branch br[kMaxBranches];
};

// one unit: W 32-bit words (16 or 8 bytes)
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

template <bool BF16, int W, int NB>
__global__ void __launch_bounds__(kThreads)
epilogue_fwd_kernel(const Branches bs, uint32_t* __restrict__ out,
                    float* __restrict__ fused, int L, int H, int uDh) {
  constexpr int kLanesPerWord = BF16 ? 2 : 1;
  constexpr int kLanes = W * kLanesPerWord;
  __shared__ int2 tab[kTokens][NB];  // (phase, packed row base) of each (token, branch)
  const int b = blockIdx.y;
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
      uint32_t raw[NB][W];
      float lse[NB];
      bool cov[NB];
#pragma unroll
      for (int k = 0; k < NB; ++k) {  // every covering branch's loads first
        const int2 d = tab[tt][k];
        const int row = d.y + hrow[k];
        cov[k] = d.x == band[k];
        if (cov[k]) {
          lse[k] = __ldg(bs.br[k].lse5 + row);
          load_unit<W>(bs.br[k].out6 + (row * uDh + c) * W, raw[k]);
        }
      }
      float m = kFloor, l = 0.f;
      float acc[kLanes];
#pragma unroll
      for (int q = 0; q < kLanes; ++q) acc[q] = 0.f;
#pragma unroll
      for (int k = 0; k < NB; ++k) {  // then the fold, in branch order
        if (!cov[k]) continue;
        float o[kLanes];
#pragma unroll
        for (int q = 0; q < W; ++q) widen<BF16>(raw[k][q], o + q * kLanesPerWord);
        const float m_new = fmaxf(m, lse[k]);
        const float a = expf(m - m_new);
        const float wt = expf(lse[k] - m_new);
#pragma unroll
        for (int q = 0; q < kLanes; ++q) acc[q] = acc[q] * a + o[q] * wt;
        l = l * a + wt;
        m = m_new;
      }
#pragma unroll
      for (int q = 0; q < kLanes; ++q) acc[q] = l > 0.f ? acc[q] / l : 0.f;
      uint32_t res[W];
#pragma unroll
      for (int q = 0; q < W; ++q) res[q] = narrow<BF16>(acc + q * kLanesPerWord);
      const int bt = b * L + t0 + tt;
      store_unit<W>(out + (bt * UE + e) * W, res);
      if (c == 0) fused[bt * H + h] = l > 0.f ? m + logf(l) : kNegInf;
    }
  }
}

template <bool BF16, int W, int NB>
void launch(const Branches& bs, void* out, void* fused, int B, int L, int H, int uDh,
            cudaStream_t st) {
  const int UE = H * uDh;
  const int bx = UE < kThreads ? UE : kThreads;
  int by = kThreads / bx;
  if (by > kTokens) by = kTokens;
  epilogue_fwd_kernel<BF16, W, NB><<<dim3((L + kTokens - 1) / kTokens, B), dim3(bx, by), 0, st>>>(
      bs, static_cast<uint32_t*>(out), static_cast<float*>(fused), L, H, uDh);
}

template <bool BF16, int W>
void launch_n(int n, const Branches& bs, void* out, void* fused, int B, int L, int H, int uDh,
              cudaStream_t st) {
  switch (n) {
    case 1: return launch<BF16, W, 1>(bs, out, fused, B, L, H, uDh, st);
    case 2: return launch<BF16, W, 2>(bs, out, fused, B, L, H, uDh, st);
    case 3: return launch<BF16, W, 3>(bs, out, fused, B, L, H, uDh, st);
    case 4: return launch<BF16, W, 4>(bs, out, fused, B, L, H, uDh, st);
    case 5: return launch<BF16, W, 5>(bs, out, fused, B, L, H, uDh, st);
    case 6: return launch<BF16, W, 6>(bs, out, fused, B, L, H, uDh, st);
    case 7: return launch<BF16, W, 7>(bs, out, fused, B, L, H, uDh, st);
    default: return launch<BF16, W, 8>(bs, out, fused, B, L, H, uDh, st);
  }
}

}  // namespace

extern "C" int gp_fusion_epilogue_fwd(const long long* out_ptrs,
                                      const long long* lse_ptrs,
                                      const int* geo, int n, void* out,
                                      void* fused, int is_bf16, int B, int L,
                                      int H, int Dh, void* stream) {
  const int es = is_bf16 ? 2 : 4;
  if (n < 1 || n > kMaxBranches || Dh <= 0 || Dh % 4 || H <= 0 || B < 0 || B > 65535 ||
      (long long)B * L * H * Dh * es / 4 >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  // the unit: 16 bytes where a head's run and every pointer allow it, else 8
  // (Dh % 4 == 0 makes a bf16 run a multiple of 8 bytes)
  int unit = (Dh * es) % 16 == 0 && (uintptr_t)out % 16 == 0 ? 16 : 8;
  if ((uintptr_t)out % 8 || (uintptr_t)fused % 4) return (int)cudaErrorMisalignedAddress;
  Branches bs{};
  for (int i = 0; i < n; ++i) {
    Branch& br = bs.br[i];
    br.out6 = reinterpret_cast<const uint32_t*>(out_ptrs[i]);
    br.lse5 = reinterpret_cast<const float*>(lse_ptrs[i]);
    br.g = geo[4 * i];
    br.S = geo[4 * i + 1];
    br.r = geo[4 * i + 2];
    br.Mp = geo[4 * i + 3];
    if (br.g <= 0 || br.S <= 0 || br.r <= 0 || H % br.r || br.Mp <= 0 ||
        (long long)B * br.S * H * br.Mp * Dh * es / 4 >= (1LL << 31))
      return (int)cudaErrorInvalidValue;
    if ((uintptr_t)out_ptrs[i] % 8 || (uintptr_t)lse_ptrs[i] % 4) return (int)cudaErrorMisalignedAddress;
    if ((uintptr_t)out_ptrs[i] % 16) unit = 8;
  }
  if ((long long)B * L == 0) return 0;
  const int uDh = Dh * es / unit;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (unit == 16) launch_n<true, 4>(n, bs, out, fused, B, L, H, uDh, st);
    else launch_n<true, 2>(n, bs, out, fused, B, L, H, uDh, st);
  } else {
    if (unit == 16) launch_n<false, 4>(n, bs, out, fused, B, L, H, uDh, st);
    else launch_n<false, 2>(n, bs, out, fused, B, L, H, uDh, st);
  }
  return (int)cudaGetLastError();
}
