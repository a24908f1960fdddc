// Stream-fusion epilogue, forward: every dilated branch's packed results
// -> the fused dense output, in one launch per layer.
//
// Replaces the Pallas kernel gigapath_tpu/ops/pallas_dilated.py:
// _epilogue_fwd_kernel (called by _epilogue_pass_call). For token t and lane
// e of head h = e / Dh, branch (g, r) covers (t, h) iff head band h / hb
// equals the token's phase p = (t % g) % r (hb = H / r); it then holds
// out6[b, s, p, h % hb, j, e % Dh] and lse5[b, s, p, h % hb, j] with
// s = t / g and j = (t % g) / r. The kernel folds the covering branches into
// a running (acc, m, l) in fp32 registers: m = max(m, lse) with m starting at
// the branch kernels' floor of -1e20, acc and l rescaled by exp(m_old - m),
// the branch weighted by exp(lse - m). A branch that does not cover (t, h)
// weighs exactly 0, as its lse of -1e30 does in the dense fusion. It writes
// out = acc / l in the activations' dtype and fused_lse = m + log(l) in fp32
// [B, L, H]; a pair no branch covers gets out 0 and fused_lse -1e30. No dense
// per-branch out or lse is ever written.
//
// Bound on the H100: bytes. The kernel must read the covered packed
// elements (L*E/r of each branch) with one lse per covered (token, head),
// and write out [B, L, E] and fused_lse; it does a few operations per
// element. One thread takes 4 lanes of one head of one token (one 16- or
// 8-byte load per covering branch, one store), so a warp's loads fall on
// whole Dh runs of the packed rows. The TPU kernel splits the schedule into
// alignment classes chained through HBM (its VMEM and block-alignment
// limits); a thread here reads any branch at any token, so one pass serves
// every schedule.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kMaxBranches = 8;
constexpr float kFloor = -1e20f;
constexpr float kNegInf = -1e30f;

struct Branch {
  const void* out6;   // [B, S, r, hb, Mp, Dh]
  const float* lse5;  // [B, S, r, hb, Mp]
  int g, S, r, Mp;
};

struct Branches {
  Branch br[kMaxBranches];
  int n;
};

template <bool BF16>
__device__ __forceinline__ void load4(const void* base, long long off, float* v) {
  if (BF16) {
    const uint2 raw = *reinterpret_cast<const uint2*>(static_cast<const __nv_bfloat16*>(base) + off);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  } else {
    const float4 a = *reinterpret_cast<const float4*>(static_cast<const float*>(base) + off);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  }
}

template <bool BF16>
__device__ __forceinline__ void store4(void* base, long long off, const float* v) {
  if (BF16) {
    __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    uint2 raw;
    raw.x = *reinterpret_cast<uint32_t*>(&a);
    raw.y = *reinterpret_cast<uint32_t*>(&b);
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(base) + off) = raw;
  } else {
    *reinterpret_cast<float4*>(static_cast<float*>(base) + off) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

template <bool BF16>
__global__ void epilogue_fwd_kernel(const Branches bs, void* __restrict__ out,
                                    float* __restrict__ fused, int L, int H,
                                    int Dh, long long total) {
  const int E = H * Dh;
  const int E4 = E / 4;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const long long bt = idx / E4;  // b*L + t
    const int e0 = (int)(idx - bt * E4) * 4;
    const int t = (int)(bt % L);
    const long long b = bt / L;
    const int h = e0 / Dh;
    const int d0 = e0 - h * Dh;
    float m = kFloor, l = 0.f;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 1
    for (int i = 0; i < bs.n; ++i) {
      const Branch& br = bs.br[i];
      const int hb = H / br.r;
      const int s = t / br.g;
      const int w = t - s * br.g;
      const int p = w % br.r;
      if (h / hb != p) continue;  // this branch does not cover (t, h)
      const long long row =
          (((b * br.S + s) * br.r + p) * hb + (h - p * hb)) * (long long)br.Mp + w / br.r;
      const float lse = br.lse5[row];
      float o[4];
      load4<BF16>(br.out6, row * Dh + d0, o);
      const float m_new = fmaxf(m, lse);
      const float a = expf(m - m_new);
      const float wt = expf(lse - m_new);
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[k] = acc[k] * a + o[k] * wt;
      l = l * a + wt;
      m = m_new;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[k] = l > 0.f ? acc[k] / l : 0.f;
    store4<BF16>(out, bt * E + e0, acc);
    if (d0 == 0) fused[bt * H + h] = l > 0.f ? m + logf(l) : kNegInf;
  }
}

}  // namespace

extern "C" int gp_fusion_epilogue_fwd(const long long* out_ptrs,
                                      const long long* lse_ptrs,
                                      const int* geo, int n, void* out,
                                      void* fused, int is_bf16, int B, int L,
                                      int H, int Dh, void* stream) {
  if (n < 1 || n > kMaxBranches || Dh % 4 || H <= 0) return (int)cudaErrorInvalidValue;
  const int align = is_bf16 ? 8 : 16;  // one 4-lane vector
  if ((uintptr_t)out % align) return (int)cudaErrorMisalignedAddress;
  Branches bs{};
  bs.n = n;
  for (int i = 0; i < n; ++i) {
    bs.br[i].out6 = reinterpret_cast<const void*>(out_ptrs[i]);
    bs.br[i].lse5 = reinterpret_cast<const float*>(lse_ptrs[i]);
    bs.br[i].g = geo[4 * i];
    bs.br[i].S = geo[4 * i + 1];
    bs.br[i].r = geo[4 * i + 2];
    bs.br[i].Mp = geo[4 * i + 3];
    if (bs.br[i].g <= 0 || bs.br[i].r <= 0 || H % bs.br[i].r) return (int)cudaErrorInvalidValue;
    if ((uintptr_t)out_ptrs[i] % align) return (int)cudaErrorMisalignedAddress;
  }
  const long long total = (long long)B * L * (H * Dh / 4);
  if (total == 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond ~32 blocks/SM
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    epilogue_fwd_kernel<true><<<(unsigned)blocks, threads, 0, st>>>(bs, out, static_cast<float*>(fused), L, H, Dh, total);
  else
    epilogue_fwd_kernel<false><<<(unsigned)blocks, threads, 0, st>>>(bs, out, static_cast<float*>(fused), L, H, Dh, total);
  return (int)cudaGetLastError();
}
