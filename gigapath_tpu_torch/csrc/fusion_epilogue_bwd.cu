// Stream-fusion epilogue, backward: the fused output's cotangent -> one
// branch's packed output cotangent, one launch per branch.
//
// Replaces the Pallas kernel gigapath_tpu/ops/pallas_dilated.py:
// _epilogue_bwd_kernel (called by _epilogue_bwd_call). Packed element
// (b, s, p, t, j, d) of branch (g, r) stands for token tok = s*g + j*r + p
// and lane (p*hb + t)*Dh + d. Inside the segment (j*r + p < g) and the
// sequence (tok < L) it gets
//   d_out6 = exp(lse5[b, s, p, t, j] - fused_lse[b, tok, p*hb + t]) * dY[b, tok, lane]
// in fp32, stored in dY's dtype: the fusion weight re-derived from the
// branch's lse and the forward's fused_lse, a constant of the backward (so
// no cotangent reaches the lse). Every other slot, up to Mp, is an exact 0:
// the branch's dK/dV kernel multiplies do6 by probabilities of padded rows,
// and an uninitialised slot could hold a NaN (0 * NaN poisons the sum).
//
// Bound on the H100: bytes. The kernel must read the covered lanes of dY
// (L*E/r elements) with one fused_lse and one lse per covered (token, head),
// and write the whole packed tensor. One thread takes 4 packed elements of
// one row (one 16- or 8-byte load of dY, one store), so the stores are
// contiguous and a warp's loads fall on whole Dh runs of dY's rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

template <bool BF16>
__global__ void epilogue_bwd_kernel(const void* __restrict__ dy,
                                    const float* __restrict__ fused,
                                    const float* __restrict__ lse5,
                                    void* __restrict__ d6, int L, int H,
                                    int Dh, int g, int S, int R, int Mp,
                                    long long total) {
  const int HB = H / R;
  const int D4 = Dh / 4;
  const long long E = (long long)H * Dh;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const long long row = idx / D4;  // ((((b*S + s)*R + p)*HB + t)*Mp + j
    const int d0 = (int)(idx - row * D4) * 4;
    const int j = (int)(row % Mp);
    long long cell = row / Mp;
    const int t = (int)(cell % HB);
    cell /= HB;
    const int p = (int)(cell % R);
    cell /= R;
    const int s = (int)(cell % S);
    const long long b = cell / S;
    const long long w = (long long)j * R + p;
    const long long tok = (long long)s * g + w;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (w < g && tok < L) {
      const int h = p * HB + t;
      const float wt = expf(lse5[row] - fused[(b * L + tok) * H + h]);
      const long long off = (b * L + tok) * E + (long long)h * Dh + d0;
      if (BF16) {
        const uint2 raw = *reinterpret_cast<const uint2*>(static_cast<const __nv_bfloat16*>(dy) + off);
        const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
        const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
        v[0] = a.x * wt; v[1] = a.y * wt; v[2] = c.x * wt; v[3] = c.y * wt;
      } else {
        const float4 a = *reinterpret_cast<const float4*>(static_cast<const float*>(dy) + off);
        v[0] = a.x * wt; v[1] = a.y * wt; v[2] = a.z * wt; v[3] = a.w * wt;
      }
    }
    const long long o = row * Dh + d0;
    if (BF16) {
      __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
      __nv_bfloat162 c = __floats2bfloat162_rn(v[2], v[3]);
      uint2 raw;
      raw.x = *reinterpret_cast<uint32_t*>(&a);
      raw.y = *reinterpret_cast<uint32_t*>(&c);
      *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(d6) + o) = raw;
    } else {
      *reinterpret_cast<float4*>(static_cast<float*>(d6) + o) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

}  // namespace

extern "C" int gp_fusion_epilogue_bwd(const void* dy, const void* fused,
                                      const void* lse5, void* d6, int is_bf16,
                                      int B, int L, int H, int Dh, int g,
                                      int S, int R, int Mp, void* stream) {
  if (Dh % 4 || R <= 0 || H % R || g <= 0 || Mp <= 0) return (int)cudaErrorInvalidValue;
  const int align = is_bf16 ? 8 : 16;
  if ((uintptr_t)dy % align || (uintptr_t)d6 % align) return (int)cudaErrorMisalignedAddress;
  const long long total = (long long)B * S * H * Mp * (Dh / 4);  // R*HB = H
  if (total == 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* f = static_cast<const float*>(fused);
  const float* l5 = static_cast<const float*>(lse5);
  if (is_bf16)
    epilogue_bwd_kernel<true><<<(unsigned)blocks, threads, 0, st>>>(dy, f, l5, d6, L, H, Dh, g, S, R, Mp, total);
  else
    epilogue_bwd_kernel<false><<<(unsigned)blocks, threads, 0, st>>>(dy, f, l5, d6, L, H, Dh, g, S, R, Mp, total);
  return (int)cudaGetLastError();
}
