// Phase-major pack of one dilated-attention branch: dense [B, L, E] ->
// diagonal-only packed [B, S, r, hb, Mp, Dh].
//
// Replaces the Pallas kernel gigapath_tpu/ops/pallas_dilated.py:_pack_kernel
// (called by _pack_phases). Packed element (b, s, p, t, j, d) holds
//   x[b, s*g + p + r*j, (p*hb + t)*Dh + d]
// when that token lies inside its segment (p + r*j < g) and the sequence
// (token < L), and an exact 0 otherwise: packed K/V pads must be zeros, or a
// masked probability of 0 times a NaN would poison the PV product.
//
// Bound on the H100: bytes. The kernel moves about 2*L*E/r elements (the
// band it reads, the packed tensor it writes) and does no arithmetic. The
// design is one thread per packed element in output order, so the stores
// and, within a head's Dh run, the loads are contiguous; elements are copied
// as raw 2- or 4-byte words, so one kernel serves fp32 and bf16.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

template <typename W>
__global__ void pack_phases_kernel(const W* __restrict__ x, W* __restrict__ out,
                                   int L, int E, int g, int S, int R, int HB,
                                   int Dh, int Mp, long long total) {
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    long long rest = idx;
    const int d = (int)(rest % Dh);
    rest /= Dh;
    const int j = (int)(rest % Mp);
    rest /= Mp;
    const int t = (int)(rest % HB);
    rest /= HB;
    const int p = (int)(rest % R);
    rest /= R;
    const int s = (int)(rest % S);
    const long long b = rest / S;
    const long long w = (long long)j * R + p;  // position inside the segment
    const long long tok = (long long)s * g + w;
    W val = 0;
    if (w < g && tok < L) {
      val = x[(b * L + tok) * E + (long long)(p * HB + t) * Dh + d];
    }
    out[idx] = val;
  }
}

template <typename W>
int launch(const void* x, void* out, int B, int L, int E, int g, int S, int R,
           int HB, int Dh, int Mp, cudaStream_t stream) {
  const long long total = (long long)B * S * R * HB * Mp * Dh;
  if (total == 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 64) blocks = 132 * 64;  // grid-stride beyond ~64 blocks/SM
  pack_phases_kernel<W><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const W*>(x), static_cast<W*>(out), L, E, g, S, R, HB, Dh,
      Mp, total);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gp_pack_phases(const void* x, void* out, int elem_bytes, int B,
                              int L, int E, int g, int S, int R, int HB,
                              int Dh, int Mp, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4)
    return launch<uint32_t>(x, out, B, L, E, g, S, R, HB, Dh, Mp, st);
  if (elem_bytes == 2)
    return launch<uint16_t>(x, out, B, L, E, g, S, R, HB, Dh, Mp, st);
  return (int)cudaErrorInvalidValue;
}
