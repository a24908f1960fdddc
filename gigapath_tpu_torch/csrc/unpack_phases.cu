// Phase-major unpack of one dilated-attention branch: packed
// [B, S, r, hb, Mp, Dh] -> dense [B, L, E].
//
// Replaces the Pallas kernel gigapath_tpu/ops/pallas_dilated.py:_unpack_kernel
// (called by _unpack_phases). Dense element (b, l, c) with l = s*g + p + r*j
// and channel c = h*Dh + d holds packed (b, s, p, h - p*hb, j, d) when head h
// belongs to band p (h / hb == p), and an exact 0 otherwise. Those zeros are
// the branch's cover pattern: the lanes a branch does not compute stay 0,
// and the cross-branch fusion gives them weight 0 through the lse.
//
// Bound on the H100: bytes. The kernel reads the packed tensor (about
// L*E/r elements) once and writes the dense [B, L, E] once. The design is
// one thread per dense output element in output order, so the stores are
// contiguous and off-band lanes cost no load; elements are copied as raw
// 2- or 4-byte words, so one kernel serves fp32 and bf16.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

template <typename W>
__global__ void unpack_phases_kernel(const W* __restrict__ p6, W* __restrict__ out,
                                     int L, int E, int g, int S, int R, int HB,
                                     int Dh, int Mp, long long total) {
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(idx % E);
    const long long bl = idx / E;
    const int l = (int)(bl % L);
    const long long b = bl / L;
    const int s = l / g;
    const int w = l - s * g;
    const int j = w / R;
    const int p = w - j * R;
    const int h = c / Dh;
    const int d = c - h * Dh;
    W val = 0;
    if (h / HB == p) {
      const int t = h - p * HB;
      val = p6[((((b * S + s) * R + p) * HB + t) * (long long)Mp + j) * Dh + d];
    }
    out[idx] = val;
  }
}

template <typename W>
int launch(const void* p6, void* out, int B, int L, int E, int g, int S, int R,
           int HB, int Dh, int Mp, cudaStream_t stream) {
  const long long total = (long long)B * L * E;
  if (total == 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 64) blocks = 132 * 64;
  unpack_phases_kernel<W><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const W*>(p6), static_cast<W*>(out), L, E, g, S, R, HB, Dh,
      Mp, total);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gp_unpack_phases(const void* p6, void* out, int elem_bytes,
                                int B, int L, int E, int g, int S, int R,
                                int HB, int Dh, int Mp, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4)
    return launch<uint32_t>(p6, out, B, L, E, g, S, R, HB, Dh, Mp, st);
  if (elem_bytes == 2)
    return launch<uint16_t>(p6, out, B, L, E, g, S, R, HB, Dh, Mp, st);
  return (int)cudaErrorInvalidValue;
}
