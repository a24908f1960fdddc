// Single-segment phase-major pack of one dilated-attention branch, read
// straight off the dense activations: [B, L, E] -> packed [B, 1, r, hb, Mp, Dh].
//
// Replaces the Pallas kernel gigapath_tpu/ops/pallas_dilated.py:
// _pack_kernel_direct (called by _pack_phases when S == 1, r > 1 and
// pack_direct is set). With one segment covering the sequence, dense row
// j*r + p is packed row j of phase p, and only its band-p lanes
// [p*W, (p+1)*W), W = hb*Dh = E/r, are kept: packed (b, 0, p, t, j, d) holds
// x[b, j*r + p, (p*hb + t)*Dh + d], or an exact 0 for a row >= L (by logical
// row index; packed K/V pads must be zeros, or a masked probability of 0
// times a NaN poisons the PV product). Packed rows past the dense extent, up
// to Mp, are rows >= L too.
//
// Bound on the H100: bytes. The kernel must read the L*E/r band elements and
// write the B*Mp*E packed ones, and does no arithmetic. Where the row-2 pack
// (pack_phases.cu) gathers one element per thread, this one gives each block
// BT packed rows of every phase, i.e. BT*r contiguous dense rows: it loads
// each row's band with 16-byte vector loads (the widest unit that the
// element size, Dh and the pointers allow) into shared memory, then writes
// each (phase, head)'s [BT, Dh] packed strip, which is contiguous, with
// vector stores from shared memory. Elements are copied as raw words, so one
// kernel serves fp32 and bf16.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemBytes = 48 * 1024;  // no opt-in above the static limit

template <typename U>
__global__ void pack_direct_kernel(const unsigned char* __restrict__ x,
                                   unsigned char* __restrict__ out, int L,
                                   int uE, int R, int HB, int uD, int Mp,
                                   int BT) {
  extern __shared__ __align__(16) unsigned char smem[];
  U* tile = reinterpret_cast<U*>(smem);  // [BT*R rows][uW]: each row's band
  const int uW = HB * uD;
  const long long b = blockIdx.y;
  const int j0 = blockIdx.x * BT;
  const U* xb = reinterpret_cast<const U*>(x) + b * L * (long long)uE;
  U* ob = reinterpret_cast<U*>(out) + b * (long long)R * HB * Mp * uD;

  // 1. the band lanes of dense rows j0*R .. (j0+BT)*R - 1; rows >= L are 0
  const int rows = BT * R;
  for (int i = threadIdx.x; i < rows * uW; i += blockDim.x) {
    const int lr = i / uW;
    const int c = i - lr * uW;
    const long long row = (long long)j0 * R + lr;
    const int p = lr % R;  // j0*R is a multiple of R
    U v{};
    if (row < L) v = xb[row * uE + p * uW + c];
    tile[i] = v;
  }
  __syncthreads();

  // 2. each (phase, head): packed rows j0 .. j0+BT-1, one [BT, Dh] strip
  const int strip = BT * uD;
  for (int i = threadIdx.x; i < R * HB * strip; i += blockDim.x) {
    const int ph = i / strip;  // p*HB + t
    const int rest = i - ph * strip;
    const int jj = rest / uD;
    const int c = rest - jj * uD;
    const int p = ph / HB;
    const int t = ph - p * HB;
    ob[((long long)ph * Mp + j0 + jj) * uD + c] = tile[(jj * R + p) * uW + t * uD + c];
  }
}

template <typename U>
int launch(const void* x, void* out, int B, int L, int E, int R, int HB,
           int Dh, int Mp, int es, cudaStream_t stream) {
  const int u = (int)sizeof(U);
  // packed rows per block: the largest power of two <= 16 that divides Mp,
  // fits the shared memory, and leaves about two blocks per SM
  int BT = 16;
  while (BT > 1 && (Mp % BT || (long long)BT * E * es > kSmemBytes ||
                    (long long)B * (Mp / BT) < 2 * 132))
    BT /= 2;
  if ((long long)BT * E * es > kSmemBytes) return (int)cudaErrorInvalidValue;
  dim3 grid(Mp / BT, B);
  pack_direct_kernel<U><<<grid, kThreads, (size_t)BT * E * es, stream>>>(
      static_cast<const unsigned char*>(x), static_cast<unsigned char*>(out),
      L, E * es / u, R, HB, Dh * es / u, Mp, BT);
  return (int)cudaGetLastError();
}

}  // namespace

// The widest copy unit that divides a head's Dh run (so a band, a row and a
// packed strip too) and both pointers' alignment.
static int unit_bytes(int es, int Dh, const void* a, const void* b) {
  for (int u = 16; u > es; u /= 2)
    if ((Dh * es) % u == 0 && (uintptr_t)a % u == 0 && (uintptr_t)b % u == 0)
      return u;
  return es;
}

extern "C" int gp_pack_phases_direct(const void* x, void* out, int elem_bytes,
                                     int B, int L, int E, int R, int HB,
                                     int Dh, int Mp, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((elem_bytes != 2 && elem_bytes != 4) || R * HB * Dh != E || Mp <= 0 ||
      (long long)Mp * R < L || B > 65535)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * L * E == 0) return 0;
  switch (unit_bytes(elem_bytes, Dh, x, out)) {
    case 16: return launch<uint4>(x, out, B, L, E, R, HB, Dh, Mp, elem_bytes, st);
    case 8: return launch<uint2>(x, out, B, L, E, R, HB, Dh, Mp, elem_bytes, st);
    case 4: return launch<uint32_t>(x, out, B, L, E, R, HB, Dh, Mp, elem_bytes, st);
    default: return launch<uint16_t>(x, out, B, L, E, R, HB, Dh, Mp, elem_bytes, st);
  }
}
