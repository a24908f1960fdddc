// Phase-major pack of one dilated-attention branch: dense [B, L, E] ->
// diagonal-only packed [B, S, r, hb, Mp, Dh].
//
// Replaces the Pallas kernel gigapath_tpu/ops/pallas_dilated.py:_pack_kernel
// (called by _pack_phases). Packed element (b, s, p, t, j, d) holds
//   x[b, s*g + p + r*j, (p*hb + t)*Dh + d]
// when that token lies inside its segment (w = p + r*j < g) and the sequence
// (token < L), and an exact 0 otherwise: packed K/V pads must be zeros, or a
// masked probability of 0 times a NaN would poison the PV product.
//
// Bound on the H100: bytes. The kernel must read the L*E/r band elements and
// write the whole packed tensor, and does no arithmetic. It is the direct
// unpack's tiling (unpack_phases_direct.cu) run the other way, with a segment
// index: the grid is (Mp / BT, S, B), and block (i, s, b) takes packed rows
// j0 = i*BT .. j0+BT-1 of every phase of segment s, i.e. the BT*r
// consecutive in-segment positions w = j0*r .. (j0+BT)*r - 1. It loads only
// row w's band p = w % r into shared memory, in the widest unit (16, 8, 4
// or 2 bytes) that Dh's run and both pointers allow; rows past the segment
// (w >= g) or the sequence are zero-filled without a read. It then writes
// each (phase, head)'s packed [BT, Dh] strip, which is contiguous, with
// vector stores from shared memory. Index math per unit is 32-bit over the
// block's own ranges; 64-bit arithmetic appears only in the base offsets.
// Elements are copied as raw units, so one kernel serves fp32 and bf16.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemBytes = 48 * 1024;  // no opt-in above the static limit
constexpr int kSMs = 132;

template <typename U>
__global__ void pack_phases_kernel(const unsigned char* __restrict__ x,
                                   unsigned char* __restrict__ out, int L,
                                   int g, int uE, int R, int HB, int uD, int Mp,
                                   int BT) {
  extern __shared__ __align__(16) unsigned char smem[];
  U* tile = reinterpret_cast<U*>(smem);  // [BT*R rows][uW]: each row's band
  const int uW = HB * uD;
  const int s = blockIdx.y;
  const long long b = blockIdx.z;
  const int j0 = blockIdx.x * BT;
  const int w0 = j0 * R;                 // first in-segment position
  const long long tok0 = (long long)s * g + w0;
  // rows of this block that hold a real token: inside the segment and < L
  long long inside = g - w0 < L - tok0 ? g - w0 : L - tok0;
  if (inside > BT * R) inside = BT * R;
  const int valid = inside > 0 ? (int)inside : 0;
  const U* xs = reinterpret_cast<const U*>(x) + (b * L + tok0) * (long long)uE;
  U* os = reinterpret_cast<U*>(out) +
          ((b * gridDim.y + s) * (long long)R * HB * Mp + j0) * uD;

  // 1. the band lanes of the block's rows; rows past the segment or L are 0
  const int rows = BT * R;
  for (int i = threadIdx.x; i < rows * uW; i += kThreads) {
    const int lr = i / uW;
    const int c = i - lr * uW;
    U v{};
    if (lr < valid) v = xs[(long long)lr * uE + (lr % R) * uW + c];
    tile[i] = v;
  }
  __syncthreads();

  // 2. each (phase, head): packed rows j0 .. j0+BT-1, one [BT, Dh] strip
  const int strip = BT * uD;
  for (int i = threadIdx.x; i < R * HB * strip; i += kThreads) {
    const int ph = i / strip;  // p*HB + t
    const int rest = i - ph * strip;
    const int jj = rest / uD;
    const int c = rest - jj * uD;
    const int p = ph / HB;
    const int t = ph - p * HB;
    os[(long long)ph * Mp * uD + rest] = tile[(jj * R + p) * uW + t * uD + c];
  }
}

template <typename U>
int launch(const void* x, void* out, int B, int L, int E, int g, int S, int R,
           int HB, int Dh, int Mp, int es, cudaStream_t stream) {
  const int u = (int)sizeof(U);
  // packed rows per block: the largest power of two <= 16 that divides Mp,
  // fits the shared memory, and leaves about two blocks per SM
  int BT = 16;
  while (BT > 1 && (Mp % BT || (long long)BT * E * es > kSmemBytes ||
                    (long long)B * S * (Mp / BT) < 2 * kSMs))
    BT /= 2;
  if ((long long)BT * E * es > kSmemBytes) return (int)cudaErrorInvalidValue;
  dim3 grid(Mp / BT, S, B);
  pack_phases_kernel<U><<<grid, kThreads, (size_t)BT * E * es, stream>>>(
      static_cast<const unsigned char*>(x), static_cast<unsigned char*>(out),
      L, g, E * es / u, R, HB, Dh * es / u, Mp, BT);
  return (int)cudaGetLastError();
}

// The widest copy unit that divides a head's Dh run (so a band, a row and a
// packed strip too) and both pointers' alignment.
int unit_bytes(int es, int Dh, const void* a, const void* b) {
  for (int u = 16; u > es; u /= 2)
    if ((Dh * es) % u == 0 && (uintptr_t)a % u == 0 && (uintptr_t)b % u == 0)
      return u;
  return es;
}

}  // namespace

extern "C" int gp_pack_phases(const void* x, void* out, int elem_bytes, int B,
                              int L, int E, int g, int S, int R, int HB,
                              int Dh, int Mp, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // every token needs its slot: S segments of g cover L, Mp*r covers g
  if ((elem_bytes != 2 && elem_bytes != 4) || B < 0 || L < 0 || g <= 0 ||
      S <= 0 || R <= 0 || HB <= 0 || Dh <= 0 || Mp <= 0 ||
      (long long)R * HB * Dh != E || (long long)S * g < L ||
      (long long)Mp * R < g || S > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  switch (unit_bytes(elem_bytes, Dh, x, out)) {
    case 16: return launch<uint4>(x, out, B, L, E, g, S, R, HB, Dh, Mp, elem_bytes, st);
    case 8: return launch<uint2>(x, out, B, L, E, g, S, R, HB, Dh, Mp, elem_bytes, st);
    case 4: return launch<uint32_t>(x, out, B, L, E, g, S, R, HB, Dh, Mp, elem_bytes, st);
    default: return launch<uint16_t>(x, out, B, L, E, g, S, R, HB, Dh, Mp, elem_bytes, st);
  }
}
