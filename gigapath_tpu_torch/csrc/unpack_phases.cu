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
// Bound on the H100: bytes. The kernel must read the packed elements of the
// L real rows (L*E/r) and write the dense [B, L, E] once, and does no
// arithmetic. It is the single-segment direct unpack's design
// (unpack_phases_direct.cu) with a segment index: the grid is (Mp / BT, S, B)
// as the pack's, and block (i, s, b) takes packed rows j0 = i*BT .. j0+BT-1
// of every phase of segment s, i.e. the BT*r consecutive in-segment
// positions w = j0*r .. (j0+BT)*r - 1. It loads, from each (phase, head)'s
// contiguous [BT, Dh] strip, the rows that hold a real token (w < g and
// s*g + w < L) into shared memory, in the widest unit (16, 8, 4 or 2 bytes)
// that Dh's run and both pointers allow, then writes those dense rows whole,
// which are contiguous, band lanes from shared memory and zeros elsewhere,
// with vector stores. A block whose first row lies past the segment or the
// sequence returns at once: its rows are pads. Index math per unit is
// 32-bit over the block's own ranges; 64-bit arithmetic appears only in the
// base offsets. Elements are copied as raw units, so one kernel serves fp32
// and bf16.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemBytes = 48 * 1024;
constexpr int kSMs = 132;

template <typename U>
__global__ void unpack_phases_kernel(const unsigned char* __restrict__ p6,
                                     unsigned char* __restrict__ out, int L,
                                     int g, int uE, int R, int HB, int uD,
                                     int Mp, int BT) {
  extern __shared__ __align__(16) unsigned char smem[];
  U* tile = reinterpret_cast<U*>(smem);  // [BT*R rows][uW]: each row's band
  const int uW = HB * uD;
  const int s = blockIdx.y;
  const long long b = blockIdx.z;
  const int j0 = blockIdx.x * BT;
  const int w0 = j0 * R;
  const long long tok0 = (long long)s * g + w0;
  // rows of this block that hold a real token: inside the segment and < L
  long long inside = g - w0 < L - tok0 ? g - w0 : L - tok0;
  if (inside <= 0) return;
  if (inside > BT * R) inside = BT * R;
  const int valid = (int)inside;
  const U* ps = reinterpret_cast<const U*>(p6) +
                ((b * gridDim.y + s) * (long long)R * HB * Mp + j0) * uD;
  U* os = reinterpret_cast<U*>(out) + (b * L + tok0) * (long long)uE;

  // 1. each (phase, head)'s [BT, Dh] strip -> its real rows' band lanes
  const int strip = BT * uD;
  for (int i = threadIdx.x; i < R * HB * strip; i += kThreads) {
    const int ph = i / strip;  // p*HB + t
    const int rest = i - ph * strip;
    const int jj = rest / uD;
    const int c = rest - jj * uD;
    const int p = ph / HB;
    const int t = ph - p * HB;
    const int lr = jj * R + p;
    if (lr < valid) tile[lr * uW + t * uD + c] = ps[(long long)ph * Mp * uD + rest];
  }
  __syncthreads();

  // 2. the real rows, whole and contiguous: band lanes or 0
  for (int i = threadIdx.x; i < valid * uE; i += kThreads) {
    const int lr = i / uE;
    const int c = i - lr * uE;
    const int band = c - (lr % R) * uW;  // lane offset inside the row's band
    U v{};
    if (band >= 0 && band < uW) v = tile[lr * uW + band];
    os[i] = v;
  }
}

template <typename U>
int launch(const void* p6, void* out, int B, int L, int E, int g, int S, int R,
           int HB, int Dh, int Mp, int es, cudaStream_t stream) {
  const int u = (int)sizeof(U);
  int BT = 16;  // as pack_phases.cu, so both walk the same blocks
  while (BT > 1 && (Mp % BT || (long long)BT * E * es > kSmemBytes ||
                    (long long)B * S * (Mp / BT) < 2 * kSMs))
    BT /= 2;
  if ((long long)BT * E * es > kSmemBytes) return (int)cudaErrorInvalidValue;
  dim3 grid(Mp / BT, S, B);
  unpack_phases_kernel<U><<<grid, kThreads, (size_t)BT * E * es, stream>>>(
      static_cast<const unsigned char*>(p6), static_cast<unsigned char*>(out),
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

extern "C" int gp_unpack_phases(const void* p6, void* out, int elem_bytes,
                                int B, int L, int E, int g, int S, int R,
                                int HB, int Dh, int Mp, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // every token has its slot: S segments of g cover L, Mp*r covers g
  if ((elem_bytes != 2 && elem_bytes != 4) || B < 0 || L < 0 || g <= 0 ||
      S <= 0 || R <= 0 || HB <= 0 || Dh <= 0 || Mp <= 0 ||
      (long long)R * HB * Dh != E || (long long)S * g < L ||
      (long long)Mp * R < g || S > 65535 || B > 65535 ||
      (long long)16 * R * E >= (1LL << 31))  // a block's dense units in int
    return (int)cudaErrorInvalidValue;
  if (B == 0 || L == 0) return 0;
  switch (unit_bytes(elem_bytes, Dh, p6, out)) {
    case 16: return launch<uint4>(p6, out, B, L, E, g, S, R, HB, Dh, Mp, elem_bytes, st);
    case 8: return launch<uint2>(p6, out, B, L, E, g, S, R, HB, Dh, Mp, elem_bytes, st);
    case 4: return launch<uint32_t>(p6, out, B, L, E, g, S, R, HB, Dh, Mp, elem_bytes, st);
    default: return launch<uint16_t>(p6, out, B, L, E, g, S, R, HB, Dh, Mp, elem_bytes, st);
  }
}
