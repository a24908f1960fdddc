// Single-segment phase-major unpack of one dilated-attention branch, written
// straight into the dense output: packed [B, 1, r, hb, Mp, Dh] -> [B, L, E].
//
// Replaces the Pallas kernel gigapath_tpu/ops/pallas_dilated.py:
// _unpack_kernel_direct (called by _unpack_phases when S == 1, r > 1 and
// pack_direct is set). Dense row l = j*r + p holds packed row j of phase p on
// its band-p lanes [p*W, (p+1)*W), W = hb*Dh = E/r, and exact zeros on every
// other lane: the branch's cover pattern, which the cross-branch fusion
// weighs 0 through the lse.
//
// Bound on the H100: bytes. The kernel must read the L*E/r packed elements
// of real rows and write the B*L*E dense ones, and does no arithmetic. Each
// block takes BT packed rows of every phase: it loads each (phase, head)'s
// contiguous [BT, Dh] strip with 16-byte vector loads (the widest unit that
// the element size, Dh and the pointers allow) into shared memory, then
// writes its BT*r contiguous dense rows whole, band lanes from shared memory
// and zeros elsewhere, with vector stores. Blocks that would start at or past
// row L are not launched (the JAX grid leaves them out too); the block that
// straddles L writes only rows < L.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemBytes = 48 * 1024;

template <typename U>
__global__ void unpack_direct_kernel(const unsigned char* __restrict__ p6,
                                     unsigned char* __restrict__ out, int L,
                                     int uE, int R, int HB, int uD, int Mp,
                                     int BT) {
  extern __shared__ __align__(16) unsigned char smem[];
  U* tile = reinterpret_cast<U*>(smem);  // [BT*R rows][uW]: each row's band
  const int uW = HB * uD;
  const long long b = blockIdx.y;
  const int j0 = blockIdx.x * BT;
  const U* pb = reinterpret_cast<const U*>(p6) + b * (long long)R * HB * Mp * uD;
  U* ob = reinterpret_cast<U*>(out) + b * L * (long long)uE;

  // 1. each (phase, head)'s [BT, Dh] strip -> its rows' band lanes
  const int strip = BT * uD;
  for (int i = threadIdx.x; i < R * HB * strip; i += blockDim.x) {
    const int ph = i / strip;
    const int rest = i - ph * strip;
    const int jj = rest / uD;
    const int c = rest - jj * uD;
    const int p = ph / HB;
    const int t = ph - p * HB;
    tile[(jj * R + p) * uW + t * uD + c] = pb[((long long)ph * Mp + j0 + jj) * uD + c];
  }
  __syncthreads();

  // 2. dense rows j0*R .. min((j0+BT)*R, L) - 1, whole: band or 0
  const long long row0 = (long long)j0 * R;
  const long long end = row0 + (long long)BT * R < L ? row0 + (long long)BT * R : L;
  const int n = (int)(end - row0) * uE;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int lr = i / uE;
    const int c = i - lr * uE;
    const int band = c - (lr % R) * uW;  // lane offset inside the row's band
    U v{};
    if (band >= 0 && band < uW) v = tile[lr * uW + band];
    ob[(row0 + lr) * uE + c] = v;
  }
}

template <typename U>
int launch(const void* p6, void* out, int B, int L, int E, int R, int HB,
           int Dh, int Mp, int es, cudaStream_t stream) {
  const int u = (int)sizeof(U);
  int BT = 16;  // as pack_phases_direct.cu, so both walk the same blocks
  while (BT > 1 && (Mp % BT || (long long)BT * E * es > kSmemBytes ||
                    (long long)B * (Mp / BT) < 2 * 132))
    BT /= 2;
  if ((long long)BT * E * es > kSmemBytes) return (int)cudaErrorInvalidValue;
  const long long rows_per_block = (long long)BT * R;
  const long long starting_inside = (L + rows_per_block - 1) / rows_per_block;
  const int nb = (int)(Mp / BT < starting_inside ? Mp / BT : starting_inside);
  dim3 grid(nb, B);
  unpack_direct_kernel<U><<<grid, kThreads, (size_t)BT * E * es, stream>>>(
      static_cast<const unsigned char*>(p6), static_cast<unsigned char*>(out),
      L, E * es / u, R, HB, Dh * es / u, Mp, BT);
  return (int)cudaGetLastError();
}

}  // namespace

static int unit_bytes(int es, int Dh, const void* a, const void* b) {
  for (int u = 16; u > es; u /= 2)
    if ((Dh * es) % u == 0 && (uintptr_t)a % u == 0 && (uintptr_t)b % u == 0)
      return u;
  return es;
}

extern "C" int gp_unpack_phases_direct(const void* p6, void* out,
                                       int elem_bytes, int B, int L, int E,
                                       int R, int HB, int Dh, int Mp,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((elem_bytes != 2 && elem_bytes != 4) || R * HB * Dh != E || Mp <= 0 ||
      (long long)Mp * R < L || B > 65535)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * L * E == 0) return 0;
  switch (unit_bytes(elem_bytes, Dh, p6, out)) {
    case 16: return launch<uint4>(p6, out, B, L, E, R, HB, Dh, Mp, elem_bytes, st);
    case 8: return launch<uint2>(p6, out, B, L, E, R, HB, Dh, Mp, elem_bytes, st);
    case 4: return launch<uint32_t>(p6, out, B, L, E, R, HB, Dh, Mp, elem_bytes, st);
    default: return launch<uint16_t>(p6, out, B, L, E, R, HB, Dh, Mp, elem_bytes, st);
  }
}
