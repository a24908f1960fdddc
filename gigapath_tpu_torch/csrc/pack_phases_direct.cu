// Single-segment phase-major pack of one dilated-attention branch, read
// straight off the dense activations: 1 to 3 tensors [B, L, E] of one
// geometry (a branch's q, k and v) -> packed [B, 1, r, hb, Mp, Dh] each, in
// one launch.
//
// Replaces the Pallas kernel gigapath_tpu/ops/pallas_dilated.py:
// _pack_kernel_direct (called by _pack_phases when S == 1, r > 1 and
// pack_direct is set, once per tensor). With one segment covering the
// sequence, dense row j*r + p is packed row j of phase p, and only its
// band-p lanes [p*W, (p+1)*W), W = hb*Dh = E/r, are kept: packed
// (b, 0, p, t, j, d) holds x[b, j*r + p, (p*hb + t)*Dh + d], or an exact 0
// for a row >= L (by logical row index; packed K/V pads must be zeros, or a
// masked probability of 0 times a NaN poisons the PV product). Packed rows
// past the dense extent, up to Mp, are rows >= L too.
//
// Bound on the H100: bytes. The kernel must read the L*E/r band elements of
// each tensor and write its B*Mp*E packed ones, and does no arithmetic: at
// the flagship's r = 4, 8 and 16 (L = 10241, E = 768, bf16) that is 7.9,
// 4.0 and 2.1 MB a tensor, 2.4, 1.2 and 0.6 us at 3.35 TB/s, so a launch a
// tensor pays the launch's fixed cost about as often as it moves bytes.
// Hence one launch per branch: gridDim.z is the tensor.
//
// A unit (16 bytes where Dh's run and every pointer allow it, else the
// widest of 8, 4, 2) of dense row j*r + p, band p, head t maps to one unit
// of the packed strip (p, t) at row j, so a thread copies unit to unit, with
// no shared memory and no barrier. Thread s of the grid's x range owns unit
// position s of every strip (packed row j = s / uD, unit c = s % uD, decoded
// once) and copies it in 8 consecutive (phase, head) strips: it issues the 8
// loads (none for a row >= L, which stores 0) before its 8 stores, so 8
// independent loads are in flight a thread. A warp stores 32 consecutive
// units of one strip (512 contiguous bytes) and loads whole Dh runs of the
// dense rows (96 bytes in bf16 at Dh = 48: three 32-byte sectors). Grid:
// (ceil(Mp*uD / 128), B * ceil(H / 8), tensors). Index math is 32-bit
// within a batch row (the entry checks the bound); the batch offset is
// 64-bit. Elements are copied as raw units, so one kernel serves fp32 and
// bf16.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kMaxTensors = 3;
constexpr int kThreads = 128;
constexpr int kStrips = 8;  // (phase, head) strips a thread copies, loads first

struct Tensors {
  const void* x[kMaxTensors];
  void* out[kMaxTensors];
};

template <typename U>
__global__ void __launch_bounds__(kThreads)
pack_direct_kernel(const Tensors ts, int L, int uE, int R, int HB, int uD,
                   int Mp, int groups) {
  const int s = blockIdx.x * kThreads + threadIdx.x;  // unit position in a strip
  if (s >= Mp * uD) return;
  const int H = R * HB;
  const int b = blockIdx.y / groups;
  const int ph0 = (blockIdx.y - b * groups) * kStrips;  // first strip p*HB + t
  const int z = blockIdx.z;
  const U* __restrict__ x = static_cast<const U*>(z == 0 ? ts.x[0] : z == 1 ? ts.x[1] : ts.x[2]) +
                            (long long)b * L * uE;
  U* __restrict__ out = static_cast<U*>(z == 0 ? ts.out[0] : z == 1 ? ts.out[1] : ts.out[2]) +
                        (long long)b * H * Mp * uD;
  const int j = s / uD;
  const int c = s - j * uD;
  int p = ph0 / HB, t = ph0 - p * HB;
  U v[kStrips];
#pragma unroll
  for (int k = 0; k < kStrips; ++k) {
    const int row = j * R + p;  // dense row of packed row j, phase p
    v[k] = U{};
    if (ph0 + k < H && row < L) v[k] = x[row * uE + (ph0 + k) * uD + c];
    if (++t == HB) {
      t = 0;
      ++p;
    }
  }
#pragma unroll
  for (int k = 0; k < kStrips; ++k)
    if (ph0 + k < H) out[(ph0 + k) * Mp * uD + s] = v[k];
}

template <typename U>
int launch(const Tensors& ts, int n, int B, int L, int E, int R, int HB,
           int Dh, int Mp, int es, cudaStream_t stream) {
  const int u = (int)sizeof(U);
  const int uD = Dh * es / u;
  const int groups = (R * HB + kStrips - 1) / kStrips;
  dim3 grid((unsigned)((Mp * uD + kThreads - 1) / kThreads), (unsigned)(B * groups), (unsigned)n);
  pack_direct_kernel<U><<<grid, kThreads, 0, stream>>>(ts, L, E * es / u, R, HB, uD, Mp, groups);
  return (int)cudaGetLastError();
}

}  // namespace

// The widest copy unit that divides a head's Dh run (so a band, a row and a
// packed strip too) and every pointer's alignment.
static int unit_bytes(int es, int Dh, const Tensors& ts, int n) {
  for (int u = 16; u > es; u /= 2) {
    bool ok = (Dh * es) % u == 0;
    for (int i = 0; i < n; ++i)
      ok = ok && (uintptr_t)ts.x[i] % u == 0 && (uintptr_t)ts.out[i] % u == 0;
    if (ok) return u;
  }
  return es;
}

// xs, outs: n (1 to 3) source and destination pointers of one geometry.
extern "C" int gp_pack_phases_direct(const long long* xs, const long long* outs, int n,
                                     int elem_bytes, int B, int L, int E, int R,
                                     int HB, int Dh, int Mp, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int H = R * HB;
  if (n < 1 || n > kMaxTensors || (elem_bytes != 2 && elem_bytes != 4) || R <= 0 ||
      HB <= 0 || Dh <= 0 || H * Dh != E || Mp <= 0 || (long long)Mp * R < L || B < 0 ||
      (long long)B * ((H + kStrips - 1) / kStrips) > 65535 ||
      (long long)L * E >= (1LL << 31) || (long long)H * Mp * Dh >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  Tensors ts{};
  for (int i = 0; i < n; ++i) {
    ts.x[i] = reinterpret_cast<const void*>(xs[i]);
    ts.out[i] = reinterpret_cast<void*>(outs[i]);
    if ((uintptr_t)ts.x[i] % elem_bytes || (uintptr_t)ts.out[i] % elem_bytes)
      return (int)cudaErrorMisalignedAddress;
  }
  if ((long long)B * L * E == 0) return 0;
  switch (unit_bytes(elem_bytes, Dh, ts, n)) {
    case 16: return launch<uint4>(ts, n, B, L, E, R, HB, Dh, Mp, elem_bytes, st);
    case 8: return launch<uint2>(ts, n, B, L, E, R, HB, Dh, Mp, elem_bytes, st);
    case 4: return launch<uint32_t>(ts, n, B, L, E, R, HB, Dh, Mp, elem_bytes, st);
    default: return launch<uint16_t>(ts, n, B, L, E, R, HB, Dh, Mp, elem_bytes, st);
  }
}
