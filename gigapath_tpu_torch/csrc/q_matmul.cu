// Quantized-weight matmul with the quantized linear's epilogue:
//   y[m, n] = cast(scale[n] * sum_k bf16(x[m, k]) * w[n, k] + bias[n]).
//
// Replaces the Pallas kernel gigapath_tpu/quant/qmatmul.py:_q_matmul_kernel
// (called by q_matmul_pallas) and the bias add and cast that QuantDense
// applies to its output. x is bf16 [M, K] row-major; w is the nn.Linear
// weight [N, K] (K contiguous) quantized to int8 or fp8-e4m3
// (__nv_fp8_e4m3, the OCP e4m3fn format of torch.float8_e4m3fn); scale and
// the optional bias are fp32 [N]; y is bf16 or fp32 [M, N]. K is a multiple
// of 16 (the wrapper zero-pads it).
//
// Numerics follow the Pallas kernel: each weight is widened to bf16 exactly
// (int8 magnitudes <= 127 and every e4m3 value fit bf16's significand and
// exponent), the bf16 products are summed in fp32 by the tensor cores, and
// the epilogue takes two roundings, as torch and XLA do: fp32
// acc * scale, then fp32 + bias (__fmul_rn and __fadd_rn, which nvcc does
// not contract into one FMA), then one round-to-nearest-even cast. The
// kernel differs from its plain version only in the order of the sums.
//
// Bound on the H100: operations, 2*M*N*K at the 989 TFLOP/s bf16
// tensor-core rate (at the flagship's M = 25216 and K >= 1536, hundreds of
// operations per byte moved). The design computes the transposed product
// y^T = W x^T on Hopper's warpgroup MMA (wgmma.m64n256k16, bf16 in, fp32
// sums), so the narrow weight is the A operand, which wgmma reads from
// registers:
// - a block owns 128 output channels x 256 tokens; one producer warp keeps
//   TMA loads of the x tile (256 x 64 bf16, 128-byte swizzle, read by wgmma
//   through a shared-memory descriptor) and of the weight tile (128 x 64
//   bytes, 64-byte swizzle) in flight into a ring of 4 stages tracked by
//   mbarriers; out-of-bounds rows and columns arrive as zeros;
// - two consumer warpgroups of 64 channels each load their weight bytes
//   from shared memory straight into wgmma's A-fragment layout (conflict
//   free through the swizzle), widen them to bf16 pairs in registers, and
//   issue four wgmmas per stage into 128 fp32 accumulators per thread; two
//   register sets let a warpgroup widen stage k + 1 while stage k's group
//   runs, and the two warpgroups overlap each other;
// - the epilogue applies scale and bias per channel (a row of the
//   transposed accumulator), casts, stages the tile transposed in shared
//   memory and writes y row-major in 16-byte pieces; only the M and N
//   edges are masked (scalar stores where a row is ragged).

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through the runtime
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BM = 128;                      // output channels per block
constexpr int BN = 256;                      // tokens per block (the wgmma N)
constexpr int BK = 64;                       // k per stage
constexpr int STAGES = 4;                    // ring depth
constexpr int CONSUMERS = 256;               // two warpgroups of 64 channels
constexpr int THREADS = CONSUMERS + 128;     // and one producer warpgroup
constexpr int X_STAGE = BN * BK * 2;         // bytes of one x tile
constexpr int W_STAGE = BM * BK;             // bytes of one weight tile
constexpr int STAGE_BYTES = X_STAGE + W_STAGE;
constexpr int RING = STAGES * STAGE_BYTES;
constexpr int SMEM = RING + 2 * STAGES * 8 + 1024;  // ring, barriers, 1024-byte alignment slack

// epilogue staging: [BN tokens][BM channels] in the output type, each row
// padded so the transposed writes of a quad land in distinct banks
template <typename TO>
struct Stage;
template <>
struct Stage<__nv_bfloat16> {
  static constexpr int PITCH = BM + 8;  // 272-byte rows
};
template <>
struct Stage<float> {
  static constexpr int PITCH = BM + 4;  // 528-byte rows
};
static_assert(BN * Stage<float>::PITCH * 4 <= RING, "the fp32 staging tile reuses the ring");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// wait until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// a 2-d TMA load of the box at (c0 inner, c1 outer) into shared memory,
// completing on the barrier's transaction count
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
// wait until at most N of this warpgroup's wgmma groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// shared-memory matrix descriptor of a K-major tile with the 128-byte
// swizzle: 8-row groups 1024 bytes apart (SBO), the leading offset unused
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// D[64 x 256] += A[64 x 16] (registers, bf16) * B[16 x 256] (shared, K-major)
__device__ __forceinline__ void wgmma_m64n256k16_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// two weight bytes (the low half of word >> shift) widened to a bf16 pair,
// the lower k in the low half: exact for int8 and for e4m3
template <bool FP8>
__device__ __forceinline__ uint32_t widen_pair(uint32_t word, int shift) {
  const uint32_t pair = (word >> shift) & 0xffffu;
  __nv_bfloat162 b;
  if constexpr (FP8) {
    const __half2 h(__nv_cvt_fp8x2_to_halfraw2(static_cast<__nv_fp8x2_storage_t>(pair), __NV_E4M3));
    b = __float22bfloat162_rn(__half22float2(h));
  } else {
    // x + 128 in the low mantissa bits of 2^23, less 2^23 + 128: the exact
    // float of x with full-rate integer and fp32 adds (no I2F)
    const uint32_t u = pair ^ 0x8080u;
    b = __floats2bfloat162_rn(__uint_as_float(0x4B000000u | (u & 0xffu)) - 8388736.f,
                              __uint_as_float(0x4B000000u | (u >> 8)) - 8388736.f);
  }
  return *reinterpret_cast<uint32_t*>(&b);
}

// this thread's A fragments of one stage: its weight rows r and r + 8 (a0/a2
// and a1/a3), k 2c, 2c + 1 (a0, a1) and 2c + 8, 2c + 9 (a2, a3) of each
// 16-deep step j: the words at byte `word` = 4 * (c >> 1) and word + 8 of
// the step's 16-byte chunk, half c & 1 (`shift`) of each; the 64-byte
// swizzle puts chunk j of row r at chunk j ^ sw, sw = (r >> 1) & 3, the
// same for r + 8
template <bool FP8>
__device__ __forceinline__ void load_a(uint32_t (&a)[4][4], const uint8_t* wt, int r, int sw, int word,
                                       int shift) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int o = ((j ^ sw) << 4) + word;
    const uint32_t lo0 = *reinterpret_cast<const uint32_t*>(wt + r * BK + o);
    const uint32_t hi0 = *reinterpret_cast<const uint32_t*>(wt + r * BK + o + 8);
    const uint32_t lo1 = *reinterpret_cast<const uint32_t*>(wt + (r + 8) * BK + o);
    const uint32_t hi1 = *reinterpret_cast<const uint32_t*>(wt + (r + 8) * BK + o + 8);
    a[j][0] = widen_pair<FP8>(lo0, shift);
    a[j][1] = widen_pair<FP8>(lo1, shift);
    a[j][2] = widen_pair<FP8>(hi0, shift);
    a[j][3] = widen_pair<FP8>(hi1, shift);
  }
}

// one stage's four 16-deep MMAs against the x tile at xs, as one wgmma group
__device__ __forceinline__ void issue_stage(float (&acc)[128], const uint32_t (&a)[4][4], uint32_t xs) {
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < 4; ++j) wgmma_m64n256k16_rs(acc, a[j], desc_sw128(xs + 32 * j));
  wgmma_commit();
}

// the A registers stay live (unwritten) until the group that reads them is
// done: called after the wait that covers it
__device__ __forceinline__ void keep_alive(const uint32_t (&a)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) asm volatile("" ::"r"(a[j][0]), "r"(a[j][1]), "r"(a[j][2]), "r"(a[j][3]) : "memory");
}

__device__ __forceinline__ float epilogue(float acc, float s, float b, bool has_bias) {
  const float v = __fmul_rn(acc, s);
  return has_bias ? __fadd_rn(v, b) : v;
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <bool FP8, typename TO>
__global__ void __launch_bounds__(THREADS, 1)
    q_matmul_kernel(const __grid_constant__ CUtensorMap tmap_x, const __grid_constant__ CUtensorMap tmap_w,
                    const float* __restrict__ scale, const float* __restrict__ bias, TO* __restrict__ y, int M,
                    int N, int nk, int n_tiles) {
  extern __shared__ uint8_t smem_raw[];
  // the ring starts on a 1024-byte boundary: the swizzle patterns repeat there
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t ring_u32 = smem_u32(ring);
  const uint32_t full = ring_u32 + RING;       // STAGES barriers: the stage's tiles landed
  const uint32_t empty = full + 8 * STAGES;    // STAGES barriers: the consumers released it

  const int tile = blockIdx.x;
  const int n0 = (tile % n_tiles) * BM;
  const int m0 = (tile / n_tiles) * BN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == CONSUMERS) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) mbar_wait(empty + 8 * s, ((kt / STAGES) - 1) & 1);
        const uint32_t dst = ring_u32 + s * STAGE_BYTES;
        mbar_expect_tx(full + 8 * s, STAGE_BYTES);
        tma_load_2d(dst, &tmap_x, kt * BK, m0, full + 8 * s);
        tma_load_2d(dst + X_STAGE, &tmap_w, kt * BK, n0, full + 8 * s);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane >> 2, c = lane & 3;
    // this thread's weight rows (channels) r and r + 8 of the block's 128
    // (see load_a)
    const int r = 64 * wg + 16 * warp + g;
    const int sw = (r >> 1) & 3;
    const int shift = 16 * (c & 1);
    const int word = 4 * (c >> 1);

    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;

    // stage kt: wait for its tiles, widen its weight bytes into A fragments
    auto load = [&](uint32_t(&a)[4][4], int kt) {
      mbar_wait(full + 8 * (kt % STAGES), (kt / STAGES) & 1);
      load_a<FP8>(a, ring + (kt % STAGES) * STAGE_BYTES + X_STAGE, r, sw, word, shift);
    };
    auto issue = [&](const uint32_t(&a)[4][4], int kt) {
      issue_stage(acc, a, ring_u32 + (kt % STAGES) * STAGE_BYTES);
    };
    auto release = [&](const uint32_t(&a)[4][4], int kt) {
      keep_alive(a);
      mbar_arrive(empty + 8 * (kt % STAGES));
    };

    // two register sets: stage kt + 1 is widened while stage kt's group
    // runs, and a group is waited for only once the next one is issued
    uint32_t a0[4][4], a1[4][4];
    load(a0, 0);
    for (int kt = 0;;) {
      issue(a0, kt);
      if (kt > 0) {
        wgmma_wait<1>();
        release(a1, kt - 1);
      }
      if (++kt == nk) break;
      load(a1, kt);
      issue(a1, kt);
      wgmma_wait<1>();
      release(a0, kt - 1);
      if (++kt == nk) break;
      load(a0, kt);
    }
    wgmma_wait<0>();
    keep_alive(a0);  // the last group read one of the two sets
    release(a1, nk - 1);
#pragma unroll
    for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(acc[i])::"memory");

    // epilogue: every consumer has finished reading the ring
    asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
    constexpr int P = Stage<TO>::PITCH;
    TO* stg = reinterpret_cast<TO*>(ring);
    const bool has_bias = bias != nullptr;
    const int ch0 = n0 + r, ch1 = ch0 + 8;
    const float s0 = ch0 < N ? scale[ch0] : 0.f, s1 = ch1 < N ? scale[ch1] : 0.f;
    const float b0 = has_bias && ch0 < N ? bias[ch0] : 0.f, b1 = has_bias && ch1 < N ? bias[ch1] : 0.f;
    // accumulator i of this thread: channel r (+ 8 for i % 4 >= 2), token
    // 8 * (i / 4) + 2c (+ 1 for odd i)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int t = 8 * i + 2 * c;
      put(stg + t * P + r, epilogue(acc[4 * i], s0, b0, has_bias));
      put(stg + (t + 1) * P + r, epilogue(acc[4 * i + 1], s0, b0, has_bias));
      put(stg + t * P + r + 8, epilogue(acc[4 * i + 2], s1, b1, has_bias));
      put(stg + (t + 1) * P + r + 8, epilogue(acc[4 * i + 3], s1, b1, has_bias));
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
    // coalesced store: 16-byte pieces of each token's row of channels
    constexpr int VE = 16 / (int)sizeof(TO);
    constexpr int CPR = BM / VE;
    const bool vec = N % VE == 0 && (reinterpret_cast<uintptr_t>(y) & 15) == 0;
    for (int q = threadIdx.x; q < BN * CPR; q += CONSUMERS) {
      const int row = q / CPR, ch = (q % CPR) * VE;
      const int m = m0 + row, n = n0 + ch;
      if (m >= M) break;  // rows only grow with q
      if (n >= N) continue;
      TO* dst = y + (long long)m * N + n;
      const TO* src = stg + row * P + ch;
      if (vec && n + VE <= N) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int e = 0; e < VE && n + e < N; ++e) dst[e] = src[e];
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point (no link
// against libcuda)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t rc =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (rc != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a row-major [rows, cols] map read in boxes of [box_rows, box_cols]
bool encode(EncodeTiled fn, CUtensorMap* map, CUtensorMapDataType type, int elem, const void* base, int rows,
            int cols, int box_rows, int box_cols, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool FP8, typename TO>
int launch(const CUtensorMap& mx, const CUtensorMap& mw, const float* scale, const float* bias, void* y, int M,
           int N, int K, cudaStream_t stream) {
  auto kernel = q_matmul_kernel<FP8, TO>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (rc != cudaSuccess) return (int)rc;
    configured = true;
  }
  const int n_tiles = (N + BM - 1) / BM;
  const long long tiles = (long long)n_tiles * ((M + BN - 1) / BN);
  kernel<<<(unsigned)tiles, THREADS, SMEM, stream>>>(mx, mw, scale, bias, static_cast<TO*>(y), M, N,
                                                     (K + BK - 1) / BK, n_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// x: bf16 [M, K]; w: int8 (is_fp8 = 0) or fp8-e4m3 (is_fp8 = 1) bytes
// [N, K]; scale: fp32 [N]; bias: fp32 [N] or null; y: [M, N] in bf16
// (out_bf16 = 1) or fp32; all contiguous; x and w 16-byte aligned, K a
// multiple of 16, y 4-byte aligned (16-byte aligned rows take vector stores).
extern "C" int gp_q_matmul(const void* x, const void* w, const float* scale, const float* bias, void* y, int M,
                           int N, int K, int is_fp8, int out_bf16, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 != 0 ||
      (long long)((N + BM - 1) / BM) * ((M + BN - 1) / BN) > 0x7fffffffLL ||
      (reinterpret_cast<uintptr_t>(x) & 15) != 0 || (reinterpret_cast<uintptr_t>(w) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap mx, mw;
  if (!encode(fn, &mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, M, K, BN, BK, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode(fn, &mw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w, N, K, BM, BK, CU_TENSOR_MAP_SWIZZLE_64B))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_fp8)
    return out_bf16 ? launch<true, __nv_bfloat16>(mx, mw, scale, bias, y, M, N, K, st)
                    : launch<true, float>(mx, mw, scale, bias, y, M, N, K, st);
  return out_bf16 ? launch<false, __nv_bfloat16>(mx, mw, scale, bias, y, M, N, K, st)
                  : launch<false, float>(mx, mw, scale, bias, y, M, N, K, st);
}
