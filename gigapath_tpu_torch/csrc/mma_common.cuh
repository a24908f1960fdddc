// Device helpers for the kernels that run on the tensor cores through
// mma.sync (q_flash_attention's bf16 kernel, the segment-flash backward's
// bf16 kernels): the bf16 MMA, ldmatrix fragment loads from shared memory,
// bf16 pair packing, the MUFU exp2 and cp.async copies whose source may be
// zero-filled.
//
// Fragments of mma.sync.m16n8k16 (lane = 4 * g + c, g = lane / 4, c =
// lane % 4): the A fragment a[0..3] holds A[g][2c, 2c+1], A[g+8][2c, 2c+1],
// A[g][2c+8, 2c+9], A[g+8][2c+8, 2c+9] as bf16 pairs; the B fragment b0,
// b1 holds B[2c, 2c+1][g] and B[2c+8, 2c+9][g]; the C fragment d[0..3]
// holds D[g][2c, 2c+1] and D[g+8][2c, 2c+1] in fp32. So a C fragment's two
// halves of a 16-column step pack straight into the A fragment of a product
// whose depth is those columns.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace gp {

// a 16-byte copy from device into shared memory; with ok false, 16 zero
// bytes and no read of src (src must still be a valid address)
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

// a 4-byte copy from device into shared memory; with ok false, zeros
__device__ __forceinline__ void cp_async4_zfill(void* dst, const void* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

// D[16 x 8] += A[16 x 16] . B[16 x 8], bf16 in, fp32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8 and receives element pair (l / 4, 2 (l % 4)) of each
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// the same, each matrix transposed: lane l receives elements (2 (l % 4),
// l / 4) and (2 (l % 4) + 1, l / 4) of each
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// 2^x on the MUFU pipe: ex2.approx.ftz, about 2 ulp, a result below 2^-126
// flushed to 0 (exp2f adds range handling around the same instruction)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats rounded to bf16 and packed, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&b);
}

}  // namespace gp
