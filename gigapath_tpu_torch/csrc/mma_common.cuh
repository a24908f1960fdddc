// Device helpers for the kernels that run on the tensor cores through
// mma.sync (q_flash_attention's bf16 kernel, the segment-flash backward's,
// the dilated-branch forward's and backward's and the streaming pair
// backward's bf16 kernels): the bf16 MMA, ldmatrix fragment loads from
// shared memory, bf16 pair packing and scaling, the MUFU exp2, cp.async
// copies whose source may be zero-filled, and the padded 64-row
// shared-memory tile (MmaTile), loaded and stored with contiguous rows or
// rows a pitch apart.
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

// four bf16 pairs (an A or B fragment, or 16 bytes of a tile), each element
// times mul in fp32 and rounded to bf16 again: the Pallas kernels'
// (q * scale * log2(e)).astype(bf16) of a bf16 q
__device__ __forceinline__ void scale_bf16(uint32_t (&x)[4], float mul) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x[i]));
    x[i] = pack_bf16(f.x * mul, f.y * mul);
  }
}

// A 64-row bf16 tile of the tensor-core kernels in shared memory:
// each row's DH elements padded with zeros to DK, a multiple of 16 (the
// depth of one m16n8k16 step), at a pitch of 2*DK + 16 bytes, so the 8 rows
// one ldmatrix reads start in 8 distinct 16-byte bank groups.
template <int DH>
struct MmaTile {
  static_assert(DH % 8 == 0, "rows of whole 16-byte pieces");
  static constexpr int ROWS = 64;
  static constexpr int DK = (DH + 15) / 16 * 16;
  static constexpr int PITCH = 2 * DK + 16;  // bytes
  static constexpr int BYTES = ROWS * PITCH;
  static constexpr int THREADS = 128;

  // Start the copies of rows [0, n) of the tile at src (DH elements a row,
  // 16-byte aligned) into dst; rows [n, 64) and columns [DH, DK) are
  // zero-filled without a read. src must be a valid address even when n
  // <= 0.
  __device__ static void load(unsigned char* dst, const __nv_bfloat16* src, int n) {
    constexpr int CHUNKS = DK / 8;  // 16-byte pieces of a padded row
#pragma unroll
    for (int e = threadIdx.x; e < ROWS * CHUNKS; e += THREADS) {
      const int j = e / CHUNKS, d = 8 * (e - j * CHUNKS);
      const bool ok = j < n && d < DH;
      cp_async16_zfill(dst + j * PITCH + 2 * d, ok ? src + (long long)j * DH + d : src, ok);
    }
  }

  // load with the rows `pitch` elements apart: rows [0, n) of the tile are
  // src + j * pitch (each 16-byte aligned, so pitch % 8 == 0), the rest
  // zero-filled without a read as load's
  __device__ static void load_rows(unsigned char* dst, const __nv_bfloat16* src, long long pitch, int n) {
    constexpr int CHUNKS = DK / 8;  // 16-byte pieces of a padded row
#pragma unroll
    for (int e = threadIdx.x; e < ROWS * CHUNKS; e += THREADS) {
      const int j = e / CHUNKS, d = 8 * (e - j * CHUNKS);
      const bool ok = j < n && d < DH;
      cp_async16_zfill(dst + j * PITCH + 2 * d, ok ? src + j * pitch + d : src, ok);
    }
  }

  // This thread's C fragments of a warp's 16 rows (rows g and g + 8 of
  // 16 * warp, columns 8 t + 2 c of column tile t) times mul, rounded to
  // bf16, into the tile at dst; only the DH real columns.
  template <int NT>
  __device__ static void put(unsigned char* dst, const float (&acc)[NT][4], float mul) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int row = 16 * warp + (lane >> 2), col = 2 * (lane & 3);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      if (8 * t >= DH) continue;
      unsigned char* p = dst + row * PITCH + 2 * (8 * t + col);
      *reinterpret_cast<uint32_t*>(p) = pack_bf16(acc[t][0] * mul, acc[t][1] * mul);
      *reinterpret_cast<uint32_t*>(p + 8 * PITCH) = pack_bf16(acc[t][2] * mul, acc[t][3] * mul);
    }
  }

  // The whole tile at src (padding included), each element times mul and
  // rounded to bf16, into the tile at dst, by the block's threads.
  __device__ static void scaled_copy(unsigned char* dst, const unsigned char* src, float mul) {
    constexpr int CHUNKS = DK / 8;  // 16-byte pieces of a padded row (even)
#pragma unroll
    for (int i = 0; i < ROWS * CHUNKS / THREADS; ++i) {
      const int e = threadIdx.x + i * THREADS;
      const int j = e / CHUNKS, off = j * PITCH + 16 * (e - j * CHUNKS);
      const uint4 x = *reinterpret_cast<const uint4*>(src + off);
      uint32_t w[4] = {x.x, x.y, x.z, x.w};
      scale_bf16(w, mul);
      *reinterpret_cast<uint4*>(dst + off) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }

  // Rows [0, n) of the tile at src to device memory at dst (DH elements a
  // row, 16-byte aligned) as 16-byte stores; with zero, zeros instead.
  __device__ static void store(__nv_bfloat16* dst, const unsigned char* src, int n, bool zero = false) {
    constexpr int CHUNKS = DH / 8;
    const int lim = max(0, min(n, ROWS)) * CHUNKS;
    for (int e = threadIdx.x; e < lim; e += THREADS) {
      const int j = e / CHUNKS, ch = e - j * CHUNKS;
      const uint4 x = zero ? make_uint4(0, 0, 0, 0) : *reinterpret_cast<const uint4*>(src + j * PITCH + 16 * ch);
      *reinterpret_cast<uint4*>(dst + (long long)j * DH + 8 * ch) = x;
    }
  }

  // store with the rows `pitch` elements apart: rows [0, n) of the tile at
  // src to dst + j * pitch (16-byte aligned) as 16-byte stores
  __device__ static void store_rows(__nv_bfloat16* dst, long long pitch, const unsigned char* src, int n) {
    constexpr int CHUNKS = DH / 8;
    const int lim = max(0, min(n, ROWS)) * CHUNKS;
    for (int e = threadIdx.x; e < lim; e += THREADS) {
      const int j = e / CHUNKS, ch = e - j * CHUNKS;
      *reinterpret_cast<uint4*>(dst + j * pitch + 8 * ch) = *reinterpret_cast<const uint4*>(src + j * PITCH + 16 * ch);
    }
  }
};

}  // namespace gp
