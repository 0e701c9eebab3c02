// Tile helpers of K1's backward kernels (K1-dKV, K1-dQ): head dim 64, bf16
// operands, 64-row tiles in shared memory padded to 72 elements a row so
// that fragment loads hit 32 distinct banks, and the mma.sync.m16n8k16
// bf16 -> fp32 tensor-core product; also the constants and the bf16 packing
// that the Hopper forward tile (flash_fwd_sm90.cuh) shares, and the error
// string every library exports.
//
// Fragment layouts of m16n8k16 (g = lane / 4, t4 = lane % 4):
//   A (16x16, row major): a0 = (g, 2t4..+1), a1 = (g+8, 2t4..+1),
//                         a2 = (g, 2t4+8..+9), a3 = (g+8, 2t4+8..+9)
//   B (16x8, k x n):      b0 = (k 2t4..+1, n g), b1 = (k 2t4+8..+9, n g)
//   C (16x8):             c0,c1 = (g, 2t4..+1), c2,c3 = (g+8, 2t4..+1)
// so the C fragments of n-tiles 2kk and 2kk+1 are exactly the A fragment of
// k-step kk of a following product (`acc_to_a`).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace svc {

constexpr int kD = 64;        // head dim
constexpr int kTile = 64;     // rows (queries or keys) per tile
constexpr int kLds = kD + 8;  // padded shared-memory row (bf16 elements)
constexpr int kThreads = 128; // 4 warps x 16 rows

__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* smem) {
  unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Stage rows [row0, row0 + 64) of a (L, 64) slab into shared memory, zero
// filling rows >= L. 512 16-byte chunks, 4 per thread.
__device__ __forceinline__ void load_tile(__nv_bfloat16 (*dst)[kLds],
                                          const __nv_bfloat16* src,
                                          long long row_stride, int row0, int L) {
#pragma unroll
  for (int c = threadIdx.x; c < kTile * (kD / 8); c += kThreads) {
    const int r = c >> 3;
    const int col = (c & 7) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < L) {
      v = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * row_stride + col);
    }
    *reinterpret_cast<uint4*>(&dst[r][col]) = v;
  }
}

// A fragments of the 16 rows [r0, r0 + 16) of a shared tile, 4 k-steps over
// the head dim.
__device__ __forceinline__ void load_a_rows(uint32_t a[4][4], const __nv_bfloat16 (*s)[kLds],
                                            int r0, int t4) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const int c = ks * 16 + t4 * 2;
    a[ks][0] = lds32(&s[r0][c]);
    a[ks][1] = lds32(&s[r0 + 8][c]);
    a[ks][2] = lds32(&s[r0][c + 8]);
    a[ks][3] = lds32(&s[r0 + 8][c + 8]);
  }
}

// acc (16 rows x 64 cols) = A (16 x 64, register fragments) . X^T, where X is
// a shared (64 rows, 64) tile: column n of the product is row n of X.
__device__ __forceinline__ void mma_a_xt(float acc[8][4], const uint32_t a[4][4],
                                         const __nv_bfloat16 (*x)[kLds], int g, int t4) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    const int row = n * 8 + g;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const int c = ks * 16 + t4 * 2;
      mma_bf16_16816(acc[n], a[ks], lds32(&x[row][c]), lds32(&x[row][c + 8]));
    }
  }
}

// The A fragment of k-step kk from fp32 C fragments (rounded to bf16).
__device__ __forceinline__ void acc_to_a(uint32_t a[4], const float (*c)[4], int kk) {
  a[0] = pack_bf16x2(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16x2(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16x2(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16x2(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// out (16 rows x 64) += C (16 x 64, fp32 C fragments, rounded to bf16) . Y,
// where Y is a shared (64 rows, 64) tile: the k dimension runs over Y's rows
// and Y's B operand comes from ldmatrix.trans.
__device__ __forceinline__ void mma_c_y(float out[8][4], const float (*c)[4],
                                        const __nv_bfloat16 (*y)[kLds], int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    acc_to_a(a, c, kk);
#pragma unroll
    for (int n = 0; n < 8; n += 2) {
      // matrices: (rows +0..7, cols n), (rows +8..15, cols n),
      //           (rows +0..7, cols n+1), (rows +8..15, cols n+1)
      const int mi = lane >> 3;
      const int row = kk * 16 + (mi & 1) * 8 + (lane & 7);
      const int col = (n + (mi >> 1)) * 8;
      uint32_t b4[4];
      ldmatrix_x4_trans(b4, &y[row][col]);
      mma_bf16_16816(out[n], a, b4[0], b4[1]);
      mma_bf16_16816(out[n + 1], a, b4[2], b4[3]);
    }
  }
}

// Store 16 rows x 64 of fp32 C fragments, times `scale`, as bf16 rows of a
// (L, 64) slab; rows >= L are not stored.
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, long long row_stride,
                                           const float (*c)[4], int row0, int L,
                                           float scale, int t4) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int d = n * 8 + t4 * 2;
    if (row0 < L) {
      *reinterpret_cast<__nv_bfloat162*>(dst + row0 * row_stride + d) =
          __floats2bfloat162_rn(c[n][0] * scale, c[n][1] * scale);
    }
    if (row0 + 8 < L) {
      *reinterpret_cast<__nv_bfloat162*>(dst + (row0 + 8) * row_stride + d) =
          __floats2bfloat162_rn(c[n][2] * scale, c[n][3] * scale);
    }
  }
}

}  // namespace svc

extern "C" const char* svc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
