// The 3xTF32 arithmetic of the fp32 flash kernels (flash_attention_fp32.cu:
// the forward of K1, K3, K4; flash_attention_bwd_fp32.cu: K1-dKV, K1-dQ):
// every product on the tensor cores as three TF32 products, the tile
// geometry both use (8 warps of 16 resident rows, 64-row streamed tiles),
// the layout TMA's 128-byte swizzle gives an fp32 tile, the split of a
// resident tile, the A fragment of an accumulator, and the host-side tensor
// map of an fp32 (B, H, L, 64) view. The mma.sync products below (`mma`,
// `mma3`, `resident_a`, `product_xt`) are the backward's; the forward runs
// its products on wgmma from the same split.
//
// 3xTF32: with x = x_hi + x_lo, a b ~ a_hi b_hi + a_hi b_lo + a_lo b_hi.
// x_hi is x cut to TF32 (its low 13 mantissa bits cleared, one AND) and
// x_lo = x - x_hi, exact in fp32, passed whole: the tensor cores read a TF32
// operand's top 19 bits, so they cut x_lo to TF32 themselves. Each cut loses
// under 2^-10 of what it cuts, so a product is off by about 2^-20 of |a b|
// (the lo lo term is dropped). mma.sync.m16n8k8.tf32 fragments (thread
// (g, t4) = (lane / 4, lane % 4); wgmma's per-warp A and C are the same):
//   A (16 x 8): registers (g, t4), (g + 8, t4), (g, t4 + 4), (g + 8, t4 + 4);
//   B (8 x 8):  registers (t4, g), (t4 + 4, g);
//   C (16 x 8): registers (g, 2 t4), (g, 2 t4 + 1), (g + 8, 2 t4), (g + 8, 2 t4 + 1).

#pragma once

#include "sm90.cuh"

namespace svc {
namespace tf32x3 {

constexpr int kWarps = 8;                    // 16 resident rows each
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;           // resident rows a block
constexpr int kTile = 64;                    // streamed rows a stage
constexpr int kF32Row = kD * 4;              // 256 B
constexpr int kTileBytes = kTile * kF32Row;  // 16 KB
constexpr int kResBytes = kRows * kF32Row;   // 32 KB

// Byte offset of (row r, dim d) in a tile of `rows` rows as TMA's 128-byte
// swizzle lays it out: dims 0-31 then 32-63, each half 128 bytes a row, the
// 16-byte unit (d / 4) % 8 of row r stored at unit ((d / 4) % 8) ^ (r % 8).
template <int rows>
__device__ __forceinline__ uint32_t sw(int r, int d) {
  return static_cast<uint32_t>(((d >> 5) * rows + r) * 128 + ((((d >> 2) & 7) ^ (r & 7)) << 4) +
                               ((d & 3) << 2));
}

__device__ __forceinline__ float lds(const uint8_t* tile, uint32_t off) {
  return *reinterpret_cast<const float*>(tile + off);
}

// x = hi + lo: hi is x cut to TF32 (10 mantissa bits kept), lo = x - hi
// exactly, which the tensor cores cut to TF32 as they read it.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// An A fragment of m16n8k8 (16 rows x 8 columns): registers (g, t4),
// (g + 8, t4), (g, t4 + 4), (g + 8, t4 + 4), as hi and lo parts.
struct Frag {
  uint32_t hi[4], lo[4];
};

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9},"
      " {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b over one k-step of 8 in 3xTF32, b = (b0, b1) the B fragment
// (rows t4 and t4 + 4, column g) in fp32: the two small terms, then the
// large one.
__device__ __forceinline__ void mma3(float (&d)[4], const Frag& a, float b0, float b1) {
  uint32_t h0, l0, h1, l1;
  split(b0, h0, l0);
  split(b1, h1, l1);
  mma(d, a.lo, h0, h1);
  mma(d, a.hi, l0, l1);
  mma(d, a.hi, h0, h1);
}

// The A fragment of k-step ks (dims 8 ks + {t4, t4 + 4}) of resident rows r
// and r + 8 from the split buffers.
__device__ __forceinline__ Frag resident_a(const uint8_t* hi, const uint8_t* lo, int r, int ks, int t4) {
  const uint32_t off[4] = {sw<kRows>(r, 8 * ks + t4), sw<kRows>(r + 8, 8 * ks + t4),
                           sw<kRows>(r, 8 * ks + t4 + 4), sw<kRows>(r + 8, 8 * ks + t4 + 4)};
  Frag f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f.hi[i] = *reinterpret_cast<const uint32_t*>(hi + off[i]);
    f.lo[i] = *reinterpret_cast<const uint32_t*>(lo + off[i]);
  }
  return f;
}

// The A fragment of an accumulator's 8 columns (2 t4, 2 t4 + 1 in rows g,
// g + 8) as one k-step: k position t4 is column 2 t4, t4 + 4 is 2 t4 + 1.
__device__ __forceinline__ Frag acc_a(const float (&c)[4]) {
  const float a[4] = {c[0], c[2], c[1], c[3]};
  Frag f;
#pragma unroll
  for (int i = 0; i < 4; ++i) split(a[i], f.hi[i], f.lo[i]);
  return f;
}

// acc += X T over the tile's 64 rows, X (16 x 64) held as accumulators
// (k-step j is X's n-tile j), T a streamed tile read along its rows: the
// accumulator's contraction index is permuted (`acc_a`), so B takes rows
// 8 j + 2 t4 and 8 j + 2 t4 + 1. Summed from zero, then added to acc in
// fp32: the tensor cores may round their sums toward zero, a bias that
// would pile up over a long row.
__device__ __forceinline__ void product_xt(float (&acc)[8][4], const float (&x)[8][4], const uint8_t* t, int g,
                                           int t4) {
  float part[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) part[n][i] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const Frag f = acc_a(x[j]);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      mma3(part[n], f, lds(t, sw<kTile>(8 * j + 2 * t4, 8 * n + g)),
           lds(t, sw<kTile>(8 * j + 2 * t4 + 1, 8 * n + g)));
    }
  }
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] += part[n][i];
  }
}

// Split a resident tile in place: hi (of x times mul) over x, lo into `lo`.
// The swizzled layout is kept, since each element stays where it was.
__device__ __forceinline__ void split_resident(uint8_t* x, uint8_t* lo, float mul, int tid) {
  float4* xv = reinterpret_cast<float4*>(x);
  float4* lv = reinterpret_cast<float4*>(lo);
  for (int i = tid; i < kResBytes / 16; i += kThreads) {
    const float4 v = xv[i];
    const float e[4] = {v.x * mul, v.y * mul, v.z * mul, v.w * mul};
    uint32_t h[4], l[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) split(e[c], h[c], l[c]);
    xv[i] = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]),
                        __uint_as_float(h[3]));
    lv[i] = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]),
                        __uint_as_float(l[3]));
  }
}

// The tensor map of an fp32 (B, H, L, 64) view through its element strides
// (the dim stride must be 1): the bf16 map of sm90.cuh over 128 2-byte
// elements a row, boxes of 64 of them (32 fp32, one 128-byte swizzle row)
// by box_rows rows. TMA moves bytes and fills zeros with zero bits, so the
// bf16 map serves fp32.
inline cudaError_t encode_fp32(CUtensorMap* map, const void* base, int B, int H, int L, const long long* es,
                               int box_rows) {
  if (es[3] != 1) return cudaErrorInvalidValue;
  const cuuint64_t dims[4] = {2 * kD, static_cast<cuuint64_t>(L), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t bytes[3] = {static_cast<cuuint64_t>(es[2] * 4), static_cast<cuuint64_t>(es[1] * 4),
                               static_cast<cuuint64_t>(es[0] * 4)};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(box_rows), 1, 1};
  return sm90::encode_4d(map, base, dims, bytes, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace tf32x3
}  // namespace svc
