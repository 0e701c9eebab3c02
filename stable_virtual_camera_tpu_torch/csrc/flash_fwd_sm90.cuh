// The Hopper forward tile shared by K1 (flash_attention.cu), K3
// (flash_attention_blhd.cu) and K4 (flash_attention_packed.cu): non-causal
// attention o = softmax(q k^T * scale) v, head dim 64, bf16 in and out, fp32
// online softmax with exp2 (the scale folded into log2(e)), P rounded to bf16
// only as the P V operand, keys >= L masked, rows >= L not stored, and (K1
// under grad) each row's natural-log log-sum-exp for flash_attention_bwd.cu.
//
// What bounds it on an H100: the arithmetic (4 L^2 64 FLOP per (batch,
// head) against 4 L 64 bf16 values moved), so the design follows what
// Hopper offers for a product-bound loop:
//   * one block = 4 warpgroups and 192 query rows. Warpgroup 0 is the
//     producer: one thread issues every load with TMA, and `setmaxnreg.dec`
//     hands its registers to the three consumer warpgroups
//     (`setmaxnreg.inc`), which own 64 query rows each. With one block an
//     SM, three consumers keep the tensor cores busy while the others run
//     their softmax (the exp2 of a 64 x 128 score tile takes about as long
//     on the SM's 16 exp units as its two products on the tensor cores);
//   * K and V tiles of 128 keys sit in a ring of kStages stages. K and V have
//     a "full" mbarrier each per stage (S = Q K^T starts as soon as K lands),
//     and the consumers release a stage by arriving on its "empty" barrier;
//     the producer refills it while they work on the others;
//   * TMA reads every operand through one 4-D tensor map, dims {64, L, H, B}
//     with byte strides {row, head, batch} (ops/flash_upstream.py::
//     tma_dims_strides), box {64, rows, 1, 1}, 128-byte swizzle (a 64-wide
//     bf16 row is exactly 128 B) and zero fill out of bounds. The three
//     layouts differ only in those strides, and a box that runs past L reads
//     zeros, not the next head's rows;
//   * S = Q K^T is wgmma m64n128k16 with both operands K-major in shared
//     memory (4 k-steps over d); O += P V is wgmma m64n64k16 with P from
//     registers and V MN-major in shared memory (8 k-steps over the keys).
//     The wgmma accumulator gives each warp 16 rows and each thread rows g,
//     g+8 at columns 8j + 2 t4 (+1), the m16n8k16 C fragment, so S's
//     registers pack straight into P's A fragments;
//   * TMA's zero fill scores masked keys 0, not -inf, so the last key tile
//     masks keys >= L itself.
// Two consumers with FA3's softmax overlap and ping-pong, and exp2 from a
// polynomial on the FMA pipe, measured no faster than three plain consumers
// (PERF.md); the overlap needs more registers than three consumers leave.
// Left for later: persistent blocks, a TMA store of o, and fp8.

#pragma once

#include <cuda.h>

#include "flash_common.cuh"

namespace svc {
namespace sm90 {

// Tuned on the card (PERF.md: 3 consumers and 3 stages were the fastest at
// every render shape).
constexpr int kConsumers = 3;                    // consumer warpgroups, 64 query rows each
constexpr int kBlockM = 64 * kConsumers;         // query rows per block
constexpr int kBlockN = 128;                     // keys per K/V tile
constexpr int kStages = 3;                       // K/V ring depth
constexpr int kThreads = 128 * (kConsumers + 1); // + the producer warpgroup
constexpr int kRowBytes = kD * 2;                // one bf16 row of 64 = 128 B
constexpr int kQBoxRows = 64;                    // Q loads as one box per consumer
constexpr int kQBytes = kBlockM * kRowBytes;
constexpr int kKVBytes = kBlockN * kRowBytes;
constexpr int kBarriers = 1 + 3 * kStages;       // Q full; K full, V full, empty per stage
// tiles start 1024-byte aligned (the 128-byte swizzle repeats every 8 rows)
constexpr int kSmemBytes = 1024 + kQBytes + 2 * kStages * kKVBytes + 8 * kBarriers;
// registers a thread: the producer gives up what the consumers take
// (65536 a block at most)
constexpr int kProducerRegs = 32;
constexpr int kConsumerRegs = 160;
static_assert(128 * (kProducerRegs + kConsumers * kConsumerRegs) <= 65536, "register budget");

// Where a block writes: o through (batch, head, row) element strides with a
// contiguous head dim, and the fp32 (B, H, L) log-sum-exp or null.
struct FwdOut {
  __nv_bfloat16* o;
  long long osb, osh, osl;
  float* lse;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of `bar` with this parity has completed. A wait that
// polls 2^26 times (far longer than any load or tile takes) traps, so a
// broken ring faults with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One box of a 4-D tensor map into shared memory; completion (the box's
// full byte count, zero-filled parts included) is reported to `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap& map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A wgmma shared-memory descriptor for a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (in 16-byte units), layout 1 =
// SWIZZLE_128B. K-major tiles ignore the leading offset; the stride offset
// is the step between 8-row groups (8 x 128 B).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving accesses of accumulator registers across an
// asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d (64 x 128, fp32) = (scale_d ? d : 0) + A . B^T with A (64 x 16) and B
// (128 x 16) both K-major in shared memory (descriptors).
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t desc_a,
                                                    uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 64, fp32) += A . B with A (64 x 16 bf16) in registers (the
// m16n8k16 A fragment per warp) and B (16 x 64) MN-major in shared memory.
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// One consumer's online softmax over a 64 x 128 score tile in registers
// (s[4j + e]: row g, key k0 + 8j + 2 t4 + e; s[4j + 2 + e]: row g + 8):
// masks keys >= L, updates the running max m (scaled log2 domain) and the
// partial row sums l, turns s into exp2(s scale_log2 - m), and returns the
// factors corr that rescale the rows' earlier accumulators.
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], int k0, int L, int t4,
                                             float scale_log2) {
  if (k0 + kBlockN > L) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (k0 + 8 * j + 2 * t4 + e >= L) {
          s[4 * j + e] = -INFINITY;
          s[4 * j + 2 + e] = -INFINITY;
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 16; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    // every tile holds at least one valid key, so the new max is finite
    const float mn = fmaxf(m[r], mx * scale_log2);
    corr[r] = ex2(m[r] - mn);
    m[r] = mn;
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x = fmaf(s[4 * j + 2 * r + e], scale_log2, -mn);
        s[4 * j + 2 * r + e] = ex2(x);
      }
      rs += s[4 * j + 2 * r] + s[4 * j + 2 * r + 1];
    }
    l[r] = l[r] * corr[r] + rs;
  }
}

// P as the A fragments of 8 k-steps of 16 keys: k-step kk is the S columns
// of n-tiles 2kk and 2kk + 1, rounded to bf16.
__device__ __forceinline__ void pack_p(uint32_t (&p)[8][4], const float (&s)[64]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) p[kk][i] = pack_bf16x2(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
  }
}

__device__ __forceinline__ void rescale(float (&acc)[32], const float (&corr)[2]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    acc[4 * j] *= corr[0];
    acc[4 * j + 1] *= corr[0];
    acc[4 * j + 2] *= corr[1];
    acc[4 * j + 3] *= corr[1];
  }
}

// Issue S = Q K^T: 64 rows x 128 keys, 4 k-steps of 16 over the head dim
// (+32 B along a swizzled 128-byte row).
__device__ __forceinline__ void issue_qk(float (&s)[64], uint64_t desc_q, uint64_t desc_k) {
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) wgmma_m64n128k16_ss(s, desc_q + 2 * ks, desc_k + 2 * ks, ks > 0);
  wgmma_commit();
}

// Issue O += P V: V (128 keys x 64) is MN-major for this product; a k-step
// of 16 keys is 2 swizzle groups (2 KB) further on.
__device__ __forceinline__ void issue_pv(float (&acc)[32], const uint32_t (&p)[8][4],
                                         uint64_t desc_v) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) wgmma_m64n64k16_rs(acc, p[kk], desc_v + kk * (16 * kRowBytes >> 4));
  wgmma_commit();
}

// The tile: rows [q0, q0 + kBlockM) of (batch b, head h). Called by each
// wrapper kernel with its own block-to-(b, h, q0) map.
__device__ __forceinline__ void flash_fwd_sm90(const CUtensorMap& map_q, const CUtensorMap& map_k,
                                               const CUtensorMap& map_v, const FwdOut& out,
                                               int b, int h, int q0, int H, int L,
                                               float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sK = sQ + kQBytes;
  const uint32_t sV = sK + kStages * kKVBytes;
  const uint32_t bar_q = sV + kStages * kKVBytes;
  const uint32_t bar_k = bar_q + 8;                // + 8 s
  const uint32_t bar_v = bar_k + 8 * kStages;      // + 8 s
  const uint32_t bar_empty = bar_v + 8 * kStages;  // + 8 s
  const int n_tiles = (L + kBlockN - 1) / kBlockN;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, kQBytes);
#pragma unroll
      for (int c = 0; c < kConsumers; ++c) {
        tma_load_4d(sQ + c * kQBoxRows * kRowBytes, map_q, bar_q, 0, q0 + c * kQBoxRows, h, b);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        // the first round finds every stage free (parity of the phase
        // before the first)
        mbar_wait(bar_empty + 8 * s, ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(bar_k + 8 * s, kKVBytes);
        tma_load_4d(sK + s * kKVBytes, map_k, bar_k + 8 * s, 0, t * kBlockN, h, b);
        mbar_expect_tx(bar_v + 8 * s, kKVBytes);
        tma_load_4d(sV + s * kKVBytes, map_v, bar_v + 8 * s, 0, t * kBlockN, h, b);
      }
    }
    return;
  }

  // consumer warpgroup c: query rows [q0 + 64 c, q0 + 64 c + 64)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int c = wg - 1;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const uint64_t desc_q = sw128_desc(sQ + c * kQBoxRows * kRowBytes, 16, 8 * kRowBytes);
  auto desc_k = [&](int st) { return sw128_desc(sK + st * kKVBytes, 16, 8 * kRowBytes); };
  auto desc_v = [&](int st) { return sw128_desc(sV + st * kKVBytes, kKVBytes, 8 * kRowBytes); };

  float acc[32], s[64];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = 0.f;
  // running max (scaled log2 domain) and per-thread partial row sums of the
  // thread's rows g and g + 8
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, corr[2];
  uint32_t p[8][4];

  mbar_wait(bar_q, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kStages;
    const uint32_t parity = (t / kStages) & 1;
    mbar_wait(bar_k + 8 * st, parity);
    issue_qk(s, desc_q, desc_k(st));
    wgmma_wait_all();
    fence_regs(s);
    softmax_tile(s, m, l, corr, t * kBlockN, L, t4, scale_log2);
    rescale(acc, corr);
    pack_p(p, s);
    mbar_wait(bar_v + 8 * st, parity);
    issue_pv(acc, p, desc_v(st));
    wgmma_wait_all();
    fence_regs(acc);
    mbar_arrive(bar_empty + 8 * st);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const int row0 = q0 + c * 64 + warp * 16 + g;
  if (out.lse != nullptr && t4 == 0) {
    // natural-log units: ln(2^m l) with m in the scaled base-2 domain
    constexpr float kLn2 = 0.6931471805599453f;
    float* lse = out.lse + ((long long)b * H + h) * L;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row0 + 8 * r < L) lse[row0 + 8 * r] = m[r] * kLn2 + logf(l[r]);
    }
  }
  __nv_bfloat16* o = out.o + b * out.osb + h * out.osh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const float inv = 1.f / l[r];
    if (row < L) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(o + row * out.osl + 8 * j + 2 * t4) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
      }
    }
  }
}

// Host side: the tensor map of one operand, dims {64, L, H, B}, byte strides
// {row, head, batch}, box {64, box_rows, 1, 1}. cuTensorMapEncodeTiled is a
// driver function; it is looked up through the runtime, so the library
// needs no -lcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline cudaError_t encode_map(CUtensorMap* map, const void* base, int B, int H, int L,
                              const long long strides[3], int box_rows) {
  static EncodeTiledFn encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                                              &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiledFn>(fn);
  }
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(kD), static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t bytes[3] = {static_cast<cuuint64_t>(strides[0]),
                               static_cast<cuuint64_t>(strides[1]),
                               static_cast<cuuint64_t>(strides[2])};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kD), static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                            bytes, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Encode q, k and v's maps and launch `kernel` on `grid`. strides: the byte
// strides {row, head, batch} of q, then k, then v.
template <class Kernel>
inline int launch_fwd(Kernel kernel, dim3 grid, const void* q, const void* k, const void* v,
                      const FwdOut& out, int B, int H, int L, const long long strides[9],
                      float scale_log2, void* stream) {
  CUtensorMap map_q, map_k, map_v;
  cudaError_t err = encode_map(&map_q, q, B, H, L, strides, kQBoxRows);
  if (err == cudaSuccess) err = encode_map(&map_k, k, B, H, L, strides + 3, kBlockN);
  if (err == cudaSuccess) err = encode_map(&map_v, v, B, H, L, strides + 6, kBlockN);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      map_q, map_k, map_v, out, H, L, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90
}  // namespace svc
