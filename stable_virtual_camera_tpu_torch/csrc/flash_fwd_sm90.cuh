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

#include "sm90.cuh"

namespace svc {
namespace sm90 {

// Tuned on the card (PERF.md: 3 consumers and 3 stages were the fastest at
// every render shape).
constexpr int kConsumers = 3;                    // consumer warpgroups, 64 query rows each
constexpr int kBlockM = 64 * kConsumers;         // query rows per block
constexpr int kBlockN = 128;                     // keys per K/V tile
constexpr int kStages = 3;                       // K/V ring depth
constexpr int kThreads = 128 * (kConsumers + 1); // + the producer warpgroup
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
    wgmma_wait<0>();
    fence_regs(s);
    softmax_tile(s, m, l, corr, t * kBlockN, L, t4, scale_log2);
    rescale(acc, corr);
    pack_a(p, s);  // P as the A fragments of 8 k-steps of 16 keys
    mbar_wait(bar_v + 8 * st, parity);
    issue_pv(acc, p, desc_v(st));
    wgmma_wait<0>();
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