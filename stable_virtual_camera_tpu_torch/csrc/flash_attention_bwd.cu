// K1-dKV and K1-dQ: the backward of K1 (non-causal flash attention, head
// dim 64, bf16 operands, fp32 accumulation).
//
// Replaces the two backward Pallas kernels behind the custom VJP of
// stable_virtual_camera_tpu/ops/flash_upstream.py::flash_attention_upstream_bhld
// (JAX's jax/experimental/pallas/ops/tpu/flash_attention.py:
// _flash_attention_bwd_dkv, kernel _flash_attention_dkv_kernel, and
// _flash_attention_bwd_dq, kernel _flash_attention_dq_kernel). With
// s = q.k / 8, P = exp2(s scale log2e - lse log2e) from K1's natural-log
// log-sum-exp and D = rowsum(o dO) (a plain reduction in the caller, as
// upstream computes it outside its kernels):
//   dV = P^T dO,  dP = dO V^T,  dS = P (dP - D),  dK = dS^T Q / 8,  dQ = dS K / 8,
// accumulated in fp32; P and dS are rounded to bf16 only as the A operand of
// a product.
//
// What bounds them on an H100: the arithmetic. The pair recomputes S and dP
// in each kernel and does 7 products of L^2 64 per (batch, head), 4 in
// K1-dKV and 3 in K1-dQ, against a few hundred MB of operands; the score
// tiles never reach device memory. Both kernels follow the forward tile
// (flash_fwd_sm90.cuh; the primitives are in sm90.cuh):
//   * a block is a producer warpgroup (`setmaxnreg.dec`) and consumer
//     warpgroups (`setmaxnreg.inc`) of 64 rows each. One producer thread
//     issues every tile load with TMA through the forward's 4-D tensor maps
//     (dims {64, L, H, B}, 128-byte swizzle, zero fill past L), into a ring
//     of stages with "full" and "empty" mbarriers;
//   * every product is a 64 x 64 wgmma (m64n64k16): SS (both operands in
//     shared memory) for the recomputed scores and dP, RS (A from registers,
//     by the accumulator-to-A-fragment identity `pack_a`) for the products
//     that take P or dS. One shared tile serves as K-major B in one product
//     and, through a second descriptor with the transpose bit, as MN-major B
//     in another. Within a consumer, dP's product runs while P is computed,
//     and (in K1-dKV) dV's while dS is;
//   * K1-dKV: 2 consumers, 128 resident keys of K and V. Q and dO tiles of
//     64 queries come through a ring of kDkvStages stages. Per stage,
//     consumer c computes S^T = K_c Q^T and dP^T = V_c dO^T (SS), P^T and
//     dS^T in fp32, then dV += P^T dO and dK += dS^T Q (RS, dO and Q read
//     MN-major). Its four 64 x 64 accumulators take 128 of a thread's 240
//     registers, so a third consumer (160 registers) spills. In S^T the
//     query is the accumulator's column, so lse and D are indexed by
//     column. They are not loaded with TMA (a TMA row stride must be a
//     multiple of 16 bytes, and 4 L is not at L = 1701): warp 1 of the
//     producer warpgroup copies each stage's 64 + 64 floats into the stage
//     with ordinary loads and arrives on its full barrier. Query rows >= L
//     get lse = +inf there, so their P, and with it their share of dV and
//     dK, is 0;
//   * K1-dQ: 3 consumers, 192 resident query rows of Q and dO, with their
//     lse and D in registers. K and V tiles of 64 keys come through a ring
//     of kDqStages stages (K full, V full and empty barriers). Per stage:
//     S = Q K^T and dP = dO V^T (SS, V read K-major), P with keys >= L
//     masked to 0 (zero fill would score them 0, not -inf), dS, then
//     dQ += dS K (RS, K read MN-major). 128-key tiles (m64n128 scores) need
//     more registers than two consumers have and spill dQ's accumulator;
//   * no atomics: each output row is written once, by one thread, through
//     its (batch, head, row) element strides; rows >= L are not stored. dK
//     and dQ are scaled by 1/8 at the store. Two launches on the same inputs
//     give the same bits.
// Measured on the card (PERF.md): K1-dKV runs at about half the bf16 peak.
// Its four products alone, without the exp2 and elementwise work, reach
// only ~55%: two consumers of 64 x 64 products do not keep the tensor cores
// fed. Ping-pong between the consumers, issuing the next tile's scores
// before the current tile's last product, and K or V held in registers as
// A fragments measured no faster (the last two run out of registers).

#include "sm90.cuh"

namespace {

using namespace svc;
using namespace svc::sm90;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kTile64 = 64 * kRowBytes;  // 8 KB: 64 rows of 64 bf16
constexpr int kMNStep = 16 * kRowBytes >> 4;  // an MN-major k-step of 16 rows: 2 KB

// A block of kConsumers consumer warpgroups and one producer warpgroup, and
// how the producer's registers go to the consumers (65536 a block at most).
template <int kConsumers>
struct Block {
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kProducerRegs = kConsumers == 2 ? 24 : 32;
  static constexpr int kConsumerRegs = kConsumers == 2 ? 240 : 160;
  static_assert(128 * (kProducerRegs + kConsumers * kConsumerRegs) <= 65536, "register budget");
};

// K1-dKV: 64 * kDkvConsumers resident keys, a ring of 64-query Q/dO tiles
// with their lse (log2 domain) and D
constexpr int kDkvConsumers = 2;
using DkvBlock = Block<kDkvConsumers>;
constexpr int kDkvKeys = 64 * kDkvConsumers;
constexpr int kDkvStages = 3;
constexpr int kDkvRowFloats = 2 * 64;  // lse2[64], D[64] per stage
constexpr int kDkvSmem = 1024 + 2 * kDkvKeys * kRowBytes + kDkvStages * 2 * kTile64 +
                         kDkvStages * kDkvRowFloats * 4 + 8 * (1 + 2 * kDkvStages);
// K1-dQ: 64 * kDqConsumers resident query rows, a ring of 64-key K/V tiles
constexpr int kDqConsumers = 3;
using DqBlock = Block<kDqConsumers>;
constexpr int kDqRows = 64 * kDqConsumers;
constexpr int kDqStages = 4;
constexpr int kDqSmem = 1024 + 2 * kDqRows * kRowBytes + kDqStages * 2 * kTile64 +
                        8 * (1 + 3 * kDqStages);

// An output: (B, H, L, 64) bf16 through (batch, head, row) element strides.
struct BwdOut {
  __nv_bfloat16* p;
  long long sb, sh, sl;
};

// Store a consumer's 64 x 64 fp32 accumulator (rows row0 + {0, 8} of each
// thread) times `mul`; rows >= L are not stored.
__device__ __forceinline__ void store_rows(const BwdOut& out, const float (&acc)[32], int b, int h,
                                           int row0, int L, float mul, int t4) {
  __nv_bfloat16* base = out.p + b * out.sb + h * out.sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row < L) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(base + row * out.sl + 8 * j + 2 * t4) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
      }
    }
  }
}

// K-major (rows x 64, the head dim contiguous) and MN-major descriptors of a
// swizzled tile of 64 rows.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile) {
  return sw128_desc(tile, 16, 8 * kRowBytes);
}
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile) {
  return sw128_desc(tile, kTile64, 8 * kRowBytes);
}

// Issue acc = A B^T (64 x 64) over the head dim: 4 k-steps of 16, +32 B
// along the swizzled rows of both K-major tiles.
__device__ __forceinline__ void issue_abt(float (&acc)[32], uint64_t desc_a, uint64_t desc_b) {
  wgmma_m64n64k16_ss<false>(acc, desc_a, desc_b);
#pragma unroll
  for (int ks = 1; ks < 4; ++ks) wgmma_m64n64k16_ss<true>(acc, desc_a + 2 * ks, desc_b + 2 * ks);
  wgmma_commit();
}

// Issue acc += A B (64 x 64) over 64 rows of B: A from registers, B a tile
// read MN-major.
__device__ __forceinline__ void issue_ab(float (&acc)[32], const uint32_t (&a)[4][4], uint32_t b_tile) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_m64n64k16_rs(acc, a[kk], desc_mnmajor(b_tile) + kk * kMNStep);
  wgmma_commit();
}

// Block (key tile blockIdx.x, batch * head blockIdx.y): dK and dV of keys
// [k0, k0 + kDkvKeys).
__global__ void __launch_bounds__(DkvBlock::kThreads, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const __grid_constant__ CUtensorMap map_do,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const BwdOut dk, const BwdOut dv, int H, int L, float scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sK = base;
  const uint32_t sV = sK + kDkvKeys * kRowBytes;
  const uint32_t sQ = sV + kDkvKeys * kRowBytes;   // + kTile64 s
  const uint32_t sdO = sQ + kDkvStages * kTile64;  // + kTile64 s
  const uint32_t sRows = sdO + kDkvStages * kTile64;
  const uint32_t bar_kv = sRows + kDkvStages * kDkvRowFloats * 4;
  const uint32_t bar_full = bar_kv + 8;                  // + 8 s
  const uint32_t bar_empty = bar_full + 8 * kDkvStages;  // + 8 s
  float* rows = reinterpret_cast<float*>(smem_raw + (sRows - raw));
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int k0 = blockIdx.x * kDkvKeys;
  const int n_tiles = (L + 63) / 64;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kDkvStages; ++s) {
      mbar_init(bar_full + 8 * s, 1 + 32);  // the TMA thread and the 32 lanes of the row copy
      mbar_init(bar_empty + 8 * s, 128 * kDkvConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(DkvBlock::kProducerRegs));
    if (threadIdx.x == 0) {
      // TMA: the resident K and V, then the Q/dO ring
      mbar_expect_tx(bar_kv, 2 * kDkvKeys * kRowBytes);
      tma_load_4d(sK, map_k, bar_kv, 0, k0, h, b);
      tma_load_4d(sV, map_v, bar_kv, 0, k0, h, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kDkvStages;
        mbar_wait(bar_empty + 8 * s, ((t / kDkvStages) & 1) ^ 1);
        mbar_expect_tx(bar_full + 8 * s, 2 * kTile64);
        tma_load_4d(sQ + s * kTile64, map_q, bar_full + 8 * s, 0, t * 64, h, b);
        tma_load_4d(sdO + s * kTile64, map_do, bar_full + 8 * s, 0, t * 64, h, b);
      }
    } else if (threadIdx.x / 32 == 1) {
      // the stage's lse (log2 domain, +inf past L) and D (0 past L)
      const int lane = threadIdx.x & 31;
      const float* lse_bh = lse + (long long)blockIdx.y * L;
      const float* d_bh = delta + (long long)blockIdx.y * L;
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kDkvStages;
        mbar_wait(bar_empty + 8 * s, ((t / kDkvStages) & 1) ^ 1);
        float* r = rows + s * kDkvRowFloats;
        for (int i = lane; i < 64; i += 32) {
          const int q = t * 64 + i;
          r[i] = q < L ? lse_bh[q] * kLog2e : INFINITY;
          r[64 + i] = q < L ? d_bh[q] : 0.f;
        }
        mbar_arrive(bar_full + 8 * s);
      }
    }
    return;
  }

  // consumer warpgroup c: keys [k0 + 64 c, k0 + 64 c + 64)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(DkvBlock::kConsumerRegs));
  const int c = wg - 1;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int t4 = lane & 3;
  const float scale_log2 = scale * kLog2e;
  const uint64_t desc_k = desc_kmajor(sK + c * kTile64);
  const uint64_t desc_v = desc_kmajor(sV + c * kTile64);

  // accumulators: rows are this consumer's keys, columns queries (S^T, dP^T)
  // or the head dim (dK, dV)
  float st[32], dpt[32], acc_dk[32], acc_dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    acc_dk[i] = 0.f;
    acc_dv[i] = 0.f;
  }
  uint32_t pa[4][4], da[4][4];

  mbar_wait(bar_kv, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kDkvStages;
    const uint32_t q_tile = sQ + s * kTile64;
    const uint32_t do_tile = sdO + s * kTile64;
    const float* r = rows + s * kDkvRowFloats;
    mbar_wait(bar_full + 8 * s, (t / kDkvStages) & 1);

    // S^T = K_c Q^T and dP^T = V_c dO^T, Q and dO K-major
    wgmma_fence();
    issue_abt(st, desc_k, desc_kmajor(q_tile));
    issue_abt(dpt, desc_v, desc_kmajor(do_tile));

    // P^T = exp2(S^T scale log2e - lse2[query]) while dP^T's product runs;
    // the thread's queries are columns 8 j + 2 t4 + {0, 1}
    wgmma_wait<1>();
    fence_regs(st);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(r + 8 * j + 2 * t4);
      st[4 * j] = ex2(fmaf(st[4 * j], scale_log2, -l2.x));
      st[4 * j + 1] = ex2(fmaf(st[4 * j + 1], scale_log2, -l2.y));
      st[4 * j + 2] = ex2(fmaf(st[4 * j + 2], scale_log2, -l2.x));
      st[4 * j + 3] = ex2(fmaf(st[4 * j + 3], scale_log2, -l2.y));
    }
    pack_a(pa, st);
    // dV += P^T dO (k over the 64 queries, dO MN-major)
    issue_ab(acc_dv, pa, do_tile);

    // dS^T = P^T (dP^T - D[query]) while dV's product runs
    wgmma_wait<1>();
    fence_regs(dpt);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 d = *reinterpret_cast<const float2*>(r + 64 + 8 * j + 2 * t4);
      dpt[4 * j] = st[4 * j] * (dpt[4 * j] - d.x);
      dpt[4 * j + 1] = st[4 * j + 1] * (dpt[4 * j + 1] - d.y);
      dpt[4 * j + 2] = st[4 * j + 2] * (dpt[4 * j + 2] - d.x);
      dpt[4 * j + 3] = st[4 * j + 3] * (dpt[4 * j + 3] - d.y);
    }
    pack_a(da, dpt);
    // dK += dS^T Q (scaled at the store; Q MN-major)
    issue_ab(acc_dk, da, q_tile);
    wgmma_wait<0>();
    fence_regs(acc_dv);
    fence_regs(acc_dk);
    mbar_arrive(bar_empty + 8 * s);
  }

  const int key0 = k0 + c * 64 + warp * 16 + (lane >> 2);
  store_rows(dk, acc_dk, b, h, key0, L, scale, t4);
  store_rows(dv, acc_dv, b, h, key0, L, 1.f, t4);
}

// Block (query tile blockIdx.x, batch * head blockIdx.y): dQ of rows
// [q0, q0 + kDqRows).
__global__ void __launch_bounds__(DqBlock::kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const __grid_constant__ CUtensorMap map_do,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const BwdOut dq, int H, int L, float scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sdO = sQ + kDqRows * kRowBytes;
  const uint32_t sK = sdO + kDqRows * kRowBytes;  // + kTile64 s
  const uint32_t sV = sK + kDqStages * kTile64;   // + kTile64 s
  const uint32_t bar_q = sV + kDqStages * kTile64;
  const uint32_t bar_k = bar_q + 8;                  // + 8 s
  const uint32_t bar_v = bar_k + 8 * kDqStages;      // + 8 s
  const uint32_t bar_empty = bar_v + 8 * kDqStages;  // + 8 s
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int q0 = blockIdx.x * kDqRows;
  const int n_tiles = (L + 63) / 64;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kDqStages; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 128 * kDqConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(DqBlock::kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, 2 * kDqRows * kRowBytes);
#pragma unroll
      for (int c = 0; c < kDqConsumers; ++c) {
        tma_load_4d(sQ + c * kTile64, map_q, bar_q, 0, q0 + 64 * c, h, b);
        tma_load_4d(sdO + c * kTile64, map_do, bar_q, 0, q0 + 64 * c, h, b);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kDqStages;
        mbar_wait(bar_empty + 8 * s, ((t / kDqStages) & 1) ^ 1);
        mbar_expect_tx(bar_k + 8 * s, kTile64);
        tma_load_4d(sK + s * kTile64, map_k, bar_k + 8 * s, 0, t * 64, h, b);
        mbar_expect_tx(bar_v + 8 * s, kTile64);
        tma_load_4d(sV + s * kTile64, map_v, bar_v + 8 * s, 0, t * 64, h, b);
      }
    }
    return;
  }

  // consumer warpgroup c: query rows [q0 + 64 c, q0 + 64 c + 64)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(DqBlock::kConsumerRegs));
  const int c = wg - 1;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int t4 = lane & 3;
  const float scale_log2 = scale * kLog2e;
  const uint64_t desc_q = desc_kmajor(sQ + c * kTile64);
  const uint64_t desc_do = desc_kmajor(sdO + c * kTile64);

  // the thread's rows row0 and row0 + 8: lse (log2 domain, +inf past L, so
  // P = 0 there) and D
  const int row0 = q0 + c * 64 + warp * 16 + (lane >> 2);
  float lse2[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lse2[r] = row < L ? lse[(long long)blockIdx.y * L + row] * kLog2e : INFINITY;
    dd[r] = row < L ? delta[(long long)blockIdx.y * L + row] : 0.f;
  }

  float s_acc[32], dp[32], acc_dq[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc_dq[i] = 0.f;
  uint32_t da[4][4];

  mbar_wait(bar_q, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kDqStages;
    const uint32_t parity = (t / kDqStages) & 1;
    const uint32_t k_tile = sK + s * kTile64;

    // S = Q K^T, dP = dO V^T, K and V K-major
    mbar_wait(bar_k + 8 * s, parity);
    wgmma_fence();
    issue_abt(s_acc, desc_q, desc_kmajor(k_tile));
    mbar_wait(bar_v + 8 * s, parity);
    issue_abt(dp, desc_do, desc_kmajor(sV + s * kTile64));

    // P = exp2(S scale log2e - lse2[row]) while dP's product runs; keys >= L
    // masked to 0
    wgmma_wait<1>();
    fence_regs(s_acc);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s_acc[4 * j + e] = ex2(fmaf(s_acc[4 * j + e], scale_log2, -lse2[0]));
        s_acc[4 * j + 2 + e] = ex2(fmaf(s_acc[4 * j + 2 + e], scale_log2, -lse2[1]));
      }
    }
    const int k0 = t * 64;
    if (k0 + 64 > L) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (k0 + 8 * j + 2 * t4 + e >= L) {
            s_acc[4 * j + e] = 0.f;
            s_acc[4 * j + 2 + e] = 0.f;
          }
        }
      }
    }

    // dS = P (dP - D[row])
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        dp[4 * j + e] = s_acc[4 * j + e] * (dp[4 * j + e] - dd[0]);
        dp[4 * j + 2 + e] = s_acc[4 * j + 2 + e] * (dp[4 * j + 2 + e] - dd[1]);
      }
    }
    pack_a(da, dp);
    // dQ += dS K (scaled at the store; K MN-major, k over the 64 keys)
    issue_ab(acc_dq, da, k_tile);
    wgmma_wait<0>();
    fence_regs(acc_dq);
    mbar_arrive(bar_empty + 8 * s);
  }

  store_rows(dq, acc_dq, b, h, row0, L, scale, t4);
}

// The tensor maps of q, k, v and do (byte strides {row, head, batch} each,
// in that order), with the box rows each kernel loads.
cudaError_t encode_maps(CUtensorMap (&maps)[4], const void* const (&ptrs)[4], int B, int H, int L,
                        const long long (&strides)[12], const int (&box_rows)[4]) {
  cudaError_t err = cudaSuccess;
  for (int i = 0; i < 4 && err == cudaSuccess; ++i) {
    err = encode_map(&maps[i], ptrs[i], B, H, L, strides + 3 * i, box_rows[i]);
  }
  return err;
}

}  // namespace

// q, k, v, dout: (B, H, L, 64) bf16 with byte strides {row, head, batch}
// each (multiples of 16, head dim contiguous, 16-byte aligned bases); lse
// (K1's natural-log log-sum-exp) and delta (rowsum(o dout)): contiguous fp32
// (B, H, L); dk, dv: bf16 through (batch, head, row) element strides;
// scale: the softmax scale 1/sqrt(64).
extern "C" int svc_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int H, int L,
    long long q_row, long long q_head, long long q_batch,
    long long k_row, long long k_head, long long k_batch,
    long long v_row, long long v_head, long long v_batch,
    long long do_row, long long do_head, long long do_batch,
    long long dksb, long long dksh, long long dksl,
    long long dvsb, long long dvsh, long long dvsl,
    float scale, void* stream) {
  const long long strides[12] = {q_row, q_head, q_batch, k_row, k_head, k_batch,
                                 v_row, v_head, v_batch, do_row, do_head, do_batch};
  CUtensorMap maps[4];
  cudaError_t err = encode_maps(maps, {q, k, v, dout}, B, H, L, strides,
                                {64, kDkvKeys, kDkvKeys, 64});
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(flash_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kDkvSmem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const BwdOut out_k{static_cast<__nv_bfloat16*>(dk), dksb, dksh, dksl};
  const BwdOut out_v{static_cast<__nv_bfloat16*>(dv), dvsb, dvsh, dvsl};
  dim3 grid((L + kDkvKeys - 1) / kDkvKeys, B * H);
  flash_bwd_dkv_kernel<<<grid, DkvBlock::kThreads, kDkvSmem, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(lse),
      static_cast<const float*>(delta), out_k, out_v, H, L, scale);
  return static_cast<int>(cudaGetLastError());
}

// As above; writes dq through its (batch, head, row) element strides.
extern "C" int svc_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int B, int H, int L,
    long long q_row, long long q_head, long long q_batch,
    long long k_row, long long k_head, long long k_batch,
    long long v_row, long long v_head, long long v_batch,
    long long do_row, long long do_head, long long do_batch,
    long long dqsb, long long dqsh, long long dqsl,
    float scale, void* stream) {
  const long long strides[12] = {q_row, q_head, q_batch, k_row, k_head, k_batch,
                                 v_row, v_head, v_batch, do_row, do_head, do_batch};
  CUtensorMap maps[4];
  cudaError_t err = encode_maps(maps, {q, k, v, dout}, B, H, L, strides,
                                {64, 64, 64, 64});
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(flash_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kDqSmem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const BwdOut out{static_cast<__nv_bfloat16*>(dq), dqsb, dqsh, dqsl};
  dim3 grid((L + kDqRows - 1) / kDqRows, B * H);
  flash_bwd_dq_kernel<<<grid, DqBlock::kThreads, kDqSmem, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(lse),
      static_cast<const float*>(delta), out, H, L, scale);
  return static_cast<int>(cudaGetLastError());
}
