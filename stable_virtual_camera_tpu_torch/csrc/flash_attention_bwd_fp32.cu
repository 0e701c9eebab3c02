// The fp32 entries of K1-dKV and K1-dQ: the backward of K1 on fp32
// operands, head dim 64, every product on the tensor cores in 3xTF32.
//
// Replaces the fp32 inputs of the two backward Pallas kernels behind the
// custom VJP of stable_virtual_camera_tpu/ops/flash_upstream.py::
// flash_attention_upstream_bhld (jax/experimental/pallas/ops/tpu/
// flash_attention.py: _flash_attention_bwd_dkv and _flash_attention_bwd_dq),
// which take fp32 as well as bf16; the Hopper pair of flash_attention_bwd.cu
// is bf16 only. With s = q.k / 8, P = exp(s - lse) from K1's natural-log
// log-sum-exp and D = rowsum(o dO) (less a gradient on the lse, folded in by
// the caller as for the bf16 pair):
//   dV = P^T dO,  dP = dO V^T,  dS = P (dP - D),  dK = dS^T Q / 8,  dQ = dS K / 8.
//
// What bounds them on an H100: the arithmetic. K1-dKV does 8 L^2 64 FLOP
// per (batch, head) and K1-dQ 6 L^2 64 (S and dP are recomputed in each)
// against a few fp32 (L, 64) operands. Outside the tensor cores fp32 runs at
// 67 TFLOP/s. One TF32 product keeps about three digits, too few for fp32's
// bar, so every product runs as three (3xTF32), at 495 / 3 TFLOP/s: with
// x = x_hi + x_lo, a b ~ a_hi b_hi + a_hi b_lo + a_lo b_hi. x_hi is x cut to
// TF32 (its low 13 mantissa bits cleared, one AND) and x_lo = x - x_hi,
// exact in fp32, passed whole: the tensor cores read a TF32 operand's top
// 19 bits, so they cut x_lo to TF32 themselves. Each cut loses under 2^-10
// of what it cuts, so a product is off by about 2^-20 of |a b| (the lo lo
// term is dropped). A rounded split (cvt.rna.tf32.f32 for x_hi and x_lo)
// would halve that and measured 9-19% slower (design notes, PERF.md): a
// split stands between each shared load of a B fragment and its three
// mma, two instructions here against five rounded. Design:
//   * a block is kWarps warps of 16 resident rows each (K1-dKV: keys;
//     K1-dQ: queries), 128 rows a block, one block an SM. A warp of its own
//     for the loads would make 9 warps, which caps a thread at 168
//     registers (a quarter of the SM's file serves 3 of them) and spills;
//     `setmaxnreg` in a producer warpgroup did not lift ptxas's budget. So
//     warp 0 also loads: one of its threads loads every tile with TMA
//     through 4-D tensor maps (128-byte swizzle, zero fill past L), the
//     resident tiles once and the other side's 64-row tiles into a ring of
//     kStages stages on "full" and "empty" mbarriers, refilling at the top
//     of each step the stage the step before released, two tiles ahead. An
//     fp32 row of 64 is 256 bytes, two swizzle rows, so a tile is two boxes
//     of 32 dims; the maps are the bf16 maps of sm90.cuh over twice as many
//     2-byte elements, since TMA moves bytes and fills zeros with zero bits;
//   * the warps split the resident tiles once a block, in place: x_hi
//     over x (times scale log2e for K in K1-dKV and Q in K1-dQ, so scores
//     come out in base 2) and x_lo into a second buffer in the same layout;
//   * every product is mma.sync.m16n8k8.tf32 (wgmma takes tf32 only K-major
//     from shared memory, and three of the seven products read their B
//     operand along rows; mma.sync fragments are loaded by threads with any
//     addressing). A fragments: the resident rows from the hi and lo
//     buffers, or P and dS straight from the accumulators of S and dP. An
//     accumulator holds columns 2 t4 and 2 t4 + 1 of each 8, an A fragment
//     columns t4 and t4 + 4, so the contraction index of those products is
//     permuted the same way in A and B (B rows 2 t4 and 2 t4 + 1), which
//     leaves the product unchanged. B fragments are read from the streamed
//     tile and split where they are read, once per use (a split copy of
//     each tile in shared memory, read as (hi, lo) pairs, doubles the reads
//     and the room and measured slower).
//     In the 128-byte swizzle both ways of reading a tile (rows g, dims
//     8 k + t4; rows 2 t4 + {0, 1}, dims 8 n + g) touch 32 distinct banks;
//   * K1-dKV: per 64-query stage a warp computes S^T and dP^T (16 keys x 64
//     queries), P^T = exp2(S^T - lse2[query]) and dS^T in fp32 registers,
//     then dV += P^T dO and dK += dS^T Q. K1-dQ: S and dP (16 queries x 64
//     keys), P with keys >= L masked to 0 (zero fill would score them 0, not
//     -inf), dS, then dQ += dS K. lse and D of the stage's queries reach
//     K1-dKV through warp 0's lanes (ordinary loads: 4 L need not be a
//     multiple of 16, a TMA row stride must), with lse = +inf past L, so
//     those queries' P and their share of dV and dK are 0;
//   * the tensor cores may round their fp32 sums toward zero, a bias that
//     would pile up over the ~10^4 products of a row at the joint site's
//     27216 keys. So each stage's dV, dK or dQ is summed from zero in
//     registers and then added to the running sum in fp32 (round to
//     nearest);
//   * no atomics: each output row is written once, by one thread, through
//     its (batch, head, row) element strides; rows >= L are not stored. dK
//     and dQ are scaled by 1/8 at the store. Two launches on the same inputs
//     give the same bits.
// The entries take q, k, v and do with a contiguous head dim, 16-byte
// strides and a 16-byte aligned base (what a tensor map takes); the wrapper
// (ops/flash_upstream.py) copies other fp32 views first.

#include "tf32x3.cuh"

namespace {

using namespace svc;
using namespace svc::sm90;
using namespace svc::tf32x3;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kStages = 3;
constexpr int kRowFloats = 2 * kTile;        // K1-dKV: lse2[64], D[64] a stage
// resident hi/lo of two operands, kStages stages of two streamed tiles,
// barriers;
// at 3 stages K1-dKV takes 231,992 of the 232,448 bytes a block may have
constexpr int kDqSmem = 1024 + 4 * kResBytes + 2 * kStages * kTileBytes + 8 * (1 + 2 * kStages);
constexpr int kDkvSmem = kDqSmem + kStages * kRowFloats * 4;

struct Out {
  float* p;
  long long sb, sh, sl;  // element strides: batch, head, row (dim contiguous)
};

// acc (16 x 64) = A (16 x 64, resident rows) T^T over the head dim, T a
// streamed 64-row tile (the accumulator's columns are T's rows), for two
// pairs (a0, t0) and (a1, t1) at once.
__device__ __forceinline__ void products_abt(float (&c0)[8][4], float (&c1)[8][4], const uint8_t* a0_hi,
                                             const uint8_t* a0_lo, const uint8_t* a1_hi, const uint8_t* a1_lo,
                                             const uint8_t* t0, const uint8_t* t1, int r, int g, int t4) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      c0[j][i] = 0.f;
      c1[j][i] = 0.f;
    }
  }
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    const Frag f0 = resident_a(a0_hi, a0_lo, r, ks, t4);
    const Frag f1 = resident_a(a1_hi, a1_lo, r, ks, t4);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t o0 = sw<kTile>(8 * j + g, 8 * ks + t4), o1 = sw<kTile>(8 * j + g, 8 * ks + t4 + 4);
      mma3(c0[j], f0, lds(t0, o0), lds(t0, o1));
      mma3(c1[j], f1, lds(t1, o0), lds(t1, o1));
    }
  }
}

// Store a warp's 16 x 64 accumulator (rows row0 and row0 + 8 of its
// threads) times `mul`; rows >= L are not stored.
__device__ __forceinline__ void store_rows(const Out& out, const float (&acc)[8][4], int b, int h, int row0,
                                           int L, float mul, int t4) {
  float* base = out.p + b * out.sb + h * out.sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row < L) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        *reinterpret_cast<float2*>(base + row * out.sl + 8 * n + 2 * t4) =
            make_float2(acc[n][2 * r] * mul, acc[n][2 * r + 1] * mul);
      }
    }
  }
}

// The shared memory of both kernels: the resident operands' hi and lo
// buffers, the ring of two streamed operands, (K1-dKV) the rows' lse2 and
// D, and the barriers.
struct Smem {
  uint8_t* p;
  uint32_t base;  // shared address of p
  __device__ explicit Smem(uint8_t* raw) {
    const uint32_t r = smem_u32(raw);
    base = (r + 1023u) & ~1023u;
    p = raw + (base - r);
  }
  __device__ uint8_t* hi(int i) const { return p + 2 * i * kResBytes; }
  __device__ uint8_t* lo(int i) const { return p + (2 * i + 1) * kResBytes; }
  __device__ uint32_t stage(int i, int s) const { return base + 4 * kResBytes + (i * kStages + s) * kTileBytes; }
  __device__ uint8_t* stage_ptr(int i, int s) const { return p + (stage(i, s) - base); }
  __device__ uint32_t bar_res() const { return base + 4 * kResBytes + 2 * kStages * kTileBytes; }
  __device__ uint32_t bar_full(int s) const { return bar_res() + 8 + 8 * s; }
  __device__ uint32_t bar_empty(int s) const { return bar_full(kStages) + 8 * s; }
  __device__ float* rows(int s) const {
    return reinterpret_cast<float*>(p + (bar_empty(kStages) - base)) + s * kRowFloats;
  }
};

// TMA of one resident operand (rows row0 .. row0 + kRows) into hi(i), or
// one streamed 64-row tile into stage (i, s): two boxes of 32 dims.
__device__ __forceinline__ void load_resident(const Smem& sm, int i, const CUtensorMap& map, int row0, int h,
                                              int b) {
  const uint32_t dst = sm.base + 2 * i * kResBytes;
  tma_load_4d(dst, map, sm.bar_res(), 0, row0, h, b);
  tma_load_4d(dst + kRows * 128, map, sm.bar_res(), 64, row0, h, b);
}
__device__ __forceinline__ void load_tile(const Smem& sm, int i, int s, const CUtensorMap& map, int row0, int h,
                                          int b) {
  const uint32_t dst = sm.stage(i, s);
  tma_load_4d(dst, map, sm.bar_full(s), 0, row0, h, b);
  tma_load_4d(dst + kTile * 128, map, sm.bar_full(s), 64, row0, h, b);
}

__device__ __forceinline__ void init_barriers(const Smem& sm, uint32_t full_count) {
  mbar_init(sm.bar_res(), 1);
  for (int s = 0; s < kStages; ++s) {
    mbar_init(sm.bar_full(s), full_count);
    mbar_init(sm.bar_empty(s), kThreads);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// K1-dKV: warp 0 fills the stage of query tile t: Q and dO by TMA (lane 0),
// the queries' lse2 (+inf past L) and D (0 past L) by its lanes.
__device__ __forceinline__ void fill_dkv(const Smem& sm, int t, const CUtensorMap& map_q,
                                         const CUtensorMap& map_do, const float* lse_bh, const float* d_bh,
                                         int L, int h, int b, int lane) {
  const int s = t % kStages;
  if (lane == 0) {
    mbar_expect_tx(sm.bar_full(s), 2 * kTileBytes);
    load_tile(sm, 0, s, map_q, t * kTile, h, b);
    load_tile(sm, 1, s, map_do, t * kTile, h, b);
  }
  float* r = sm.rows(s);
  for (int i = lane; i < kTile; i += 32) {
    const int q = t * kTile + i;
    r[i] = q < L ? lse_bh[q] * kLog2e : INFINITY;
    r[kTile + i] = q < L ? d_bh[q] : 0.f;
  }
  mbar_arrive(sm.bar_full(s));
}

// K1-dQ: thread 0 fills the stage of key tile t with K and V by TMA.
__device__ __forceinline__ void fill_dq(const Smem& sm, int t, const CUtensorMap& map_k, const CUtensorMap& map_v,
                                        int h, int b) {
  const int s = t % kStages;
  mbar_expect_tx(sm.bar_full(s), 2 * kTileBytes);
  load_tile(sm, 0, s, map_k, t * kTile, h, b);
  load_tile(sm, 1, s, map_v, t * kTile, h, b);
}

// Whether warp 0 refills, at the top of step t, the stage that tile t - 1
// used (with tile t - 1 + kStages), once every warp has released it.
__device__ __forceinline__ bool refill(const Smem& sm, int t, int n_tiles) {
  if (t == 0 || t - 1 + kStages >= n_tiles) return false;
  mbar_wait(sm.bar_empty((t - 1) % kStages), ((t - 1) / kStages) & 1);
  return true;
}

// Block: resident keys [k0, k0 + kRows) of one (batch, head); dK and dV.
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_fp32_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
                          const float* __restrict__ lse, const float* __restrict__ delta, const Out dk,
                          const Out dv, int H, int L, int tiles, float scale) {
  extern __shared__ uint8_t smem_raw[];
  const Smem sm(smem_raw);
  const int tile = blockIdx.x % tiles;
  const int bh = blockIdx.x / tiles;
  const int b = bh / H, h = bh % H;
  const int k0 = tile * kRows;
  const int n_tiles = (L + kTile - 1) / kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* lse_bh = lse + static_cast<long long>(bh) * L;
  const float* d_bh = delta + static_cast<long long>(bh) * L;

  if (threadIdx.x == 0) init_barriers(sm, 1 + 32);  // the TMA arrive and the 32 lanes of the row copy
  __syncthreads();
  if (warp == 0) {
    // K and V once, then the first query tiles
    if (lane == 0) {
      mbar_expect_tx(sm.bar_res(), 2 * kResBytes);
      load_resident(sm, 0, map_k, k0, h, b);
      load_resident(sm, 1, map_v, k0, h, b);
    }
    for (int t = 0; t < kStages && t < n_tiles; ++t) fill_dkv(sm, t, map_q, map_do, lse_bh, d_bh, L, h, b, lane);
  }

  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = 16 * warp + g;  // this thread's resident rows r0, r0 + 8
  mbar_wait(sm.bar_res(), 0);
  split_resident(sm.hi(0), sm.lo(0), scale * kLog2e, threadIdx.x);  // K in base-2 score units
  split_resident(sm.hi(1), sm.lo(1), 1.f, threadIdx.x);
  __syncthreads();

  float acc_dk[8][4], acc_dv[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc_dk[n][i] = 0.f;
      acc_dv[n][i] = 0.f;
    }
  }
  float st[8][4], dpt[8][4];  // S^T, dP^T: rows keys, columns the stage's queries
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    if (warp == 0 && refill(sm, t, n_tiles)) {
      fill_dkv(sm, t - 1 + kStages, map_q, map_do, lse_bh, d_bh, L, h, b, lane);
    }
    mbar_wait(sm.bar_full(s), (t / kStages) & 1);
    const uint8_t* q_tile = sm.stage_ptr(0, s);
    const uint8_t* do_tile = sm.stage_ptr(1, s);
    const float* r = sm.rows(s);
    products_abt(st, dpt, sm.hi(0), sm.lo(0), sm.hi(1), sm.lo(1), q_tile, do_tile, r0, g, t4);
    // P^T = exp2(S^T - lse2[query]), dS^T = P^T (dP^T - D[query]); the
    // thread's queries are columns 8 j + 2 t4 + {0, 1}
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(r + 8 * j + 2 * t4);
      const float2 d = *reinterpret_cast<const float2*>(r + kTile + 8 * j + 2 * t4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        st[j][i] = ex2(st[j][i] - ((i & 1) ? l2.y : l2.x));
        dpt[j][i] = st[j][i] * (dpt[j][i] - ((i & 1) ? d.y : d.x));
      }
    }
    product_xt(acc_dv, st, do_tile, g, t4);  // dV += P^T dO
    product_xt(acc_dk, dpt, q_tile, g, t4);  // dK += dS^T Q (scaled at the store)
    mbar_arrive(sm.bar_empty(s));
  }
  store_rows(dk, acc_dk, b, h, k0 + r0, L, scale, t4);
  store_rows(dv, acc_dv, b, h, k0 + r0, L, 1.f, t4);
}

// Block: resident queries [q0, q0 + kRows) of one (batch, head); dQ.
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_fp32_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
                         const float* __restrict__ lse, const float* __restrict__ delta, const Out dq, int H,
                         int L, int tiles, float scale) {
  extern __shared__ uint8_t smem_raw[];
  const Smem sm(smem_raw);
  const int tile = blockIdx.x % tiles;
  const int bh = blockIdx.x / tiles;
  const int b = bh / H, h = bh % H;
  const int q0 = tile * kRows;
  const int n_tiles = (L + kTile - 1) / kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    // Q and dO once, then the first key tiles
    init_barriers(sm, 1);
    mbar_expect_tx(sm.bar_res(), 2 * kResBytes);
    load_resident(sm, 0, map_q, q0, h, b);
    load_resident(sm, 1, map_do, q0, h, b);
    for (int t = 0; t < kStages && t < n_tiles; ++t) fill_dq(sm, t, map_k, map_v, h, b);
  }

  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = 16 * warp + g;
  // the rows' lse (log2 domain, +inf past L, so P = 0 there) and D
  float lse2[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + 8 * r;
    lse2[r] = row < L ? lse[static_cast<long long>(bh) * L + row] * kLog2e : INFINITY;
    dd[r] = row < L ? delta[static_cast<long long>(bh) * L + row] : 0.f;
  }
  __syncthreads();  // the barriers are initialised
  mbar_wait(sm.bar_res(), 0);
  split_resident(sm.hi(0), sm.lo(0), scale * kLog2e, threadIdx.x);  // Q in base-2 score units
  split_resident(sm.hi(1), sm.lo(1), 1.f, threadIdx.x);
  __syncthreads();

  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  }
  float sc[8][4], dp[8][4];  // S, dP: rows queries, columns the stage's keys
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    if (warp == 0 && refill(sm, t, n_tiles) && lane == 0) fill_dq(sm, t - 1 + kStages, map_k, map_v, h, b);
    mbar_wait(sm.bar_full(s), (t / kStages) & 1);
    const uint8_t* k_tile = sm.stage_ptr(0, s);
    products_abt(sc, dp, sm.hi(0), sm.lo(0), sm.hi(1), sm.lo(1), k_tile, sm.stage_ptr(1, s), r0, g, t4);
    // P = exp2(S - lse2[row]) with keys >= L masked to 0, dS = P (dP - D[row])
    const int key0 = t * kTile + 2 * t4;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = key0 + 8 * j + (i & 1) < L ? ex2(sc[j][i] - lse2[i >> 1]) : 0.f;
        sc[j][i] = p * (dp[j][i] - dd[i >> 1]);
      }
    }
    product_xt(acc, sc, k_tile, g, t4);  // dQ += dS K (scaled at the store)
    mbar_arrive(sm.bar_empty(s));
  }
  store_rows(dq, acc, b, h, q0 + r0, L, scale, t4);
}

// The maps of q, k, v and do ((batch, head, row, dim) element strides each,
// in that order) with the box rows each kernel loads, and the 1-D grid
// (row tile fastest).
cudaError_t prepare(CUtensorMap (&maps)[4], const void* const (&ptrs)[4], int B, int H, int L,
                    const long long (&es)[16], const int (&box_rows)[4], int* tiles, unsigned* blocks) {
  cudaError_t err = cudaSuccess;
  for (int i = 0; i < 4 && err == cudaSuccess; ++i) {
    err = encode_fp32(&maps[i], ptrs[i], B, H, L, es + 4 * i, box_rows[i]);
  }
  if (err != cudaSuccess) return err;
  *tiles = (L + kRows - 1) / kRows;
  const long long n = static_cast<long long>(*tiles) * B * H;
  if (n > 0x7fffffffLL) return cudaErrorInvalidValue;
  *blocks = static_cast<unsigned>(n);
  return cudaSuccess;
}

}  // namespace

// q, k, v, dout: (B, H, L, 64) fp32 through element strides {batch, head,
// row, dim} each (dim stride 1, the others whole 16-byte units, 16-byte
// aligned bases); lse (K1's natural-log log-sum-exp) and delta (rowsum(o
// dout), less any gradient on the lse): contiguous fp32 (B, H, L); dk, dv:
// fp32 with a contiguous head dim, through (batch, head, row) element
// strides; scale: the softmax scale 1/sqrt(64).
extern "C" int svc_flash_attention_bwd_dkv_fp32(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int H, int L,
    long long qsb, long long qsh, long long qsl, long long qsd,
    long long ksb, long long ksh, long long ksl, long long ksd,
    long long vsb, long long vsh, long long vsl, long long vsd,
    long long dsb, long long dsh, long long dsl, long long dsd,
    long long dksb, long long dksh, long long dksl,
    long long dvsb, long long dvsh, long long dvsl,
    float scale, void* stream) {
  if (B < 0 || H < 0 || L < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0 || L == 0) return static_cast<int>(cudaSuccess);
  const long long es[16] = {qsb, qsh, qsl, qsd, ksb, ksh, ksl, ksd, vsb, vsh, vsl, vsd, dsb, dsh, dsl, dsd};
  CUtensorMap maps[4];
  int tiles;
  unsigned blocks;
  cudaError_t err = prepare(maps, {q, k, v, dout}, B, H, L, es, {kTile, kRows, kRows, kTile}, &tiles, &blocks);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(flash_bwd_dkv_fp32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDkvSmem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkv_fp32_kernel<<<blocks, kThreads, kDkvSmem, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(lse), static_cast<const float*>(delta),
      Out{static_cast<float*>(dk), dksb, dksh, dksl}, Out{static_cast<float*>(dv), dvsb, dvsh, dvsl}, H, L, tiles,
      scale);
  return static_cast<int>(cudaGetLastError());
}

// As above; writes dq through its (batch, head, row) element strides.
extern "C" int svc_flash_attention_bwd_dq_fp32(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int B, int H, int L,
    long long qsb, long long qsh, long long qsl, long long qsd,
    long long ksb, long long ksh, long long ksl, long long ksd,
    long long vsb, long long vsh, long long vsl, long long vsd,
    long long dsb, long long dsh, long long dsl, long long dsd,
    long long dqsb, long long dqsh, long long dqsl,
    float scale, void* stream) {
  if (B < 0 || H < 0 || L < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0 || L == 0) return static_cast<int>(cudaSuccess);
  const long long es[16] = {qsb, qsh, qsl, qsd, ksb, ksh, ksl, ksd, vsb, vsh, vsl, vsd, dsb, dsh, dsl, dsd};
  CUtensorMap maps[4];
  int tiles;
  unsigned blocks;
  cudaError_t err = prepare(maps, {q, k, v, dout}, B, H, L, es, {kRows, kTile, kTile, kRows}, &tiles, &blocks);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(flash_bwd_dq_fp32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_fp32_kernel<<<blocks, kThreads, kDqSmem, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(lse), static_cast<const float*>(delta),
      Out{static_cast<float*>(dq), dqsb, dqsh, dqsl}, H, L, tiles, scale);
  return static_cast<int>(cudaGetLastError());
}
