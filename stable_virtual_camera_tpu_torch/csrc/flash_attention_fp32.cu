// The fp32 entry of K1, K3 and K4: non-causal flash attention forward, head
// dim 64, fp32 in and out, every product on the tensor cores in 3xTF32.
//
// Replaces the fp32 inputs of stable_virtual_camera_tpu/ops/flash_upstream.py::
// flash_attention_upstream_bhld (K1), ops/flash_attention.py::flash_attention
// (K3) and ops/flash_attention_packed.py::flash_attention_packed (K4). Their
// Pallas kernels take fp32 as well as bf16; the Hopper tile of
// flash_fwd_sm90.cuh is bf16 wgmma only, so fp32 operands come here. It
// computes o = softmax(q k^T / 8) v for every (batch, head) over L query and
// L key rows, with the softmax in fp32, and, when the caller passes an lse
// buffer, each row's log-sum-exp in natural-log units (m ln2 + ln l), as K1's
// epilogue writes it for the backward.
//
// What bounds it on an H100: the arithmetic, 4 L^2 64 FLOP per (batch,
// head) against 4 L 64 fp32 values moved. Outside the tensor cores fp32 runs
// at 67 TFLOP/s. One TF32 product keeps about three digits, too few for
// fp32's bar, so every product runs as three (3xTF32, tf32x3.cuh: x = x_hi +
// x_lo, a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi), at 495 / 3 TFLOP/s. The
// tensor cores read a TF32 operand's top 19 bits, so an fp32 value in memory
// is its own x_hi; only x_lo = x - x_hi is computed. Design:
//   * a block is 8 warps, two warpgroups of 64 query rows, 128 rows a block,
//     one block an SM, for one (batch, head); blocks walk a 1-D grid with the
//     query tile fastest, so the blocks in flight together share one (batch,
//     head)'s K and V in L2;
//   * thread 0 loads Q once by TMA through a 4-D tensor map (128-byte
//     swizzle, zero fill past L) and streams K and V in 64-row tiles through
//     a ring of kStages stages on "full" and "empty" mbarriers; warp 0
//     refills a stage once every thread has released it. An fp32 row of 64
//     is 256 bytes, two swizzle rows, so a tile is two boxes of 32 dims;
//   * the warps split Q once a block, in place: x_hi of q scale log2e (so
//     scores come out in base 2) over q and x_lo into a second buffer;
//   * both products are wgmma.m64n64k8.tf32, which takes TF32 operands
//     K-major only. S = Q K^T reads Q and K (and their lo parts) from shared
//     memory, both K-major as they stand. O += P V takes P from registers
//     and needs V K-major, i.e. transposed: all threads derive, from each
//     K and V tile, K_lo in K's layout and V^T and V^T_lo (rows the head
//     dim, keys along each row), the next tile's while this tile's S runs,
//     into one of two sets, with one block barrier a tile;
//   * base-2 online softmax on the S accumulators (a thread holds 16 scores
//     of each of its two rows; the row maximum is taken across the quad by
//     shuffles); keys >= L score -inf (zero fill would score them 0); the
//     row sum stays per thread until the epilogue. P goes straight from the
//     accumulators into A fragments (`acc_a`), whose contraction index takes
//     keys 2 t4 and 2 t4 + 1 of each 8 to positions t4 and t4 + 4; V^T holds
//     its keys in that order (`kpos`), so the product is unchanged;
//   * each tile's P V is summed from zero and then added in fp32 to the
//     rescaled running O: the tensor cores may round their sums toward
//     zero, a bias that would pile up over the joint site's 27216 keys;
//   * o = acc / l is written once, by one thread, through the output's
//     element strides; rows >= L are neither stored nor given an lse. Two
//     launches on the same inputs give the same bits.
// It takes q, k and v with a contiguous head dim, 16-byte strides and a
// 16-byte aligned base (what a tensor map takes); the wrapper
// (ops/flash_upstream.py) copies other fp32 views first. o takes any strides.

#include "tf32x3.cuh"

namespace {

using namespace svc;
using namespace svc::sm90;
using namespace svc::tf32x3;

constexpr float kLn2 = 0.69314718055994531f;
constexpr int kStages = 2;
// Q and Q_lo, kStages stages of a K and a V tile, two sets of a tile's
// K_lo, V^T and V^T_lo, barriers: 230,440 of the 232,448 bytes a block may have
constexpr int kSmem = 1024 + 2 * kResBytes + (2 * kStages + 6) * kTileBytes + 8 * (1 + 2 * kStages);

struct Out {
  float* p;
  long long sb, sh, sl, sd;  // element strides: batch, head, row, dim
};

struct Smem {
  uint8_t* p;
  uint32_t base;  // shared address of p
  __device__ explicit Smem(uint8_t* raw) {
    const uint32_t r = smem_u32(raw);
    base = (r + 1023u) & ~1023u;
    p = raw + (base - r);
  }
  __device__ uint8_t* ptr(uint32_t a) const { return p + (a - base); }
  __device__ uint32_t q(int i) const { return base + i * kResBytes; }  // 0: Q, 1: Q_lo
  // stage s of the ring: 0: K, 1: V
  __device__ uint32_t stage(int i, int s) const { return base + 2 * kResBytes + (i * kStages + s) * kTileBytes; }
  // derived set d: 0: K_lo, 1: V^T, 2: V^T_lo
  __device__ uint32_t derived(int d, int i) const {
    return base + 2 * kResBytes + (2 * kStages + 3 * d + i) * kTileBytes;
  }
  __device__ uint32_t bar_res() const { return derived(2, 0); }
  __device__ uint32_t bar_full(int s) const { return bar_res() + 8 + 8 * s; }
  __device__ uint32_t bar_empty(int s) const { return bar_full(kStages) + 8 * s; }
};

// Thread 0: the stage of key tile t, K and V by TMA, two boxes of 32 dims each.
__device__ __forceinline__ void fill(const Smem& sm, int t, const CUtensorMap& map_k, const CUtensorMap& map_v,
                                     int h, int b) {
  const int s = t % kStages;
  mbar_expect_tx(sm.bar_full(s), 2 * kTileBytes);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint32_t dst = sm.stage(i, s);
    const CUtensorMap& map = i == 0 ? map_k : map_v;
    tma_load_4d(dst, map, sm.bar_full(s), 0, t * kTile, h, b);
    tma_load_4d(dst + kTile * 128, map, sm.bar_full(s), 64, t * kTile, h, b);
  }
}

#define SVC_ACC32(c)                                                                           \
  c(d[0]), c(d[1]), c(d[2]), c(d[3]), c(d[4]), c(d[5]), c(d[6]), c(d[7]), c(d[8]), c(d[9]),    \
      c(d[10]), c(d[11]), c(d[12]), c(d[13]), c(d[14]), c(d[15]), c(d[16]), c(d[17]),          \
      c(d[18]), c(d[19]), c(d[20]), c(d[21]), c(d[22]), c(d[23]), c(d[24]), c(d[25]),          \
      c(d[26]), c(d[27]), c(d[28]), c(d[29]), c(d[30]), c(d[31])
#define SVC_M64N64K8                                                                           \
  "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"                                      \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"                      \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
// d (64 x 64, this warpgroup's rows; the accumulator layout of sm90.cuh) =
// (scale_d ? d : 0) + A B^T over one k-step of 8, A (64 x 8) and B (64 x 8)
// K-major in shared memory, read as TF32.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" SVC_M64N64K8 "%32, %33, p, 1, 1;\n}\n"
               : SVC_ACC32("+f")
               : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}
// The same with A in registers: each warp's 16 rows as an m16n8k8 A fragment.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" SVC_M64N64K8 "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
               : SVC_ACC32("+f")
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}
#undef SVC_M64N64K8
#undef SVC_ACC32

// The descriptor of k-step ks (8 fp32, 32 bytes) of a K-major tile of `rows`
// rows in TMA's 128-byte swizzle: k-steps 0-3 in the first 32 columns, 4-7
// in the second; 8 rows of 128 bytes a swizzle group.
template <int rows>
__device__ __forceinline__ uint64_t kdesc(uint32_t tile, int ks) {
  return sw128_desc(tile + (ks >> 2) * rows * 128 + (ks & 3) * 32, 16, 1024);
}

// The position in V^T of key e (0-7) of a k-step: `acc_a` puts P's column
// 2 t4 at position t4 and 2 t4 + 1 at t4 + 4.
__device__ __forceinline__ int kpos(int e) { return (e >> 1) + 4 * (e & 1); }

// Every thread: its share of derived set d from the tile in stage s. K_lo =
// K - K_hi where K stands; V^T (rows the head dim, keys in `kpos` order)
// and V^T_lo. A warp reads keys 8 j + e of V in 16-byte units and writes one
// V^T element a lane: both free of bank conflicts.
__device__ __forceinline__ void derive(const Smem& sm, int s, int d, int warp, int lane) {
  const float4* k = reinterpret_cast<const float4*>(sm.ptr(sm.stage(0, s)));
  float4* k_lo = reinterpret_cast<float4*>(sm.ptr(sm.derived(d, 0)));
  const uint8_t* v = sm.ptr(sm.stage(1, s));
  uint8_t* vt = sm.ptr(sm.derived(d, 1));
  uint8_t* vt_lo = sm.ptr(sm.derived(d, 2));
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const float4 x = k[i];
    const float xs[4] = {x.x, x.y, x.z, x.w};
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) split(xs[c], hi[c], lo[c]);
    k_lo[i] = make_float4(__uint_as_float(lo[0]), __uint_as_float(lo[1]), __uint_as_float(lo[2]),
                          __uint_as_float(lo[3]));
    const int e = lane & 7, j = (lane >> 3) + 4 * (it & 1), u = 2 * warp + (it >> 1);
    const float4 y = *reinterpret_cast<const float4*>(v + sw<kTile>(8 * j + e, 4 * u));  // dims 4 u .. 4 u + 3
    const float ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      uint32_t y_hi, y_lo;
      split(ys[c], y_hi, y_lo);
      const uint32_t off = sw<kTile>(4 * u + c, 8 * j + kpos(e));
      *reinterpret_cast<float*>(vt + off) = ys[c];
      *reinterpret_cast<uint32_t*>(vt_lo + off) = y_lo;
    }
  }
}

// Generic-proxy writes to shared memory before wgmma reads them.
__device__ __forceinline__ void fence_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Block: queries [q0, q0 + kRows) of one (batch, head).
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_fp32_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v, const Out o, float* __restrict__ lse, int H,
                      int L, int tiles, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  const Smem sm(smem_raw);
  const int tile = blockIdx.x % tiles;
  const int bh = blockIdx.x / tiles;
  const int b = bh / H, h = bh % H;
  const int q0 = tile * kRows;
  const int n_tiles = (L + kTile - 1) / kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    // Q once, then the first key tiles
    mbar_init(sm.bar_res(), 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(sm.bar_full(s), 1);
      mbar_init(sm.bar_empty(s), kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(sm.bar_res(), kResBytes);
    tma_load_4d(sm.q(0), map_q, sm.bar_res(), 0, q0, h, b);
    tma_load_4d(sm.q(0) + kRows * 128, map_q, sm.bar_res(), 64, q0, h, b);
    for (int t = 0; t < kStages && t < n_tiles; ++t) fill(sm, t, map_k, map_v, h, b);
  }

  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = 16 * warp + g;  // this thread's query rows r0, r0 + 8
  __syncthreads();  // the barriers are initialised
  mbar_wait(sm.bar_res(), 0);
  split_resident(sm.ptr(sm.q(0)), sm.ptr(sm.q(1)), scale_log2, threadIdx.x);  // Q in base-2 score units
  mbar_wait(sm.bar_full(0), 0);
  derive(sm, 0, 0, warp, lane);
  fence_async();
  __syncthreads();

  float acc[8][4], part[8][4], sc[8][4];  // O; the tile's P V; S, then P
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  }
  float m[2] = {-INFINITY, -INFINITY};  // running row maxima (base 2), the same across a quad
  float l[2] = {0.f, 0.f};              // this thread's share of the running row sums
  float (&s32)[32] = reinterpret_cast<float (&)[32]>(sc);
  float (&p32)[32] = reinterpret_cast<float (&)[32]>(part);
  const uint32_t q_hi = sm.q(0) + (warp >> 2) * 64 * 128, q_lo = sm.q(1) + (warp >> 2) * 64 * 128;
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages, d = t & 1;
    // S = Q K^T for this warpgroup's 64 rows
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      const uint64_t k_hi = kdesc<kTile>(sm.stage(0, s), ks), k_lo = kdesc<kTile>(sm.derived(d, 0), ks);
      wgmma_ss(s32, kdesc<kRows>(q_lo, ks), k_hi, ks > 0);
      wgmma_ss(s32, kdesc<kRows>(q_hi, ks), k_lo, 1);
      wgmma_ss(s32, kdesc<kRows>(q_hi, ks), k_hi, 1);
    }
    wgmma_commit();
    if (t + 1 < n_tiles) {
      // the next tile's derived set while S runs
      mbar_wait(sm.bar_full((t + 1) % kStages), ((t + 1) / kStages) & 1);
      derive(sm, (t + 1) % kStages, d ^ 1, warp, lane);
      fence_async();
    }
    wgmma_wait<0>();
    fence_regs(s32);
    mbar_arrive(sm.bar_empty(s));  // tile t is read: K by S, V by `derive`
    if (warp == 0 && t + kStages < n_tiles) {
      mbar_wait(sm.bar_empty(s), (t / kStages) & 1);
      if (lane == 0) fill(sm, t + kStages, map_k, map_v, h, b);
      __syncwarp();
    }
    const int key0 = t * kTile + 2 * t4;
    if (t * kTile + kTile > L) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (key0 + 8 * j + (i & 1) >= L) sc[j][i] = -INFINITY;
        }
      }
    }
    // every tile holds key t * kTile < L, so each row's new maximum is finite
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) mx[i >> 1] = fmaxf(mx[i >> 1], sc[j][i]);
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      corr[r] = ex2(m[r] - mx[r]);  // 0 on the first tile (m = -inf)
      m[r] = mx[r];
      l[r] *= corr[r];
    }
    Frag pf[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        sc[j][i] = ex2(sc[j][i] - m[i >> 1]);
        l[i >> 1] += sc[j][i];
      }
      pf[j] = acc_a(sc[j]);
    }
    // the tile's P V, from zero
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint64_t v_hi = kdesc<kTile>(sm.derived(d, 1), j), v_lo = kdesc<kTile>(sm.derived(d, 2), j);
      wgmma_rs(p32, pf[j].lo, v_hi, j > 0);
      wgmma_rs(p32, pf[j].hi, v_lo, 1);
      wgmma_rs(p32, pf[j].hi, v_hi, 1);
    }
    wgmma_commit();
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][i] *= corr[i >> 1];
    }
    wgmma_wait<0>();
    fence_regs(p32);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][i] += part[n][i];
    }
    __syncthreads();  // set d ^ 1 is written, set d read, by every warpgroup
  }

  float* base = o.p + b * o.sb + h * o.sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float sum = quad_sum(l[r]);
    const int row = q0 + r0 + 8 * r;
    if (row >= L) continue;
    const float inv = 1.f / sum;
    float* out = base + row * o.sl;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      out[(8 * n + 2 * t4) * o.sd] = acc[n][2 * r] * inv;
      out[(8 * n + 2 * t4 + 1) * o.sd] = acc[n][2 * r + 1] * inv;
    }
    if (lse != nullptr && t4 == 0) lse[static_cast<long long>(bh) * L + row] = m[r] * kLn2 + logf(sum);
  }
}

}  // namespace

// q, k, v: (B, H, L, 64) fp32 through element strides {batch, head, row,
// dim} each (dim stride 1, the others whole 16-byte units, 16-byte aligned
// bases); o: fp32 through element strides {batch, head, row, dim}; lse:
// contiguous fp32 (B, H, L), or null when no log-sum-exp is wanted.
// scale_log2 = log2(e) / 8.
extern "C" int svc_flash_attention_fp32_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, int B, int H, int L,
    long long qsb, long long qsh, long long qsl, long long qsd,
    long long ksb, long long ksh, long long ksl, long long ksd,
    long long vsb, long long vsh, long long vsl, long long vsd,
    long long osb, long long osh, long long osl, long long osd,
    float scale_log2, void* stream) {
  if (B < 0 || H < 0 || L < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0 || L == 0) return static_cast<int>(cudaSuccess);
  const int tiles = (L + kRows - 1) / kRows;
  const long long blocks = static_cast<long long>(tiles) * B * H;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const long long es[12] = {qsb, qsh, qsl, qsd, ksb, ksh, ksl, ksd, vsb, vsh, vsl, vsd};
  const void* const ptrs[3] = {q, k, v};
  CUtensorMap maps[3];
  cudaError_t err = cudaSuccess;
  for (int i = 0; i < 3 && err == cudaSuccess; ++i) {
    err = encode_fp32(&maps[i], ptrs[i], B, H, L, es + 4 * i, i == 0 ? kRows : kTile);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(flash_fwd_fp32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_fwd_fp32_kernel<<<static_cast<unsigned>(blocks), kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], Out{static_cast<float*>(o), osb, osh, osl, osd}, static_cast<float*>(lse), H, L,
      tiles, scale_log2);
  return static_cast<int>(cudaGetLastError());
}
