// The fp32 entries of K1-dKV and K1-dQ: the backward of K1 on fp32
// operands, head dim 64, every product in full fp32 (FFMA).
//
// Replaces the fp32 inputs of the two backward Pallas kernels behind the
// custom VJP of stable_virtual_camera_tpu/ops/flash_upstream.py::
// flash_attention_upstream_bhld (jax/experimental/pallas/ops/tpu/
// flash_attention.py: _flash_attention_bwd_dkv and _flash_attention_bwd_dq),
// which take fp32 as well as bf16; the Hopper pair of flash_attention_bwd.cu
// is bf16 wgmma only. With s = q.k / 8, P = exp(s - lse) from K1's
// natural-log log-sum-exp and D = rowsum(o dO) (less a gradient on the lse,
// folded in by the caller as for the bf16 pair):
//   dV = P^T dO,  dP = dO V^T,  dS = P (dP - D),  dK = dS^T Q / 8,  dQ = dS K / 8.
//
// What bounds them on an H100: the arithmetic at the fp32 rate outside the
// tensor cores (67 TFLOP/s): 8 L^2 64 FLOP per (batch, head) in K1-dKV and
// 6 L^2 64 in K1-dQ (S and dP are recomputed in each), against a few fp32
// (L, 64) operands. TF32 would keep about three digits, so every product is
// an FFMA. Design, simple first, one layout for both kernels:
//   * a row (a key in K1-dKV, a query in K1-dQ) belongs to a PAIR of
//     neighbouring threads, each holding 32 of its 64 dims in registers as
//     eight float4 units, interleaved (unit 2 i + half), so the pair's two
//     reads of one shared row fall in different banks; a dot product is the
//     pair's two halves summed with one shuffle;
//   * a block is 128 threads, 64 rows of one (batch, head); blocks walk a
//     1-D grid with the row tile fastest;
//   * the other side's rows pass through shared memory in tiles of 64 rows
//     (K1-dKV: q and dO with their lse and D; K1-dQ: k and v), loaded by
//     the whole block with coalesced reads through element strides, and
//     are read by every pair at once (a broadcast);
//   * rows are taken kSub = 8 at a time, so a thread has 16 independent
//     dot products in flight before the shuffles;
//   * K1-dKV keeps k, v, dk and dv (128 registers); K1-dQ keeps q, dO and dq
//     (96). Queries past L get p = 0 (no share of dV, dK), keys past L get
//     p = 0 (no share of dQ). No atomics: each output row is written once,
//     by its pair, through its (batch, head, row) element strides with a
//     contiguous head dim, so two launches give the same bits.

#include "flash_common.cuh"

namespace {

using svc::kD;

constexpr int kThreads = 128;
constexpr int kRowsPerBlock = kThreads / 2;  // a pair a row
constexpr int kTile = 64;                    // the other side's rows a shared tile
constexpr int kSub = 8;
constexpr int kUnits = kD / 8;               // float4 units a thread holds: 8
constexpr float kLog2e = 1.4426950408889634f;

struct View {
  const float* p;
  long long sb, sh, sl, sd;  // element strides: batch, head, row, dim
};

struct Out {
  float* p;
  long long sb, sh, sl;  // element strides: batch, head, row (dim contiguous)
};

__device__ __forceinline__ float at(const View& t, int b, int h, int l, int d) {
  return __ldg(t.p + b * t.sb + h * t.sh + l * t.sl + d * t.sd);
}

// This thread's half of a row: units 2 i + half, i < kUnits, in registers.
__device__ __forceinline__ void load_half(float4 (&r)[kUnits], const View& t, int b, int h, int row,
                                          int half, bool live, float scale) {
#pragma unroll
  for (int i = 0; i < kUnits; ++i) {
    const int d = 4 * (2 * i + half);
    r[i] = live ? make_float4(at(t, b, h, row, d) * scale, at(t, b, h, row, d + 1) * scale,
                              at(t, b, h, row, d + 2) * scale, at(t, b, h, row, d + 3) * scale)
                : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

__device__ __forceinline__ void store_half(const float4 (&r)[kUnits], const Out& t, int b, int h,
                                           int row, int half, float scale) {
  float* out = t.p + b * t.sb + h * t.sh + row * t.sl;
#pragma unroll
  for (int i = 0; i < kUnits; ++i) {
    const int d = 4 * (2 * i + half);
    out[d] = r[i].x * scale;
    out[d + 1] = r[i].y * scale;
    out[d + 2] = r[i].z * scale;
    out[d + 3] = r[i].w * scale;
  }
}

__device__ __forceinline__ float dot_half(const float4 (&r)[kUnits], const float* row, int half) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kUnits; ++i) {
    const float4 x = reinterpret_cast<const float4*>(row)[2 * i + half];
    s = fmaf(r[i].x, x.x, s);
    s = fmaf(r[i].y, x.y, s);
    s = fmaf(r[i].z, x.z, s);
    s = fmaf(r[i].w, x.w, s);
  }
  return s;
}

__device__ __forceinline__ void axpy_half(float4 (&r)[kUnits], float a, const float* row, int half) {
#pragma unroll
  for (int i = 0; i < kUnits; ++i) {
    const float4 x = reinterpret_cast<const float4*>(row)[2 * i + half];
    r[i].x = fmaf(a, x.x, r[i].x);
    r[i].y = fmaf(a, x.y, r[i].y);
    r[i].z = fmaf(a, x.z, r[i].z);
    r[i].w = fmaf(a, x.w, r[i].w);
  }
}

// Copy rows r0 .. r0 + kTile of two (B, H, L, 64) views into shared tiles
// (rows past L as 0).
__device__ __forceinline__ void load_tiles(float (&a)[kTile][kD], float (&c)[kTile][kD], const View& va,
                                           const View& vc, int b, int h, int r0, int L) {
  for (int i = threadIdx.x; i < kTile * kD; i += kThreads) {
    const int j = i / kD, d = i % kD;
    const bool in = r0 + j < L;
    a[j][d] = in ? at(va, b, h, r0 + j, d) : 0.f;
    c[j][d] = in ? at(vc, b, h, r0 + j, d) : 0.f;
  }
}

// One block: 64 keys of one (batch, head); the queries stream through.
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_fp32_kernel(View q, View k, View v, View dout, const float* lse, const float* delta,
                          Out dk, Out dv, int H, int L, int tiles, float scale) {
  __shared__ __align__(16) float qs[kTile][kD];
  __shared__ __align__(16) float dos[kTile][kD];
  __shared__ float lse_s[kTile], delta_s[kTile];
  const int tile = blockIdx.x % tiles;
  const int bh = blockIdx.x / tiles;
  const int b = bh / H, h = bh % H;
  const int half = threadIdx.x & 1;
  const int row = tile * kRowsPerBlock + (threadIdx.x >> 1);
  const bool live = row < L;
  const float* lse_bh = lse + static_cast<long long>(bh) * L;
  const float* delta_bh = delta + static_cast<long long>(bh) * L;

  float4 kr[kUnits], vr[kUnits], dkr[kUnits], dvr[kUnits];
  load_half(kr, k, b, h, row, half, live, scale * kLog2e);  // scores in base 2
  load_half(vr, v, b, h, row, half, live, 1.f);
#pragma unroll
  for (int i = 0; i < kUnits; ++i) {
    dkr[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    dvr[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int q0 = 0; q0 < L; q0 += kTile) {
    __syncthreads();
    load_tiles(qs, dos, q, dout, b, h, q0, L);
    for (int j = threadIdx.x; j < kTile; j += kThreads) {
      const bool in = q0 + j < L;
      lse_s[j] = in ? lse_bh[q0 + j] * kLog2e : INFINITY;  // p = 0 past L
      delta_s[j] = in ? delta_bh[q0 + j] : 0.f;
    }
    __syncthreads();
#pragma unroll 1
    for (int j0 = 0; j0 < kTile; j0 += kSub) {
      float s[kSub], dp[kSub];
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        s[j] = dot_half(kr, qs[j0 + j], half);
        dp[j] = dot_half(vr, dos[j0 + j], half);
      }
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        s[j] += __shfl_xor_sync(0xffffffffu, s[j], 1);
        dp[j] += __shfl_xor_sync(0xffffffffu, dp[j], 1);
      }
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const float p = exp2f(s[j] - lse_s[j0 + j]);
        axpy_half(dvr, p, dos[j0 + j], half);
        axpy_half(dkr, p * (dp[j] - delta_s[j0 + j]), qs[j0 + j], half);
      }
    }
  }
  if (!live) return;
  store_half(dkr, dk, b, h, row, half, scale);
  store_half(dvr, dv, b, h, row, half, 1.f);
}

// One block: 64 queries of one (batch, head); the keys stream through.
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_fp32_kernel(View q, View k, View v, View dout, const float* lse, const float* delta,
                         Out dq, int H, int L, int tiles, float scale) {
  __shared__ __align__(16) float ks[kTile][kD];
  __shared__ __align__(16) float vs[kTile][kD];
  const int tile = blockIdx.x % tiles;
  const int bh = blockIdx.x / tiles;
  const int b = bh / H, h = bh % H;
  const int half = threadIdx.x & 1;
  const int row = tile * kRowsPerBlock + (threadIdx.x >> 1);
  const bool live = row < L;
  const long long at_row = static_cast<long long>(bh) * L + row;
  const float lse2 = live ? lse[at_row] * kLog2e : 0.f;
  const float d_row = live ? delta[at_row] : 0.f;

  float4 qr[kUnits], dor[kUnits], dqr[kUnits];
  load_half(qr, q, b, h, row, half, live, scale * kLog2e);
  load_half(dor, dout, b, h, row, half, live, 1.f);
#pragma unroll
  for (int i = 0; i < kUnits; ++i) dqr[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int k0 = 0; k0 < L; k0 += kTile) {
    __syncthreads();
    load_tiles(ks, vs, k, v, b, h, k0, L);
    __syncthreads();
#pragma unroll 1
    for (int j0 = 0; j0 < kTile; j0 += kSub) {
      float s[kSub], dp[kSub];
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        s[j] = dot_half(qr, ks[j0 + j], half);
        dp[j] = dot_half(dor, vs[j0 + j], half);
      }
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        s[j] += __shfl_xor_sync(0xffffffffu, s[j], 1);
        dp[j] += __shfl_xor_sync(0xffffffffu, dp[j], 1);
      }
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const float p = k0 + j0 + j < L ? exp2f(s[j] - lse2) : 0.f;
        axpy_half(dqr, p * (dp[j] - d_row), ks[j0 + j], half);
      }
    }
  }
  if (!live) return;
  store_half(dqr, dq, b, h, row, half, scale);
}

cudaError_t grid_of(int B, int H, int L, int* tiles, unsigned* blocks) {
  *tiles = (L + kRowsPerBlock - 1) / kRowsPerBlock;
  const long long n = static_cast<long long>(*tiles) * B * H;
  if (n > 0x7fffffffLL) return cudaErrorInvalidValue;
  *blocks = static_cast<unsigned>(n);
  return cudaSuccess;
}

}  // namespace

// q, k, v, dout: (B, H, L, 64) fp32 through element strides {batch, head,
// row, dim} each; lse (K1's natural-log log-sum-exp) and delta (rowsum(o
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
  int tiles;
  unsigned blocks;
  const cudaError_t err = grid_of(B, H, L, &tiles, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkv_fp32_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      View{static_cast<const float*>(q), qsb, qsh, qsl, qsd},
      View{static_cast<const float*>(k), ksb, ksh, ksl, ksd},
      View{static_cast<const float*>(v), vsb, vsh, vsl, vsd},
      View{static_cast<const float*>(dout), dsb, dsh, dsl, dsd},
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      Out{static_cast<float*>(dk), dksb, dksh, dksl}, Out{static_cast<float*>(dv), dvsb, dvsh, dvsl},
      H, L, tiles, scale);
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
  int tiles;
  unsigned blocks;
  const cudaError_t err = grid_of(B, H, L, &tiles, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_fp32_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      View{static_cast<const float*>(q), qsb, qsh, qsl, qsd},
      View{static_cast<const float*>(k), ksb, ksh, ksl, ksd},
      View{static_cast<const float*>(v), vsb, vsh, vsl, vsd},
      View{static_cast<const float*>(dout), dsb, dsh, dsl, dsd},
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      Out{static_cast<float*>(dq), dqsb, dqsh, dqsl}, H, L, tiles, scale);
  return static_cast<int>(cudaGetLastError());
}
