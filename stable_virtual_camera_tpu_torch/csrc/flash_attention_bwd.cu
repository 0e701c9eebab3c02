// K1-dKV and K1-dQ: the backward of K1 (non-causal flash attention, head
// dim 64, bf16 operands, fp32 accumulation).
//
// Replaces the two backward Pallas kernels behind the custom VJP of
// stable_virtual_camera_tpu/ops/flash_upstream.py::flash_attention_upstream_bhld
// (JAX's jax/experimental/pallas/ops/tpu/flash_attention.py:
// _flash_attention_bwd_dkv, kernel _flash_attention_dkv_kernel, and
// _flash_attention_bwd_dq, kernel _flash_attention_dq_kernel). With
// s = q.k / 8, P = exp(s - lse) from K1's log-sum-exp and D = rowsum(o dO)
// (a plain reduction in the caller, as upstream computes it outside its
// kernels):
//   dV = P^T dO,  dP = dO V^T,  dS = P (dP - D),  dK = dS^T Q / 8,  dQ = dS K / 8.
//
// What bounds them on an H100: the arithmetic. The pair recomputes S twice
// and does 7 products of L^2 64 per (batch, head) against K1's 2, so
// 14 L^2 64 B H FLOP (6.6 TFLOP at L = 27216, B*H = 10) against a few hundred
// MB of operands: the products must run on the tensor cores, and the score
// tiles must never reach device memory. Design (no atomics):
//   * K1-dKV: one block of 4 warps per (64-key tile, batch*head). The block
//     stages its K and V tile in shared memory once; each warp owns 16 keys,
//     keeps their K and V A-fragments in registers and accumulates dK and dV
//     (16 x 64 fp32 each) in registers over the whole query loop. Each step of
//     the loop stages a 64-row tile of Q and dO and the rows' lse and D in
//     shared memory, then computes S^T = K Q^T and dP^T = V dO^T with
//     mma.sync.m16n8k16 (bf16 -> fp32), P^T = exp2(S^T scale log2e -
//     lse log2e) and dS^T = P^T (dP^T - D) in fp32, and dV += P^T dO,
//     dK += dS^T Q, reusing the fp32 accumulators (rounded to bf16) as the A
//     operand and taking dO and Q as B operands through ldmatrix.trans.
//   * K1-dQ: one block per (64-row query tile, batch*head). Each warp owns
//     16 query rows, keeps their Q and dO fragments, lse and D in registers,
//     and accumulates dQ over the key loop: S = Q K^T, dP = dO V^T, dS, then
//     dQ += dS K with K through ldmatrix.trans.
//   * The ragged edge is handled as in K1: tiles past L are zero-filled in
//     shared memory; query rows past L get lse = +inf (so P = 0) and D = 0,
//     keys past L get P = 0 in K1-dQ; rows past L are never stored.
//   * All operands are read, and dq/dk/dv written, through (batch, head, row)
//     strides with a contiguous head dim: the UNet's packed-qkv views.
// Left for later: double buffering of the staged tiles and wgmma.

#include <math.h>

#include "flash_common.cuh"

namespace {

using namespace svc;

constexpr float kLog2e = 1.4426950408889634f;

// Stage src[row0 .. row0 + 64) * mul into shared memory, `pad` past L.
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src, int row0, int L,
                                              float mul, float pad) {
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    dst[r] = row0 + r < L ? src[row0 + r] * mul : pad;
  }
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                     int H, int L,
                     long long qsb, long long qsh, long long qsl,
                     long long ksb, long long ksh, long long ksl,
                     long long vsb, long long vsh, long long vsl,
                     long long dosb, long long dosh, long long dosl,
                     long long dksb, long long dksh, long long dksl,
                     long long dvsb, long long dvsh, long long dvsl,
                     float scale) {
  __shared__ __align__(16) __nv_bfloat16 sK[kTile][kLds];
  __shared__ __align__(16) __nv_bfloat16 sV[kTile][kLds];
  __shared__ __align__(16) __nv_bfloat16 sQ[kTile][kLds];
  __shared__ __align__(16) __nv_bfloat16 sdO[kTile][kLds];
  __shared__ float sLse[kTile];  // log2 domain
  __shared__ float sD[kTile];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int k0 = blockIdx.x * kTile;
  const float scale_log2 = scale * kLog2e;

  const __nv_bfloat16* qb = q + b * qsb + h * qsh;
  const __nv_bfloat16* dob = dout + b * dosb + h * dosh;
  const float* lseb = lse + (long long)blockIdx.y * L;
  const float* db = delta + (long long)blockIdx.y * L;

  load_tile(sK, k + b * ksb + h * ksh, ksl, k0, L);
  load_tile(sV, v + b * vsb + h * vsh, vsl, k0, L);
  __syncthreads();

  const int r0 = warp * 16 + g;  // this warp's keys within the tile
  uint32_t ka[4][4], va[4][4];
  load_a_rows(ka, sK, r0, t4);
  load_a_rows(va, sV, r0, t4);

  float dK[8][4], dV[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    dK[n][0] = dK[n][1] = dK[n][2] = dK[n][3] = 0.f;
    dV[n][0] = dV[n][1] = dV[n][2] = dV[n][3] = 0.f;
  }

  for (int q0 = 0; q0 < L; q0 += kTile) {
    __syncthreads();  // every warp is done with the previous query tile
    load_tile(sQ, qb, qsl, q0, L);
    load_tile(sdO, dob, dosl, q0, L);
    load_rows_f32(sLse, lseb, q0, L, kLog2e, INFINITY);
    load_rows_f32(sD, db, q0, L, 1.f, 0.f);
    __syncthreads();

    // P^T = exp2(S^T scale log2e - lse log2e): rows = this warp's 16 keys,
    // columns = 64 queries (n-tile n holds queries n*8 + 2 t4 + {0, 1})
    float p[8][4];
    mma_a_xt(p, ka, sQ, g, t4);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float l2 = sLse[n * 8 + t4 * 2 + j];
        p[n][j] = exp2f(p[n][j] * scale_log2 - l2);
        p[n][2 + j] = exp2f(p[n][2 + j] * scale_log2 - l2);
      }
    }
    // dV += P^T dO
    mma_c_y(dV, p, sdO, lane);

    // dS^T = P^T (dP^T - D), dP^T = V dO^T
    float ds[8][4];
    mma_a_xt(ds, va, sdO, g, t4);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float dd = sD[n * 8 + t4 * 2 + j];
        ds[n][j] = p[n][j] * (ds[n][j] - dd);
        ds[n][2 + j] = p[n][2 + j] * (ds[n][2 + j] - dd);
      }
    }
    // dK += dS^T Q (scaled at the store)
    mma_c_y(dK, ds, sQ, lane);
  }

  const int key0 = k0 + r0;
  store_rows(dk + b * dksb + h * dksh, dksl, dK, key0, L, scale, t4);
  store_rows(dv + b * dvsb + h * dvsh, dvsl, dV, key0, L, 1.f, t4);
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int H, int L,
                    long long qsb, long long qsh, long long qsl,
                    long long ksb, long long ksh, long long ksl,
                    long long vsb, long long vsh, long long vsl,
                    long long dosb, long long dosh, long long dosl,
                    long long dqsb, long long dqsh, long long dqsl,
                    float scale) {
  __shared__ __align__(16) __nv_bfloat16 sQ[kTile][kLds];
  __shared__ __align__(16) __nv_bfloat16 sdO[kTile][kLds];
  __shared__ __align__(16) __nv_bfloat16 sK[kTile][kLds];
  __shared__ __align__(16) __nv_bfloat16 sV[kTile][kLds];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int q0 = blockIdx.x * kTile;
  const float scale_log2 = scale * kLog2e;

  const __nv_bfloat16* kb = k + b * ksb + h * ksh;
  const __nv_bfloat16* vb = v + b * vsb + h * vsh;

  load_tile(sQ, q + b * qsb + h * qsh, qsl, q0, L);
  load_tile(sdO, dout + b * dosb + h * dosh, dosl, q0, L);
  __syncthreads();

  const int r0 = warp * 16 + g;
  uint32_t qa[4][4], doa[4][4];
  load_a_rows(qa, sQ, r0, t4);
  load_a_rows(doa, sdO, r0, t4);
  // rows q0 + r0 and q0 + r0 + 8: lse in the log2 domain, D
  const int row0 = q0 + r0;
  const float* lseb = lse + (long long)blockIdx.y * L;
  const float* db = delta + (long long)blockIdx.y * L;
  const float lse0 = row0 < L ? lseb[row0] * kLog2e : INFINITY;
  const float lse1 = row0 + 8 < L ? lseb[row0 + 8] * kLog2e : INFINITY;
  const float d0 = row0 < L ? db[row0] : 0.f;
  const float d1 = row0 + 8 < L ? db[row0 + 8] : 0.f;

  float dQ[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    dQ[n][0] = dQ[n][1] = dQ[n][2] = dQ[n][3] = 0.f;
  }

  for (int k0 = 0; k0 < L; k0 += kTile) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile(sK, kb, ksl, k0, L);
    load_tile(sV, vb, vsl, k0, L);
    __syncthreads();

    // P = exp2(S scale log2e - lse log2e), keys >= L masked to 0
    float p[8][4];
    mma_a_xt(p, qa, sK, g, t4);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool valid = k0 + n * 8 + t4 * 2 + j < L;
        p[n][j] = valid ? exp2f(p[n][j] * scale_log2 - lse0) : 0.f;
        p[n][2 + j] = valid ? exp2f(p[n][2 + j] * scale_log2 - lse1) : 0.f;
      }
    }
    // dS = P (dP - D), dP = dO V^T
    float ds[8][4];
    mma_a_xt(ds, doa, sV, g, t4);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      ds[n][0] = p[n][0] * (ds[n][0] - d0);
      ds[n][1] = p[n][1] * (ds[n][1] - d0);
      ds[n][2] = p[n][2] * (ds[n][2] - d1);
      ds[n][3] = p[n][3] * (ds[n][3] - d1);
    }
    // dQ += dS K (scaled at the store)
    mma_c_y(dQ, ds, sK, lane);
  }

  store_rows(dq + b * dqsb + h * dqsh, dqsl, dQ, row0, L, scale, t4);
}

}  // namespace

// q, k, v, dout, dk, dv: (B, H, L, 64) bf16 addressed through (batch, head,
// row) element strides, head dim contiguous, 16-byte aligned rows; lse (K1's
// natural-log log-sum-exp) and delta (rowsum(o dout)): contiguous fp32
// (B, H, L); scale: the softmax scale 1/sqrt(64).
extern "C" int svc_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int H, int L,
    long long qsb, long long qsh, long long qsl,
    long long ksb, long long ksh, long long ksl,
    long long vsb, long long vsh, long long vsl,
    long long dosb, long long dosh, long long dosl,
    long long dksb, long long dksh, long long dksl,
    long long dvsb, long long dvsh, long long dvsl,
    float scale, void* stream) {
  dim3 grid((L + kTile - 1) / kTile, B * H);
  flash_bwd_dkv_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), H, L,
      qsb, qsh, qsl, ksb, ksh, ksl, vsb, vsh, vsl, dosb, dosh, dosl,
      dksb, dksh, dksl, dvsb, dvsh, dvsl, scale);
  return static_cast<int>(cudaGetLastError());
}

// As above; writes dq with its own (batch, head, row) strides.
extern "C" int svc_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int B, int H, int L,
    long long qsb, long long qsh, long long qsl,
    long long ksb, long long ksh, long long ksl,
    long long vsb, long long vsh, long long vsl,
    long long dosb, long long dosh, long long dosl,
    long long dqsb, long long dqsh, long long dqsl,
    float scale, void* stream) {
  dim3 grid((L + kTile - 1) / kTile, B * H);
  flash_bwd_dq_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq), H, L,
      qsb, qsh, qsl, ksb, ksh, ksl, vsb, vsh, vsl, dosb, dosh, dosl,
      dqsb, dqsh, dqsl, scale);
  return static_cast<int>(cudaGetLastError());
}
