// K1: non-causal flash attention forward, head dim 64, bf16 in and out.
//
// Replaces stable_virtual_camera_tpu/ops/flash_upstream.py::
// flash_attention_upstream_bhld (JAX's Pallas TPU flash kernel behind a pad
// and a segment-id mask). Computes o = softmax(q k^T / 8) v for every
// (batch, head) over L query and L key rows, with the softmax in fp32.
//
// What bounds it on an H100: the arithmetic. One 576x576 UNet forward does
// about 20 TFLOP here (4 L^2 64 H B per layer, L up to 27216), against a few
// hundred MB of q/k/v traffic, so the products have to run on the tensor
// cores. Design:
//   * one block of 4 warps per (64-row query tile, batch*head); each warp owns
//     16 query rows and keeps their Q fragments and the 16x64 fp32 output
//     accumulator in registers for the whole key loop;
//   * the loop walks 64-key tiles of K and V staged in shared memory (rows
//     padded to 72 elements so the fragment loads hit 32 distinct banks);
//   * S = Q K^T and O += P V both use mma.sync.m16n8k16 bf16 -> fp32; the S
//     accumulator layout is reused directly as the A operand of P V, and V's
//     B operand comes from ldmatrix.trans;
//   * the softmax is online, in fp32 with exp2f (the 1/8 scale is folded into
//     log2(e)); P is rounded to bf16 only as the P V operand, the row sums
//     stay fp32;
//   * the ragged edge is handled here: keys >= L score -inf (their tiles are
//     zero-filled), query rows >= L are not stored. No padded copies.
//   * q, k, v and o are read and written through (batch, head, row) strides
//     with a contiguous head dimension, so the caller can pass views of the
//     packed qkv projection and take the output as (B, L, H, 64);
//   * when the caller passes an lse buffer (training), the epilogue also
//     writes each row's log-sum-exp, m ln2 + ln l in natural-log units, for
//     the backward kernels in flash_attention_bwd.cu.
// Left for later: cp.async/TMA double buffering and wgmma.

#include <math.h>

#include "flash_common.cuh"

namespace {

using namespace svc;

constexpr int kBQ = kTile;  // query rows per block (4 warps x 16)
constexpr int kBK = kTile;  // keys per tile

__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int H, int L,
                 long long qsb, long long qsh, long long qsl,
                 long long ksb, long long ksh, long long ksl,
                 long long vsb, long long vsh, long long vsl,
                 long long osb, long long osh, long long osl,
                 float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 sQ[kBQ][kLds];
  __shared__ __align__(16) __nv_bfloat16 sK[kBK][kLds];
  __shared__ __align__(16) __nv_bfloat16 sV[kBK][kLds];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // fragment row group
  const int t4 = lane & 3;   // thread within the group
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int q0 = blockIdx.x * kBQ;

  const __nv_bfloat16* qb = q + b * qsb + h * qsh;
  const __nv_bfloat16* kb = k + b * ksb + h * ksh;
  const __nv_bfloat16* vb = v + b * vsb + h * vsh;
  __nv_bfloat16* ob = o + b * osb + h * osh;

  load_tile(sQ, qb, qsl, q0, L);
  __syncthreads();

  // A fragments of this warp's 16 query rows, 4 k-steps over the head dim.
  const int r0 = warp * 16 + g;
  uint32_t qa[4][4];
  load_a_rows(qa, sQ, r0, t4);

  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  }
  // running max (log2 domain) and per-thread partial row sums, rows g and g+8
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int k0 = 0; k0 < L; k0 += kBK) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile(sK, kb, ksl, k0, L);
    load_tile(sV, vb, vsl, k0, L);
    __syncthreads();

    // S = Q K^T for 16 rows x 64 keys: 8 n-tiles of 8 keys.
    float s[8][4];
    mma_a_xt(s, qa, sK, g, t4);

    // scale into the log2 domain, mask keys >= L, tile row max
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool valid = k0 + n * 8 + t4 * 2 + j < L;
        s[n][j] = valid ? s[n][j] * scale_log2 : -INFINITY;
        s[n][2 + j] = valid ? s[n][2 + j] * scale_log2 : -INFINITY;
        mx0 = fmaxf(mx0, s[n][j]);
        mx1 = fmaxf(mx1, s[n][2 + j]);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // every tile holds at least one valid key, so the new max is finite
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    const float corr0 = exp2f(m0 - mn0);
    const float corr1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = exp2f(s[n][0] - m0);
      s[n][1] = exp2f(s[n][1] - m0);
      s[n][2] = exp2f(s[n][2] - m1);
      s[n][3] = exp2f(s[n][3] - m1);
      rs0 += s[n][0] + s[n][1];
      rs1 += s[n][2] + s[n][3];
    }
    l0 = l0 * corr0 + rs0;
    l1 = l1 * corr1 + rs1;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      acc[n][0] *= corr0;
      acc[n][1] *= corr0;
      acc[n][2] *= corr1;
      acc[n][3] *= corr1;
    }

    // O += P V: the S accumulators of n-tiles 2kk and 2kk+1 are exactly
    // the A fragment of k-step kk (4 k-steps of 16 keys).
    mma_c_y(acc, s, sV, lane);
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0;
  const float inv1 = 1.f / l1;
  const int row0 = q0 + r0;
  const int row1 = row0 + 8;
  if (lse != nullptr && t4 == 0) {
    // log-sum-exp in natural-log units: ln(2^m * l) with m in the base-2,
    // scale-folded domain of the loop
    constexpr float kLn2 = 0.6931471805599453f;
    if (row0 < L) lse[(long long)blockIdx.y * L + row0] = m0 * kLn2 + logf(l0);
    if (row1 < L) lse[(long long)blockIdx.y * L + row1] = m1 * kLn2 + logf(l1);
  }
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int d = n * 8 + t4 * 2;
    if (row0 < L) {
      *reinterpret_cast<__nv_bfloat162*>(ob + row0 * osl + d) =
          __floats2bfloat162_rn(acc[n][0] * inv0, acc[n][1] * inv0);
    }
    if (row1 < L) {
      *reinterpret_cast<__nv_bfloat162*>(ob + row1 * osl + d) =
          __floats2bfloat162_rn(acc[n][2] * inv1, acc[n][3] * inv1);
    }
  }
}

}  // namespace

// q, k, v, o: (B, H, L, 64) bf16 addressed through (batch, head, row) element
// strides, head dim contiguous; base pointers and strides 16-byte aligned.
// lse: contiguous fp32 (B, H, L), or null when no log-sum-exp is wanted.
extern "C" int svc_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, int B, int H, int L,
    long long qsb, long long qsh, long long qsl,
    long long ksb, long long ksh, long long ksl,
    long long vsb, long long vsh, long long vsl,
    long long osb, long long osh, long long osl,
    float scale_log2, void* stream) {
  dim3 grid((L + kBQ - 1) / kBQ, B * H);
  flash_fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), H, L,
      qsb, qsh, qsl, ksb, ksh, ksl, vsb, vsh, vsl, osb, osh, osl, scale_log2);
  return static_cast<int>(cudaGetLastError());
}
