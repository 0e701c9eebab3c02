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
// The tile itself is `flash_fwd_tile` in flash_common.cuh, shared with K3
// (flash_attention_blhd.cu) and K4 (flash_attention_packed.cu); this file
// gives it K1's layout. Left for later: cp.async/TMA double buffering and
// wgmma.

#include "flash_common.cuh"

namespace {

using namespace svc;

// K1's layout: q, k, v, o as (B, H, L, 64) through (batch, head, row)
// element strides.
struct LayoutBHLD {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  long long qsb, qsh, qsl, ksb, ksh, ksl, vsb, vsh, vsl, osb, osh, osl;

  __device__ FlashSlab slab(int b, int h) const {
    return {q + b * qsb + h * qsh, k + b * ksb + h * ksh, v + b * vsb + h * vsh,
            o + b * osb + h * osh, qsl, ksl, vsl, osl};
  }
};

__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(LayoutBHLD layout, float* __restrict__ lse, int H, int L, float scale_log2) {
  // one block per (64-row query tile, batch * head)
  flash_fwd_tile(layout, blockIdx.y / H, blockIdx.y % H, blockIdx.x * kTile, L, scale_log2,
                 lse != nullptr ? lse + (long long)blockIdx.y * L : nullptr);
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
  const LayoutBHLD layout{
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      qsb, qsh, qsl, ksb, ksh, ksl, vsb, vsh, vsl, osb, osh, osl};
  dim3 grid((L + kTile - 1) / kTile, B * H);
  flash_fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      layout, static_cast<float*>(lse), H, L, scale_log2);
  return static_cast<int>(cudaGetLastError());
}
