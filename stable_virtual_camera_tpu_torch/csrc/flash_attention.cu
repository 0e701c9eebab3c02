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
// cores at wgmma's rate. The tile is the Hopper one of flash_fwd_sm90.cuh
// (TMA ring of 128-key tiles, a producer warpgroup and three wgmma consumer
// warpgroups of 64 query rows), shared with K3 and K4. This file gives it
// K1's operands and grid:
//   * q, k, v are (B, H, L, 64) views read through (batch, head, row)
//     strides with a contiguous head dim, so the UNet passes strided views
//     of its packed (B, L, 3, H, 64) projection and nothing is copied;
//   * o is written through its strides: the UNet's is a (B, H, L, 64) view
//     of a (B, L, H, 64) buffer, which to_out reads as (B, L, H*64);
//   * when the caller passes an lse buffer (training), the epilogue also
//     writes each row's log-sum-exp, m ln2 + ln l in natural-log units, for
//     the backward kernels in flash_attention_bwd.cu;
//   * the grid is (query tiles, B*H) with the query tile fastest, so the
//     blocks in flight together share one (batch, head)'s K and V in L2.

#include "flash_fwd_sm90.cuh"

namespace {

using namespace svc::sm90;

__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v, const FwdOut out, int H, int L,
                 float scale_log2) {
  flash_fwd_sm90(map_q, map_k, map_v, out, blockIdx.y / H, blockIdx.y % H, blockIdx.x * kBlockM, H,
                 L, scale_log2);
}

}  // namespace

// q, k, v: (B, H, L, 64) bf16 with byte strides {row, head, batch} each
// (multiples of 16, head dim contiguous, 16-byte aligned bases). o: bf16
// through (batch, head, row) element strides. lse: contiguous fp32
// (B, H, L), or null when no log-sum-exp is wanted.
extern "C" int svc_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, int B, int H, int L,
    long long q_row, long long q_head, long long q_batch,
    long long k_row, long long k_head, long long k_batch,
    long long v_row, long long v_head, long long v_batch,
    long long osb, long long osh, long long osl,
    float scale_log2, void* stream) {
  const long long strides[9] = {q_row, q_head, q_batch, k_row, k_head, k_batch,
                                v_row, v_head, v_batch};
  const FwdOut out{static_cast<__nv_bfloat16*>(o), osb, osh, osl, static_cast<float*>(lse)};
  return launch_fwd(flash_fwd_kernel, dim3((L + kBlockM - 1) / kBlockM, B * H), q, k, v, out, B, H,
                    L, strides, scale_log2, stream);
}
