// K3: non-causal flash attention forward on the (B, L, H, 64) layout, head
// dim 64, bf16 in and out.
//
// Replaces stable_virtual_camera_tpu/ops/flash_attention.py::flash_attention
// (the in-repo Pallas kernel `_flash_kernel`), which computes the same
// function as K1 with a base-2 online softmax and an iota mask on the key
// tail, after transposing q, k, v to (B*H, L, D) and padding L to its block.
//
// What bounds it on an H100: the arithmetic, as for K1 (4 L^2 64 B H FLOP
// against 4 B L H 64 bf16 values moved). Design: K1's Hopper tile
// (flash_fwd_sm90.cuh) and grid, given this layout:
//   * q, k, v are (B, L, H, 64) views whose tensor maps take (row, head,
//     batch) byte strides from the wrapper. In the UNet's generic path they
//     are `qkv.chunk(3, -1)` of one (B, L, 3 H 64) projection, so their row
//     stride is 3 H 64 and nothing is transposed, padded or copied;
//   * o is a fresh contiguous (B, L, H, 64), so `o.reshape(B, L, H * 64)`
//     feeds to_out with no copy;
//   * no log-sum-exp: the JAX kernel has no backward, and the port's
//     recompute backward (ops/flash_attention.py) does not need one.

#include "flash_fwd_sm90.cuh"

namespace {

using namespace svc::sm90;

__global__ void __launch_bounds__(kThreads, 1)
flash_blhd_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                  const __grid_constant__ CUtensorMap map_v, const FwdOut out, int H, int L,
                  float scale_log2) {
  // one block per (kBlockM-row query tile, batch * head)
  flash_fwd_sm90(map_q, map_k, map_v, out, blockIdx.y / H, blockIdx.y % H, blockIdx.x * kBlockM, H,
                 L, scale_log2);
}

}  // namespace

// q, k, v: (B, L, H, 64) bf16 given as byte strides {row, head, batch} each
// (multiples of 16, head dim contiguous, 16-byte aligned bases). o: bf16
// through (batch, head, row) element strides (a contiguous (B, L, H, 64)
// gives L H 64, 64, H 64). lse: unused, pass null.
extern "C" int svc_flash_attention_blhd_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, int B, int H, int L,
    long long q_row, long long q_head, long long q_batch,
    long long k_row, long long k_head, long long k_batch,
    long long v_row, long long v_head, long long v_batch,
    long long osb, long long osh, long long osl,
    float scale_log2, void* stream) {
  const long long strides[9] = {q_row, q_head, q_batch, k_row, k_head, k_batch,
                                v_row, v_head, v_batch};
  const FwdOut out{static_cast<__nv_bfloat16*>(o), osb, osh, osl, static_cast<float*>(lse)};
  return launch_fwd(flash_blhd_kernel, dim3((L + kBlockM - 1) / kBlockM, B * H), q, k, v, out, B,
                    H, L, strides, scale_log2, stream);
}
