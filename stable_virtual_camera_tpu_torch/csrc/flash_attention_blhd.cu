// K3: non-causal flash attention forward on the (B, L, H, 64) layout, head
// dim 64, bf16 in and out.
//
// Replaces stable_virtual_camera_tpu/ops/flash_attention.py::flash_attention
// (the in-repo Pallas kernel `_flash_kernel`), which computes the same
// function as K1 with a base-2 online softmax and an iota mask on the key
// tail, after transposing q, k, v to (B*H, L, D) and padding L to its block.
//
// What bounds it on an H100: the arithmetic, as for K1 (4 L^2 64 B H FLOP
// against 4 B L H 64 bf16 values moved). Design: the tensor-core tile of
// K1 (`flash_fwd_tile` in flash_common.cuh: 4 warps x 16 query rows, 64-key
// K/V tiles in shared memory, mma.sync, fp32 online softmax with exp2f,
// bf16 P for P V, keys >= L masked and rows >= L not stored), given this
// layout instead of K1's:
//   * q, k, v are (B, L, H, 64) views read through (batch, row, head)
//     strides with a contiguous head dim. In the UNet's generic path they
//     are `qkv.chunk(3, -1)` of one (B, L, 3 H 64) projection, so their row
//     stride is 3 H 64 and nothing is transposed, padded or copied;
//   * o is a fresh contiguous (B, L, H, 64), so `o.reshape(B, L, H * 64)`
//     feeds to_out with no copy;
//   * no log-sum-exp: the JAX kernel has no backward, and the port's
//     recompute backward (ops/flash_attention.py) does not need one.
// Left for later, as for K1: cp.async/TMA double buffering and wgmma.

#include "flash_common.cuh"

namespace {

using namespace svc;

struct LayoutBLHD {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  long long qsb, qsl, qsh, ksb, ksl, ksh, vsb, vsl, vsh;
  int H, L;

  __device__ FlashSlab slab(int b, int h) const {
    // o: contiguous (B, L, H, 64)
    const long long osl = (long long)H * kD;
    return {q + b * qsb + h * qsh, k + b * ksb + h * ksh, v + b * vsb + h * vsh,
            o + b * osl * L + h * kD, qsl, ksl, vsl, osl};
  }
};

__global__ void __launch_bounds__(kThreads)
flash_blhd_kernel(LayoutBLHD layout, float scale_log2) {
  // one block per (64-row query tile, batch * head)
  flash_fwd_tile(layout, blockIdx.y / layout.H, blockIdx.y % layout.H, blockIdx.x * kTile,
                 layout.L, scale_log2, nullptr);
}

}  // namespace

// q, k, v: (B, L, H, 64) bf16 addressed through (batch, row, head) element
// strides, head dim contiguous; base pointers and strides 16-byte aligned.
// o: contiguous bf16 (B, L, H, 64).
extern "C" int svc_flash_attention_blhd_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int H, int L,
    long long qsb, long long qsl, long long qsh,
    long long ksb, long long ksl, long long ksh,
    long long vsb, long long vsl, long long vsh,
    float scale_log2, void* stream) {
  const LayoutBLHD layout{
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      qsb, qsl, qsh, ksb, ksl, ksh, vsb, vsl, vsh, H, L};
  dim3 grid((L + kTile - 1) / kTile, B * H);
  flash_blhd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(layout,
                                                                             scale_log2);
  return static_cast<int>(cudaGetLastError());
}
