// K4: non-causal flash attention forward on the head-packed (B, L, W) layout,
// W = H * 64, bf16 in and out.
//
// Replaces stable_virtual_camera_tpu/ops/flash_attention_packed.py::
// flash_attention_packed (the Pallas kernel `_flash_packed_kernel`), which
// computes the same function as K1 and K3 on (B, L, W) directly: each TPU
// program takes a (q_block, W) slab of every head at once, loops over the
// heads' 64-lane slices, and writes the (B, L, W) output that to_out reads.
//
// What bounds it on an H100: the arithmetic, as for K1 (4 L^2 64 B H FLOP
// against 4 B L W bf16 values moved). A TPU program's slab of all heads
// does not translate: one block holding a 64 x W accumulator for W up to
// 1280 would need ~20x the registers of K1's tile, and a block per
// (query tile, batch) gives 54 blocks at the (1701, 2, 20) shape, too few
// for 132 SMs. Design: K1's tensor-core tile (`flash_fwd_tile` in
// flash_common.cuh) given the packed layout:
//   * head h of row l is the 64 elements at column h * 64 of row l; q, k, v
//     are read in place through (batch, row) strides, so the UNet's
//     `qkv.chunk(3, -1)` views (row stride 3 W) need no copy;
//   * o is a fresh contiguous (B, L, W): each head writes its 64-column
//     slice of rows whose stride is W, the layout to_out consumes;
//   * the grid puts the head fastest, (H, query tiles, B), so the blocks in
//     flight together cover whole W-wide rows of a few query tiles, and
//     their K/V tile loads walk the same key rows of every head;
//   * no log-sum-exp: the JAX kernel has no VJP, and the port raises on a
//     gradient through K4 (ops/flash_attention_packed.py).
// Left for later, as for K1: cp.async/TMA double buffering and wgmma.

#include "flash_common.cuh"

namespace {

using namespace svc;

struct LayoutPacked {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  long long qsb, qsl, ksb, ksl, vsb, vsl;
  int H, L;

  __device__ FlashSlab slab(int b, int h) const {
    // o: contiguous (B, L, W)
    const long long W = (long long)H * kD;
    const long long col = (long long)h * kD;
    return {q + b * qsb + col, k + b * ksb + col, v + b * vsb + col, o + b * W * L + col,
            qsl, ksl, vsl, W};
  }
};

__global__ void __launch_bounds__(kThreads)
flash_packed_kernel(LayoutPacked layout, float scale_log2) {
  // one block per (head, 64-row query tile, batch), head fastest
  flash_fwd_tile(layout, blockIdx.z, blockIdx.x, blockIdx.y * kTile, layout.L, scale_log2,
                 nullptr);
}

}  // namespace

// q, k, v: (B, L, H * 64) bf16 addressed through (batch, row) element
// strides, columns contiguous; base pointers and strides 16-byte aligned.
// o: contiguous bf16 (B, L, H * 64).
extern "C" int svc_flash_attention_packed_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int H, int L,
    long long qsb, long long qsl, long long ksb, long long ksl, long long vsb, long long vsl,
    float scale_log2, void* stream) {
  const LayoutPacked layout{
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      qsb, qsl, ksb, ksl, vsb, vsl, H, L};
  dim3 grid(H, (L + kTile - 1) / kTile, B);
  flash_packed_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(layout,
                                                                               scale_log2);
  return static_cast<int>(cudaGetLastError());
}
