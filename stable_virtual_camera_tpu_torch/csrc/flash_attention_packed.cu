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
// does not translate: one block holding a 192 x W accumulator for W up to
// 1280 would need ~20x the registers of K1's tile, and a block per
// (query tile, batch) gives 18 blocks at the (1701, 2, 20) shape, too few
// for 132 SMs. Design: K1's Hopper tile (flash_fwd_sm90.cuh) on the packed
// layout:
//   * head h of row l is the 64 elements at column h * 64 of row l, so the
//     tensor maps take (row, head = 128 bytes, batch) byte strides and q, k,
//     v are read in place: the UNet's `qkv.chunk(3, -1)` views (row stride
//     3 W) need no copy;
//   * o is a fresh contiguous (B, L, W): each head writes its 64-column
//     slice of rows whose stride is W, the layout to_out consumes;
//   * the grid is K1's, (query tiles, B*H) with the query tile fastest, so
//     the blocks in flight together share one (batch, head)'s K and V in
//     L2. The earlier mma.sync tile put the head fastest, so that the
//     blocks in flight covered whole W-wide rows; on this tile that order
//     measured ~5% slower (PERF.md);
//   * no log-sum-exp: the JAX kernel has no VJP, and the port raises on a
//     gradient through K4 (ops/flash_attention_packed.py).

#include "flash_fwd_sm90.cuh"

namespace {

using namespace svc::sm90;

__global__ void __launch_bounds__(kThreads, 1)
flash_packed_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v, const FwdOut out, int H, int L,
                    float scale_log2) {
  // one block per (kBlockM-row query tile, batch * head), query tile fastest
  flash_fwd_sm90(map_q, map_k, map_v, out, blockIdx.y / H, blockIdx.y % H, blockIdx.x * kBlockM, H, L,
                 scale_log2);
}

}  // namespace

// q, k, v: (B, L, H * 64) bf16 given as byte strides {row, head = 128,
// batch} each (multiples of 16, columns contiguous, 16-byte aligned
// bases). o: bf16 through (batch, head, row) element strides (a contiguous
// (B, L, W) gives L W, 64, W). lse: unused, pass null.
extern "C" int svc_flash_attention_packed_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, int B, int H, int L,
    long long q_row, long long q_head, long long q_batch,
    long long k_row, long long k_head, long long k_batch,
    long long v_row, long long v_head, long long v_batch,
    long long osb, long long osh, long long osl,
    float scale_log2, void* stream) {
  const long long strides[9] = {q_row, q_head, q_batch, k_row, k_head, k_batch,
                                v_row, v_head, v_batch};
  const FwdOut out{static_cast<__nv_bfloat16*>(o), osb, osh, osl, static_cast<float*>(lse)};
  const int tiles = (L + kBlockM - 1) / kBlockM;
  return launch_fwd(flash_packed_kernel, dim3(tiles, B * H), q, k, v,
                    out, B, H, L, strides, scale_log2, stream);
}
