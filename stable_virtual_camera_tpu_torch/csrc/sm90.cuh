// Hopper device primitives shared by the forward tile (flash_fwd_sm90.cuh:
// K1, K3, K4), the backward kernels (flash_attention_bwd.cu: K1-dKV, K1-dQ),
// the temporal attention (time_attention.cu: K2; time_attention_any.cu: its
// entry for any head dim and dtype) and the LayerNorm
// (layer_norm.cu: K5): shared-memory addresses, mbarriers with a wait that
// traps, 4-D TMA loads, 1-D bulk copies and cp.async copies that complete on
// an mbarrier, 128-byte-swizzle wgmma descriptors, the wgmma products the
// tiles use (bf16 in, fp32 accumulators), the accumulator-to-A-fragment
// identity, and the host-side tensor maps.
//
// wgmma accumulator layout (m64nNk16, one warpgroup): warp w holds rows
// 16 w + g and 16 w + g + 8 (g = lane / 4, t4 = lane % 4); register 4 j + e
// is row g, column 8 j + 2 t4 + e, and 4 j + 2 + e is row g + 8. That is the
// m16n8k16 C fragment per n-tile, so the columns 16 kk .. 16 kk + 15 of an
// accumulator are exactly the A fragment of k-step kk of a following RS
// product (`pack_a`).

#pragma once

#include <cuda.h>

#include <map>
#include <mutex>
#include <tuple>

#include "flash_common.cuh"

namespace svc {
namespace sm90 {

constexpr int kRowBytes = kD * 2;  // one bf16 row of 64 = 128 B, one swizzle row

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of `bar` with this parity has completed. A wait that
// polls 2^26 times (far longer than any load or tile takes) traps, so a
// broken ring faults with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One box of a 4-D tensor map into shared memory; completion (the box's
// full byte count, zero-filled parts included) is reported to `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap& map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// An L2 cache policy that evicts first what it covers: for data read or
// written once, so that a stream does not displace what L2 holds for others.
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

// A 1-D bulk copy (TMA without a tensor map) of `bytes` contiguous bytes
// from device memory into shared memory under the L2 cache `policy`;
// completion is reported to `bar`. Both addresses must be 16-byte aligned
// and `bytes` a multiple of 16.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar,
                                          uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "l"(policy)
      : "memory");
}

// An asynchronous copy of N (4, 8 or 16) bytes from device memory into
// shared memory, both addresses N-byte aligned, tracked per thread.
template <int N>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src) {
  static_assert(N == 4 || N == 8 || N == 16, "cp.async copies 4, 8 or 16 bytes");
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst), "l"(src), "n"(N) : "memory");
}

// cp_async that copies the first `src_bytes` (N or 0) and zero-fills the
// rest: with 0 nothing is read from `src`.
template <int N>
__device__ __forceinline__ void cp_async_zfill(uint32_t dst, const void* src, uint32_t src_bytes) {
  static_assert(N == 4 || N == 8 || N == 16, "cp.async copies 4, 8 or 16 bytes");
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src), "n"(N), "r"(src_bytes)
               : "memory");
}

// An arrive on `bar` once every cp.async this thread issued before it has
// landed. It does not add to the barrier's pending count, so the barrier's
// expected count includes this thread.
__device__ __forceinline__ void cp_async_arrive_noinc(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(bar) : "memory");
}

// A wgmma shared-memory descriptor for a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (in 16-byte units), layout 1 =
// SWIZZLE_128B. K-major tiles ignore the leading offset; the stride offset
// is the step between 8-row groups (8 x 128 B).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N of this warpgroup's committed wgmma groups are still
// running (groups complete in the order they were committed).
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accesses of accumulator registers across an
// asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d (64 x 128, fp32) = (scale_d ? d : 0) + A . B^T with A (64 x 16) and B
// (128 x 16) both K-major in shared memory (descriptors).
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t desc_a,
                                                    uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 64, fp32) += A . B with A (64 x 16 bf16) in registers (the
// m16n8k16 A fragment per warp) and B (16 x 64) MN-major in shared memory.
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 64, fp32) = A . B^T (kAccumulate false) or d + A . B^T, with A
// (64 x 16) and B (64 x 16) both K-major in shared memory (descriptors). The
// first form takes no input from d, so d's earlier values are dead before
// the product.
#define SVC_ACC32(c)                                                                           \
  c(d[0]), c(d[1]), c(d[2]), c(d[3]), c(d[4]), c(d[5]), c(d[6]), c(d[7]), c(d[8]), c(d[9]),    \
      c(d[10]), c(d[11]), c(d[12]), c(d[13]), c(d[14]), c(d[15]), c(d[16]), c(d[17]),          \
      c(d[18]), c(d[19]), c(d[20]), c(d[21]), c(d[22]), c(d[23]), c(d[24]), c(d[25]),          \
      c(d[26]), c(d[27]), c(d[28]), c(d[29]), c(d[30]), c(d[31])
#define SVC_M64N64K16_SS                                                                       \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"                                     \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"                      \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"             \
  "}, %32, %33, p, 1, 1, 0, 0;\n"
template <bool kAccumulate>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a,
                                                   uint64_t desc_b) {
  if constexpr (kAccumulate) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" SVC_M64N64K16_SS "}\n"
                 : SVC_ACC32("+f") : "l"(desc_a), "l"(desc_b), "r"(1));
  } else {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" SVC_M64N64K16_SS "}\n"
                 : SVC_ACC32("=f") : "l"(desc_a), "l"(desc_b), "r"(0));
  }
}
#undef SVC_M64N64K16_SS
#undef SVC_ACC32

// The A fragments of KS k-steps of 16 columns from an fp32 accumulator of
// 8 KS columns, rounded to bf16: k-step kk is the columns of n-tiles 2 kk
// and 2 kk + 1.
template <int KS>
__device__ __forceinline__ void pack_a(uint32_t (&p)[KS][4], const float (&s)[8 * KS]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) p[kk][i] = pack_bf16x2(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
  }
}


// Host side. How many blocks of `kernel` with `threads` threads and `smem`
// bytes of dynamic shared memory fit on the current device at once, raising
// the kernel's shared-memory limit to `max_smem` on first use; remembered
// per device, kernel, block size and shared memory (the persistent grids of
// K2 and K5).
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int threads, int smem, int max_smem, int* blocks) {
  static std::mutex mu;
  static std::map<std::tuple<int, const void*, int, int>, int> known;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(dev, reinterpret_cast<const void*>(kernel), threads, smem);
  const auto it = known.find(key);
  if (it != known.end()) {
    *blocks = it->second;
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = known[key] = per_sm * sms;
  return cudaSuccess;
}

// cuTensorMapEncodeTiled is a driver function; it is looked up
// through the runtime, so the libraries need no -lcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The tensor map of a 4-D view of `dtype` (bf16 unless named): dims
// innermost first (the first contiguous), byte strides of the other three
// (multiples of 16), box in elements, zero fill out of bounds.
inline cudaError_t encode_4d(CUtensorMap* map, const void* base, const cuuint64_t (&dims)[4],
                             const cuuint64_t (&bytes)[3], const cuuint32_t (&box)[4],
                             CUtensorMapSwizzle swizzle,
                             CUtensorMapDataType dtype = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  static EncodeTiledFn encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                                              &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiledFn>(fn);
  }
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, dtype, 4, const_cast<void*>(base), dims,
                            bytes, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The tensor map of one flash operand: dims {64, L, H, B}, byte strides
// {row, head, batch}, box {64, box_rows, 1, 1}, 128-byte swizzle.
inline cudaError_t encode_map(CUtensorMap* map, const void* base, int B, int H, int L,
                              const long long strides[3], int box_rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(kD), static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t bytes[3] = {static_cast<cuuint64_t>(strides[0]),
                               static_cast<cuuint64_t>(strides[1]),
                               static_cast<cuuint64_t>(strides[2])};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kD), static_cast<cuuint32_t>(box_rows), 1, 1};
  return encode_4d(map, base, dims, bytes, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace sm90
}  // namespace svc
