// K5: LayerNorm over the last axis with one-pass fp32 statistics.
//
// Replaces benchmark/ln_probe.py::ln_pallas (its Pallas TPU kernel
// `_ln_kernel`). For every row x of width C it computes, exactly as the TPU
// kernel does,
//     mean = sum(x) / C,  msq = sum(x^2) / C,  var = max(msq - mean^2, 0),
//     y = (x - mean) * rsqrt(var + eps) * gamma + beta,
// in fp32, and writes y in x's dtype (bf16 or fp32).
//
// What bounds it on an H100: memory. Each element is read once and written
// once (4 bytes a bf16 element) against ~8 fp32 operations, far below the
// card's operations-per-byte balance. Design: one warp per row, 8 rows per
// block. Each lane loads pairs of elements (bf16x2, or float2) strided by 32
// pairs over the row, so a warp's load is one contiguous 128-byte (bf16)
// segment, and keeps them in registers while it accumulates sum(x) and
// sum(x^2) in fp32. A __shfl_xor_sync butterfly gives every lane the row's
// sums; the lane then normalises its pairs from registers and writes them
// once. Nothing is staged in shared memory and no block synchronises. The
// TPU kernel's 1152-row blocks have no counterpart: a warp owns a row, and
// the grid covers any row count. Widths: C even, up to kMaxWidth (the UNet's
// 320, 640 and 1280 included); the register array is sized by a template
// bound on pairs per lane chosen from C at launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // rows per block
constexpr int kMaxWidth = 2048;

template <typename T>
struct Pair;
template <>
struct Pair<__nv_bfloat16> {
  using type = __nv_bfloat162;
  static __device__ __forceinline__ float2 load(const type* p) { return __bfloat1622float2(*p); }
  static __device__ __forceinline__ void store(type* p, float2 v) { *p = __float22bfloat162_rn(v); }
};
template <>
struct Pair<float> {
  using type = float2;
  static __device__ __forceinline__ float2 load(const type* p) { return *p; }
  static __device__ __forceinline__ void store(type* p, float2 v) { *p = v; }
};

template <typename T, int kPairsPerLane>
__global__ void __launch_bounds__(32 * kWarps)
layer_norm_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                  const T* __restrict__ beta, T* __restrict__ y, long long rows, int C,
                  float eps) {
  using P = Pair<T>;
  using PT = typename P::type;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps only, so the shuffles below stay full
  const int pairs = C / 2;
  const PT* xr = reinterpret_cast<const PT*>(x + row * C);
  PT* yr = reinterpret_cast<PT*>(y + row * C);
  const PT* g = reinterpret_cast<const PT*>(gamma);
  const PT* b = reinterpret_cast<const PT*>(beta);

  float2 v[kPairsPerLane];
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < kPairsPerLane; ++i) {
    const int p = i * 32 + lane;
    if (p < pairs) {
      v[i] = P::load(xr + p);
      s1 += v[i].x + v[i].y;
      s2 += v[i].x * v[i].x + v[i].y * v[i].y;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    s2 += __shfl_xor_sync(0xffffffffu, s2, off);
  }
  const float mean = s1 / C;
  const float msq = s2 / C;
  const float rstd = rsqrtf(fmaxf(msq - mean * mean, 0.f) + eps);
#pragma unroll
  for (int i = 0; i < kPairsPerLane; ++i) {
    const int p = i * 32 + lane;
    if (p < pairs) {
      const float2 gv = P::load(g + p);
      const float2 bv = P::load(b + p);
      P::store(yr + p, make_float2((v[i].x - mean) * rstd * gv.x + bv.x,
                                   (v[i].y - mean) * rstd * gv.y + bv.y));
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* g, const void* b, void* y, long long rows, int C,
                   float eps, cudaStream_t stream) {
  const long long blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks)), block(32 * kWarps);
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  const T* bt = static_cast<const T*>(b);
  T* yt = static_cast<T*>(y);
  // pairs per lane: ceil(C / 64), rounded up to one of three register budgets
  if (C <= 512) {
    layer_norm_kernel<T, 8><<<grid, block, 0, stream>>>(xt, gt, bt, yt, rows, C, eps);
  } else if (C <= 1024) {
    layer_norm_kernel<T, 16><<<grid, block, 0, stream>>>(xt, gt, bt, yt, rows, C, eps);
  } else {
    layer_norm_kernel<T, 32><<<grid, block, 0, stream>>>(xt, gt, bt, yt, rows, C, eps);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* svc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x, y: (rows, C) contiguous; gamma, beta: (C,); all of one dtype
// (0 = bf16, 1 = fp32). C even, 2 <= C <= 2048; pointers aligned to a pair.
extern "C" int svc_layer_norm_fwd(const void* x, const void* gamma, const void* beta, void* y,
                                  long long rows, int C, int dtype, float eps, void* stream) {
  if (C < 2 || C > kMaxWidth || C % 2 || rows < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<__nv_bfloat16>(x, gamma, beta, y, rows, C, eps, s);
  } else if (dtype == 1) {
    err = launch<float>(x, gamma, beta, y, rows, C, eps, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
