// K2: temporal (time-mix) attention over the frame axis, bf16 in and out.
//
// Replaces stable_virtual_camera_tpu/ops/time_attention.py::
// time_attention_bhds (its Pallas TPU kernel `_kernel`, reached through
// `_kernel_call`). For every (scene, head, spatial position s) it computes,
// for each query frame t of the scene's T <= 32 frames,
//     p_t = softmax_u(q[t, :, s] . k[u, :, s] / 8),   o[t, :, s] = sum_u p_tu v[u, :, s]
// on the (b*T, H, 64, S) layout with S contiguous. All arithmetic is fp32, as
// in the TPU kernel.
//
// What bounds it on an H100: memory. Each (scene, head, s) is a tiny 21x21x64
// problem (about 6 GFLOP per 576x576 ds1 layer in all) against 0.56 GB of
// q/k/v/o traffic, far below the ~295 FLOP/byte where the tensor cores would
// matter. Design: a block owns 32 neighbouring positions of one (scene, head)
// and has one warp per query frame (blockDim = 32 x T, lanes = positions).
// The block first stages k for all T frames of its 32 positions in shared
// memory (T x 64 rows of 64 contiguous bytes, coalesced), so each k element
// crosses device memory once instead of once per query frame. Each thread then
// scores its query frame against the T key frames, with the scores in
// registers (the frame loop is unrolled to 32 and masked at run time). The
// same shared buffer is then refilled with v for the P V sum. Shared memory
// is T * 4 KB (84 KB at T = 21); offsets are 32-bit.
// A block of up to 1024 threads gets at most 64 registers a thread, so one
// block fits an SM and little else hides the latency of device memory: the
// staging loop and the q reads therefore issue kBatch independent loads
// before using any of them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kD = 64;
constexpr int kMaxT = 32;
constexpr int kLanes = 32;  // positions per block
constexpr int kBatch = 8;   // loads in flight per thread while staging

// Stage rows (frame u, channel d) of 32 positions into sm[(u * 64 + d) * 32 + lane],
// kBatch rows per warp at a time: all their loads issue before the first store.
__device__ __forceinline__ void stage(__nv_bfloat16* sm, const __nv_bfloat16* base,
                                      long long st, long long sd, int T, bool valid) {
  const int rows = T * kD;
  for (int r0 = threadIdx.y; r0 < rows; r0 += kBatch * blockDim.y) {
    __nv_bfloat16 v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int r = r0 + j * blockDim.y;
      v[j] = (valid && r < rows) ? base[(r / kD) * st + (r % kD) * sd] : __float2bfloat16(0.f);
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int r = r0 + j * blockDim.y;
      if (r < rows) sm[r * kLanes + threadIdx.x] = v[j];
    }
  }
}

__global__ void __launch_bounds__(kLanes * kMaxT)
time_attn_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, int T, int S,
                 long long qst, long long qsh, long long qsd,
                 long long kst, long long ksh, long long ksd,
                 long long vst, long long vsh, long long vsd,
                 long long ost, long long osh, long long osd, float scale) {
  extern __shared__ __nv_bfloat16 sm[];  // T * 64 * 32
  const int lane = threadIdx.x;
  const int t = threadIdx.y;  // this thread's query frame
  const int s = blockIdx.x * kLanes + lane;
  const bool valid = s < S;
  const int h = blockIdx.y;
  const long long f0 = (long long)blockIdx.z * T;  // first frame of the scene
  const __nv_bfloat16* qb = q + f0 * qst + h * qsh + s;
  const __nv_bfloat16* kb = k + f0 * kst + h * ksh + s;
  const __nv_bfloat16* vb = v + f0 * vst + h * vsh + s;

  stage(sm, kb, kst, ksd, T, valid);
  __syncthreads();

  float sc[kMaxT];
#pragma unroll
  for (int u = 0; u < kMaxT; ++u) sc[u] = 0.f;
  for (int d0 = 0; d0 < kD; d0 += 4) {
    float qd[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      qd[j] = valid ? __bfloat162float(qb[t * qst + (d0 + j) * qsd]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int u = 0; u < kMaxT; ++u) {
        if (u < T) sc[u] += qd[j] * __bfloat162float(sm[(u * kD + d0 + j) * kLanes + lane]);
      }
    }
  }
  float m = -INFINITY;
#pragma unroll
  for (int u = 0; u < kMaxT; ++u) {
    if (u < T) {
      sc[u] *= scale;
      m = fmaxf(m, sc[u]);
    }
  }
  float sum = 0.f;
#pragma unroll
  for (int u = 0; u < kMaxT; ++u) {
    if (u < T) {
      sc[u] = expf(sc[u] - m);
      sum += sc[u];
    }
  }
  const float inv = 1.f / sum;
#pragma unroll
  for (int u = 0; u < kMaxT; ++u) sc[u] *= inv;

  __syncthreads();  // every thread is done with k
  stage(sm, vb, vst, vsd, T, valid);
  __syncthreads();

  __nv_bfloat16* ob = o + (f0 + t) * ost + h * osh + s;
  for (int d = 0; d < kD; ++d) {
    float acc = 0.f;
#pragma unroll
    for (int u = 0; u < kMaxT; ++u) {
      if (u < T) acc += sc[u] * __bfloat162float(sm[(u * kD + d) * kLanes + lane]);
    }
    if (valid) ob[d * osd] = __float2bfloat16(acc);
  }
}

}  // namespace

extern "C" const char* svc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q, k, v, o: (b*T, H, 64, S) bf16 addressed through (frame, head, channel)
// element strides, S contiguous. T <= 32.
extern "C" int svc_time_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int b, int T, int H, int S,
    long long qst, long long qsh, long long qsd,
    long long kst, long long ksh, long long ksd,
    long long vst, long long vsh, long long vsd,
    long long ost, long long osh, long long osd,
    float scale, void* stream) {
  if (T < 1 || T > kMaxT) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = T * kD * kLanes * static_cast<int>(sizeof(__nv_bfloat16));
  cudaError_t err = cudaFuncSetAttribute(
      time_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxT * kD * kLanes * 2);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + kLanes - 1) / kLanes, H, b);
  time_attn_kernel<<<grid, dim3(kLanes, T), smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), T, S,
      qst, qsh, qsd, kst, ksh, ksd, vst, vsh, vsd, ost, osh, osd, scale);
  return static_cast<int>(cudaGetLastError());
}
