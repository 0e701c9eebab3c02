// K2's entry for every input the Hopper K2 (time_attention.cu, bf16 at
// head dim 64 with S contiguous) does not take: temporal attention over the
// frame axis at any head dim D, in fp32, bf16 or fp16, through any strides.
//
// Replaces the other inputs of stable_virtual_camera_tpu/ops/
// time_attention.py::time_attention_bhds (its Pallas TPU kernel `_kernel`),
// which takes any head dim and any float dtype. For every (scene, head,
// spatial position s) and each query frame t of the scene's T <= 32 frames,
//     p_t = softmax_u(q[t, :, s] . k[u, :, s] / sqrt(D)),   o[t, :, s] = sum_u p_tu v[u, :, s]
// on the (b*T, H, D, S) layout. All arithmetic is fp32, as in the TPU kernel;
// only o is rounded to the input dtype.
//
// What bounds it on an H100: bytes. A (scene, head, position) does 4 T^2 D
// FLOP on 4 T D values, T / 2 FLOP per value: under the fp32 ridge of
// 67 TFLOP/s / 3.35 TB/s = 20 FLOP a byte at every T <= 32 once a value is
// 4 bytes, and at 2 bytes up to T = 20. Design, simple first:
//   * a block is one (scene, head) and a tile of 32 positions: warp t is
//     query frame t (T warps), lane i position s0 + i;
//   * a thread keeps its T <= Tc scores in registers (Tc, the key-frame
//     ceiling, one of 4, 8, 16, 32: one instantiation each);
//   * k, then v, pass through shared memory in chunks of kC = 8 channels for
//     all T frames; warp t loads frame t's rows of the chunk (lane i its
//     position, coalesced where S is contiguous), and every warp reads all
//     frames' rows of it, lanes on neighbouring words (no bank conflicts);
//     a thread reads its own q values of the chunk straight from memory;
//   * the softmax runs in registers (exp2f of log2(e)-scaled scores, at
//     full precision), then o is summed chunk by chunk and stored in the
//     input dtype. Positions past S are read as 0 and not stored; channels
//     past D are read as 0.

#include <cuda_fp16.h>

#include "flash_common.cuh"

namespace {

constexpr int kP = 32;  // positions a block (a warp's lanes)
constexpr int kC = 8;   // channels of k or v a shared-memory chunk

template <typename E>
__device__ __forceinline__ float to_f32(E x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) { return __bfloat162float(x); }
template <>
__device__ __forceinline__ float to_f32<__half>(__half x) { return __half2float(x); }

template <typename E>
__device__ __forceinline__ E from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half_rn(x); }

struct Strides {
  long long st, sh, sd, ss;  // element strides: frame, head, channel, position
};

template <typename E>
struct Ops {
  const E* q;
  const E* k;
  const E* v;
  E* o;
  Strides sq, sk, sv, so;
};

template <typename E, int Tc>
__global__ void __launch_bounds__(kP * Tc)
time_any_kernel(const Ops<E> ops, int T, int H, int D, int S, int tiles, float scale_log2) {
  __shared__ float buf[Tc][kC][kP];
  const int tile = blockIdx.x % tiles;
  const int sh_ = blockIdx.x / tiles;  // scene * H + head
  const int scene = sh_ / H, h = sh_ % H;
  const int t = threadIdx.x / kP, lane = threadIdx.x % kP;
  const int s = tile * kP + lane;
  const bool live = s < S;
  const long long frame = static_cast<long long>(scene) * T + t;  // this warp's frame
  const E* qrow = ops.q + frame * ops.sq.st + h * ops.sq.sh + s * ops.sq.ss;

  float sc[Tc];
#pragma unroll
  for (int u = 0; u < Tc; ++u) sc[u] = 0.f;

  // scores: q[t] . k[u] over the channels, a chunk of kC at a time
  for (int d0 = 0; d0 < D; d0 += kC) {
    __syncthreads();  // the previous chunk is consumed
    const E* krow = ops.k + frame * ops.sk.st + h * ops.sk.sh + s * ops.sk.ss;
    float qc[kC];
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const bool in = live && d0 + c < D;
      buf[t][c][lane] = in ? to_f32(krow[(d0 + c) * ops.sk.sd]) : 0.f;
      qc[c] = in ? to_f32(qrow[(d0 + c) * ops.sq.sd]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kC; ++c) {
#pragma unroll
      for (int u = 0; u < Tc; ++u) {
        if (u < T) sc[u] = fmaf(qc[c], buf[u][c][lane], sc[u]);
      }
    }
  }

  // softmax over the key frames, in registers
  float m = -INFINITY;
#pragma unroll
  for (int u = 0; u < Tc; ++u) {
    if (u < T) m = fmaxf(m, sc[u] * scale_log2);
  }
  float l = 0.f;
#pragma unroll
  for (int u = 0; u < Tc; ++u) {
    sc[u] = u < T ? exp2f(sc[u] * scale_log2 - m) : 0.f;
    l += sc[u];
  }
#pragma unroll
  for (int u = 0; u < Tc; ++u) sc[u] = sc[u] / l;

  // o[t] = sum_u p_u v[u], a chunk of kC channels at a time
  E* orow = ops.o + frame * ops.so.st + h * ops.so.sh + s * ops.so.ss;
  for (int d0 = 0; d0 < D; d0 += kC) {
    __syncthreads();
    const E* vrow = ops.v + frame * ops.sv.st + h * ops.sv.sh + s * ops.sv.ss;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const bool in = live && d0 + c < D;
      buf[t][c][lane] = in ? to_f32(vrow[(d0 + c) * ops.sv.sd]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      float acc = 0.f;
#pragma unroll
      for (int u = 0; u < Tc; ++u) {
        if (u < T) acc = fmaf(sc[u], buf[u][c][lane], acc);
      }
      if (live && d0 + c < D) orow[(d0 + c) * ops.so.sd] = from_f32<E>(acc);
    }
  }
}

template <typename E, int Tc>
cudaError_t launch(const Ops<E>& ops, int b, int T, int H, int D, int S, float scale_log2,
                   cudaStream_t stream) {
  const int tiles = (S + kP - 1) / kP;
  const long long blocks = static_cast<long long>(tiles) * b * H;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  time_any_kernel<E, Tc><<<static_cast<unsigned>(blocks), kP * T, 0, stream>>>(ops, T, H, D, S, tiles,
                                                                               scale_log2);
  return cudaGetLastError();
}

template <typename E>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, const Strides (&st)[4], int b,
                     int T, int H, int D, int S, float scale_log2, cudaStream_t stream) {
  const Ops<E> ops{static_cast<const E*>(q), static_cast<const E*>(k), static_cast<const E*>(v),
                   static_cast<E*>(o), st[0], st[1], st[2], st[3]};
  if (T <= 4) return launch<E, 4>(ops, b, T, H, D, S, scale_log2, stream);
  if (T <= 8) return launch<E, 8>(ops, b, T, H, D, S, scale_log2, stream);
  if (T <= 16) return launch<E, 16>(ops, b, T, H, D, S, scale_log2, stream);
  return launch<E, 32>(ops, b, T, H, D, S, scale_log2, stream);
}

}  // namespace

// q, k, v, o: (b*T, H, D, S) of one dtype (0 fp32, 1 bf16, 2 fp16)
// addressed through (frame, head, channel, position) element strides;
// 1 <= T <= 32. scale_log2 = log2(e) / sqrt(D).
extern "C" int svc_time_attention_any_fwd(
    const void* q, const void* k, const void* v, void* o, int b, int T, int H, int D, int S,
    long long qst, long long qsh, long long qsd, long long qss,
    long long kst, long long ksh, long long ksd, long long kss,
    long long vst, long long vsh, long long vsd, long long vss,
    long long ost, long long osh, long long osd, long long oss,
    float scale_log2, int dtype, void* stream) {
  if (T < 1 || T > 32 || b < 0 || H < 0 || D < 0 || S < 0 || dtype < 0 || dtype > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || H == 0 || D == 0 || S == 0) return static_cast<int>(cudaSuccess);
  const Strides st[4] = {{qst, qsh, qsd, qss}, {kst, ksh, ksd, kss}, {vst, vsh, vsd, vss}, {ost, osh, osd, oss}};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0: err = dispatch<float>(q, k, v, o, st, b, T, H, D, S, scale_log2, s); break;
    case 1: err = dispatch<__nv_bfloat16>(q, k, v, o, st, b, T, H, D, S, scale_log2, s); break;
    default: err = dispatch<__half>(q, k, v, o, st, b, T, H, D, S, scale_log2, s); break;
  }
  return static_cast<int>(err);
}
