// The fp32 entry of K1, K3 and K4: non-causal flash attention forward, head
// dim 64, fp32 in and out, every product in full fp32 (FFMA).
//
// Replaces the fp32 inputs of stable_virtual_camera_tpu/ops/flash_upstream.py::
// flash_attention_upstream_bhld (K1), ops/flash_attention.py::flash_attention
// (K3) and ops/flash_attention_packed.py::flash_attention_packed (K4). Their
// Pallas kernels take fp32 as well as bf16; the Hopper tile of
// flash_fwd_sm90.cuh is bf16 wgmma only, so fp32 operands come here. It
// computes o = softmax(q k^T / 8) v for every (batch, head) over L query and
// L key rows, with the softmax in fp32, and, when the caller passes an lse
// buffer, each row's log-sum-exp in natural-log units (m ln2 + ln l), as K1's
// epilogue writes it for the backward.
//
// What bounds it on an H100: the arithmetic, at the fp32 rate outside the
// tensor cores (67 TFLOP/s): 4 L^2 64 FLOP per (batch, head) against 4 L 64
// fp32 values moved. TF32 products (495 TFLOP/s) keep about three digits,
// too few for an fp32 entry, so every product is an FFMA. Design, simple
// first:
//   * a block is kRows = 128 threads, one query row each, for one (batch,
//     head); blocks walk a 1-D grid with the query tile fastest, so the
//     blocks in flight together share one (batch, head)'s K and V in L2;
//   * a thread keeps its q row (scaled by scale * log2 e) and its fp32
//     output accumulator in registers, 128 of them;
//   * K and V pass through shared memory in tiles of kKeys = 64 rows,
//     loaded by the whole block with coalesced reads through the views'
//     element strides (keys past L read as 0); every thread reads the same
//     shared row at once, a broadcast;
//   * a thread scores kSub = 16 keys into registers, takes their maximum,
//     rescales its accumulator once, then adds p v for the 16 keys (base-2
//     online softmax, exp2f at full precision); keys past L score -inf;
//   * o = acc / l is written through the output's element strides; rows
//     past L are neither read nor written.
// Any (batch, head, row, dim) strides are taken, so K1's (B, H, L, 64) views
// of a packed projection, K3's (B, L, H, 64) and K4's packed (B, L, H 64)
// all come in without a copy.

#include "flash_common.cuh"

namespace {

using svc::kD;

constexpr int kRows = 128;  // query rows a block, one a thread
constexpr int kKeys = 64;   // keys a shared-memory tile
constexpr int kSub = 16;    // keys scored at once in registers
constexpr float kLn2 = 0.69314718055994531f;

struct View {
  const float* p;
  long long sb, sh, sl, sd;  // element strides: batch, head, row, dim
};

__device__ __forceinline__ float at(const View& t, int b, int h, int l, int d) {
  return __ldg(t.p + b * t.sb + h * t.sh + l * t.sl + d * t.sd);
}

__global__ void __launch_bounds__(kRows)
flash_fwd_fp32_kernel(View q, View k, View v, float* o, long long osb, long long osh, long long osl,
                      long long osd, float* lse, int H, int L, int tiles, float scale_log2) {
  __shared__ __align__(16) float ks[kKeys][kD];
  __shared__ __align__(16) float vs[kKeys][kD];
  const int tile = blockIdx.x % tiles;
  const int bh = blockIdx.x / tiles;
  const int b = bh / H, h = bh % H;
  const int row = tile * kRows + threadIdx.x;
  const bool live = row < L;

  float qr[kD], acc[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) {
    qr[d] = live ? at(q, b, h, row, d) * scale_log2 : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < L; k0 += kKeys) {
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < kKeys * kD; i += kRows) {
      const int j = i / kD, d = i % kD;
      const bool in = k0 + j < L;
      ks[j][d] = in ? at(k, b, h, k0 + j, d) : 0.f;
      vs[j][d] = in ? at(v, b, h, k0 + j, d) : 0.f;
    }
    __syncthreads();
#pragma unroll 1
    for (int j0 = 0; j0 < kKeys; j0 += kSub) {
      float s[kSub];
#pragma unroll
      for (int j = 0; j < kSub; ++j) s[j] = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < kD / 4; ++d4) {
#pragma unroll
        for (int j = 0; j < kSub; ++j) {
          const float4 kk = reinterpret_cast<const float4*>(ks[j0 + j])[d4];
          s[j] = fmaf(qr[4 * d4], kk.x, s[j]);
          s[j] = fmaf(qr[4 * d4 + 1], kk.y, s[j]);
          s[j] = fmaf(qr[4 * d4 + 2], kk.z, s[j]);
          s[j] = fmaf(qr[4 * d4 + 3], kk.w, s[j]);
        }
      }
      float m_new = m;
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        if (k0 + j0 + j >= L) s[j] = -INFINITY;
        m_new = fmaxf(m_new, s[j]);
      }
      // m_new is finite: key 0 is scored in the first group
      const float corr = exp2f(m - m_new);
      l *= corr;
#pragma unroll
      for (int d = 0; d < kD; ++d) acc[d] *= corr;
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const float p = exp2f(s[j] - m_new);
        l += p;
#pragma unroll
        for (int d4 = 0; d4 < kD / 4; ++d4) {
          const float4 vv = reinterpret_cast<const float4*>(vs[j0 + j])[d4];
          acc[4 * d4] = fmaf(p, vv.x, acc[4 * d4]);
          acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
          acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
          acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
        }
      }
      m = m_new;
    }
  }
  if (!live) return;
  float* out = o + b * osb + h * osh + row * osl;
#pragma unroll
  for (int d = 0; d < kD; ++d) out[d * osd] = acc[d] / l;
  if (lse != nullptr) lse[(static_cast<long long>(b) * H + h) * L + row] = m * kLn2 + logf(l);
}

}  // namespace

// q, k, v: (B, H, L, 64) fp32 through element strides {batch, head, row,
// dim} each; o: fp32 through element strides {batch, head, row, dim}; lse:
// contiguous fp32 (B, H, L), or null when no log-sum-exp is wanted.
// scale_log2 = log2(e) / 8.
extern "C" int svc_flash_attention_fp32_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, int B, int H, int L,
    long long qsb, long long qsh, long long qsl, long long qsd,
    long long ksb, long long ksh, long long ksl, long long ksd,
    long long vsb, long long vsh, long long vsl, long long vsd,
    long long osb, long long osh, long long osl, long long osd,
    float scale_log2, void* stream) {
  if (B < 0 || H < 0 || L < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0 || L == 0) return static_cast<int>(cudaSuccess);
  const int tiles = (L + kRows - 1) / kRows;
  const long long blocks = static_cast<long long>(tiles) * B * H;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const View vq{static_cast<const float*>(q), qsb, qsh, qsl, qsd};
  const View vk{static_cast<const float*>(k), ksb, ksh, ksl, ksd};
  const View vv{static_cast<const float*>(v), vsb, vsh, vsl, vsd};
  flash_fwd_fp32_kernel<<<static_cast<unsigned>(blocks), kRows, 0, static_cast<cudaStream_t>(stream)>>>(
      vq, vk, vv, static_cast<float*>(o), osb, osh, osl, osd, static_cast<float*>(lse), H, L, tiles,
      scale_log2);
  return static_cast<int>(cudaGetLastError());
}
