// K2's entry for every input the Hopper K2 (time_attention.cu, bf16 at
// head dim 64 with S contiguous) does not take: temporal attention over the
// frame axis at any head dim D, in fp32, bf16 or fp16, through any strides,
// for Hopper.
//
// Replaces the other inputs of stable_virtual_camera_tpu/ops/
// time_attention.py::time_attention_bhds (its Pallas TPU kernel `_kernel`),
// which takes any head dim and any float dtype. For every (scene, head,
// spatial position s) and each query frame t of the scene's T <= 32 frames,
//     p_t = softmax_u(q[t, :, s] . k[u, :, s] / sqrt(D)),   o[t, :, s] = sum_u p_tu v[u, :, s]
// on the (b*T, H, D, S) layout. All arithmetic is fp32 on the CUDA cores, as
// in the TPU kernel (which keeps P in fp32; the tensor cores would need T
// padded to 8 or 16 and each position's (T, D) slabs transposed out of the
// S-contiguous layout); only o is rounded to the input dtype.
//
// What bounds it on an H100: bytes. A (scene, head, position) does 4 T^2 D
// FLOP on 4 T D values: T / 4 FLOP a byte in fp32 (5.25 at T = 21), T / 2
// in bf16 and fp16, under the fp32 ridge of 67 TFLOP/s / 3.35 TB/s = 20 at
// every T <= 32. At the fp32 render's shapes (T = 21, D = 64) the FMAs alone
// take a quarter of the bytes' time, so the design keeps the copies in
// flight while the FMAs run, and spends few instructions besides the FMAs:
// - Work items are (scene, head, a tile of P = 32 positions). Blocks are
//   persistent, as many as fit on the SMs at once; each walks items
//   blockIdx.x, + gridDim.x, ...
// - q, k and v pass through shared memory in units of kChunk = 16 channels:
//   a unit is a (T, 16, P) slab in the input dtype, one 128-byte row per
//   (frame, channel) in fp32 (64 bytes in bf16 and fp16), and an item is
//   the units q0 k0 q1 k1 ... (scores) then v0 v1 ... (output), ceil(D / 16)
//   of each; channels past D are zero-filled, not read. A ring of `stages`
//   units (4, or 3 at 32 key frames in fp32; 43 KB a unit at T = 21 in
//   fp32) holds them on mbarriers, and the next item's units stream in while
//   this one's output is computed.
// - Producer warps fill the ring (enum Copy; the wrapper picks the mode from
//   the addresses, strides, S and the element size, ops/time_attention.py
//   `_any_plan`; the consumers are the same for every mode). Where every
//   row of q, k and v starts on a 16-byte boundary and
//   S times the element size is a multiple of 16 (fp32 S % 4 == 0 on the
//   UNet's views: 5184, 1296, 324), a unit is one 4-D TMA box {P positions,
//   16 channels, 1 head, T frames} of the operand's dtype (dims {S, D, H,
//   b*T}; positions past S and channels past D are zero-filled), issued by
//   one thread. Where rows start on 8- or 4-byte boundaries (fp32 S = 81),
//   the lanes of two producer warps (one at Tc = 32, which keeps a block at
//   8 warps) copy granules of that size with cp.async, zero-filling those
//   past S or D, and each lane arrives on the stage's full barrier when its
//   copies land (one warp issuing S = 81's 4-byte granules took 1.8x as
//   long). Any other view (a strided S, 16-bit rows on 2-byte boundaries) is
//   copied by element loads.
// - Consumers: lane i of a warp owns position s0 + i and the warp R = 4
//   query frames (5 at Tc = 32), so every k or v value a lane reads from
//   shared memory (one word of a row, a warp reading a whole row without
//   bank conflicts) feeds R FMAs. The R x Tc scores stay in registers; the
//   softmax runs there in fp32 (exp2 of log2(e)-scaled scores; P is left
//   unnormalised and o scaled by 1 / sum at the store), and P.V runs unit by
//   unit, storing o in the input dtype as coalesced rows with evict-first
//   stores.
// - Frames: the kernel is instantiated for the key-frame ceilings Tc = 4,
//   8, 16, 21, 24 and 32 (21 is the model's chunk length, so its key loop
//   wastes nothing) and the wrapper takes the smallest that holds T. Key
//   frames in [T, Tc) read rows that are zeroed once per block and never
//   written, and their scores are masked out of the softmax; query frames
//   >= T are computed (from the last frame's rows) and not stored.

#include <cuda_fp16.h>

#include <algorithm>
#include <iterator>

#include "sm90.cuh"

namespace {

using namespace svc::sm90;

constexpr int kChunk = 16;                  // channels a ring unit
constexpr int kP = 32;                      // positions a tile: a warp's lanes
constexpr int kMaxStages = 4;
constexpr int kMaxSmem = 232448;            // 227 KB, a block's most dynamic shared memory
constexpr int kBarBytes = 128;              // a full and an empty mbarrier per stage
constexpr int kSmemHead = 128 + kBarBytes;  // base alignment slack + the barriers
static_assert(16 * kMaxStages <= kBarBytes, "the barriers fit before the ring");

// bytes of an element, and of a (frame, channel) row of a tile
template <typename E>
constexpr int kBytes = static_cast<int>(sizeof(E));
template <typename E>
constexpr int kRowBytes = kP * kBytes<E>;

// An element type's bits, widening to fp32 and rounding from it.
template <typename E>
struct Elem;
template <>
struct Elem<float> {
  using Bits = uint32_t;
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  __device__ static float widen(Bits x) { return __uint_as_float(x); }
  __device__ static Bits round(float x) { return __float_as_uint(x); }
};
template <>
struct Elem<__nv_bfloat16> {
  using Bits = uint16_t;
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  __device__ static float widen(Bits x) { return __uint_as_float(static_cast<uint32_t>(x) << 16); }
  __device__ static Bits round(float x) { return __bfloat16_as_ushort(__float2bfloat16_rn(x)); }
};
template <>
struct Elem<__half> {
  using Bits = uint16_t;
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  __device__ static float widen(Bits x) { return __half2float(__ushort_as_half(x)); }
  __device__ static Bits round(float x) { return __half_as_ushort(__float2half_rn(x)); }
};

__device__ __forceinline__ void store_evict_first(uint32_t* p, uint32_t x) { __stcs(p, x); }
__device__ __forceinline__ void store_evict_first(uint16_t* p, uint16_t x) { __stcs(p, x); }

// What a key-frame ceiling fixes: the query frames a warp (R: 4, so that
// every value read from shared memory feeds 4 FMAs; 5 at Tc = 32, where 8
// warps of 4 would make a block of 9 warps, 3 on some scheduler, and so at
// most 168 registers a thread for 128 scores), the most consumer warps, the
// producer warps where they copy by hand (2, or 1 where 2 would make a block
// of 9 warps), the most threads a block (the consumer warps, then the
// producer warps), and the bytes of a unit.
template <typename E, int Tc>
struct Ceiling {
  static constexpr int kR = Tc > 24 ? 5 : 4;
  static constexpr int kWarps = (Tc + kR - 1) / kR;
  static constexpr int kProducers = kWarps + 2 <= 8 ? 2 : 1;
  static constexpr int kMaxThreads = 32 * (kWarps + kProducers);
  static constexpr int kStageBytes = Tc * kChunk * kRowBytes<E>;  // a unit, padded to Tc frames
};

template <typename E>
struct Operands {
  const E* qkv[3];
  E* o;
  long long st[4], sh[4], sd[4], ss[4];  // (frame, head, channel, position) element strides of q, k, v, o
};

// How the producer fills the ring (ops/time_attention.py `_any_plan`).
enum Copy { kTma = 0, kAsync8 = 1, kAsync4 = 2, kLoads = 3 };

// Producer warp pw's share (frames pw, pw + np, ...) of one unit's copy
// without TMA: rows (t, c) of the (T, kChunk, kP) slab from src (the unit's
// first element: frame 0 of the scene, channel d0, position s0) into dst,
// in granules of G = 8 or 4 bytes with cp.async; granules past S or rows
// past the chunk's `dn` channels are zero-filled. Each lane arrives on `bar`
// when its copies land.
template <int G, typename E>
__device__ __forceinline__ void copy_unit(uint8_t* dst, const E* src, long long st, long long sd, int T,
                                          int s0, int S, int dn, uint32_t bar, int lane, int pw, int np) {
  constexpr int kRow = kRowBytes<E>;
  constexpr int kPerRow = kRow / G;           // lanes that copy one row
  constexpr int kRowsPerPass = 32 / kPerRow;  // rows the warp copies at once
  constexpr int kElems = G / kBytes<E>;
  const int j = lane % kPerRow, c0 = lane / kPerRow;
  const bool in_s = s0 + j * kElems < S;
  const E* g = src + c0 * sd + j * kElems;
  const uint32_t d = smem_u32(dst) + c0 * kRow + j * G;
  for (int t = pw; t < T; t += np) {
#pragma unroll
    for (int c = 0; c < kChunk; c += kRowsPerPass) {
      const bool in = in_s && c + c0 < dn;
      cp_async_zfill<G>(d + (t * kChunk + c) * kRow, in ? g + t * st + c * sd : src, in ? G : 0);
    }
  }
  cp_async_arrive_noinc(bar);
}

// The general copy: element loads and stores by the lanes of the np
// producer warps (this is warp pw), eight in flight each (zeros past S and
// past the chunk's `dn` channels), then an arrive on `bar`.
template <typename E>
__device__ __forceinline__ void copy_unit_loads(uint8_t* dst, const E* src, long long st, long long sd,
                                                long long ss, int T, int s0, int S, int dn, uint32_t bar,
                                                int lane, int pw, int np) {
  using Bits = typename Elem<E>::Bits;
  constexpr int kBatch = 8;
  const Bits* from = reinterpret_cast<const Bits*>(src);
  Bits* to = reinterpret_cast<Bits*>(dst);
  const int n = T * kChunk * kP;
  const int step = 32 * np;
  for (int i0 = lane + 32 * pw; i0 < n; i0 += step * kBatch) {
    Bits x[kBatch];
#pragma unroll
    for (int e = 0; e < kBatch; ++e) {
      const int i = i0 + step * e, j = i % kP, row = i / kP, c = row % kChunk;
      x[e] = (i < n && s0 + j < S && c < dn) ? from[(row / kChunk) * st + c * sd + j * ss] : Bits(0);
    }
#pragma unroll
    for (int e = 0; e < kBatch; ++e) {
      const int i = i0 + step * e;
      if (i < n) to[i] = x[e];
    }
  }
  mbar_arrive(bar);
}

// Where unit j (q0 k0 q1 k1 ... v0 v1 ...) of work item `item` comes from:
// `which` operand, its channel d0, head h, first frame f0 and the tile's
// first position s0.
struct UnitSrc {
  int which, d0, h, s0;
  long long f0;
};

__device__ __forceinline__ UnitSrc unit_src(long long item, int j, int chunks, int T, int H, int tiles) {
  const long long bh = item / tiles;
  UnitSrc u;
  u.which = j < 2 * chunks ? (j & 1) : 2;
  u.d0 = (j < 2 * chunks ? j >> 1 : j - 2 * chunks) * kChunk;
  u.h = static_cast<int>(bh % H);
  u.f0 = (bh / H) * T;
  u.s0 = static_cast<int>(item % tiles) * kP;
  return u;
}

template <typename E, int Tc>
__global__ void __launch_bounds__(Ceiling<E, Tc>::kMaxThreads, 1)
time_any_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v, const Operands<E> ops, int T, int H, int D, int S,
                int chunks, int tiles, long long items, int stages, int copy, int consumers,
                float scale_log2) {
  using C = Ceiling<E, Tc>;
  using X = Elem<E>;
  using Bits = typename X::Bits;
  constexpr int kR = C::kR, kRow = kRowBytes<E>, kStage = C::kStageBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((128u - (smem_u32(smem_raw) & 127u)) & 127u);
  const uint32_t bar_full = smem_u32(base);              // + 8 s
  const uint32_t bar_empty = bar_full + 8 * kMaxStages;  // + 8 s
  uint8_t* ring = base + kBarBytes;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(bar_full + 8 * s, copy == kTma ? 1 : blockDim.x - consumers);
      mbar_init(bar_empty + 8 * s, consumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // key frames T..Tc-1 of every stage read as zeros, for good
  {
    const int pad = (Tc - T) * kChunk * kRow / 16;
    for (int i = threadIdx.x; i < stages * pad; i += blockDim.x) {
      reinterpret_cast<uint4*>(ring + (i / pad) * kStage + T * kChunk * kRow)[i % pad] = make_uint4(0, 0, 0, 0);
    }
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int per_item = 3 * chunks;
  if (static_cast<int>(threadIdx.x) >= consumers) {
    // producer warps: pw of np, each waiting for every stage; one thread
    // issues the TMA boxes
    const int pw = (threadIdx.x - consumers) / 32, np = (blockDim.x - consumers) / 32;
    if (copy == kTma && (lane != 0 || pw != 0)) return;
    // this block's units: per_item for each of its items blockIdx.x, + gridDim.x, ...
    const int n_units = static_cast<int>((items - blockIdx.x + gridDim.x - 1) / gridDim.x) * per_item;
    for (int unit = 0; unit < n_units; ++unit) {
      const long long item = blockIdx.x + static_cast<long long>(unit / per_item) * gridDim.x;
      const UnitSrc u = unit_src(item, unit % per_item, chunks, T, H, tiles);
      const int s = unit % stages;
      uint8_t* dst = ring + s * kStage;
      mbar_wait(bar_empty + 8 * s, ((unit / stages) & 1) ^ 1);  // the first round finds it free
      if (copy == kTma) {
        const CUtensorMap& map = u.which == 0 ? map_q : u.which == 1 ? map_k : map_v;
        mbar_expect_tx(bar_full + 8 * s, static_cast<uint32_t>(T * kChunk * kRow));
        tma_load_4d(smem_u32(dst), map, bar_full + 8 * s, u.s0, u.d0, u.h, static_cast<int>(u.f0));
        continue;
      }
      // selects, not an index: a run-time index into the parameter arrays
      // would copy them to local memory
      const int w = u.which;
      const E* src = w == 0 ? ops.qkv[0] : w == 1 ? ops.qkv[1] : ops.qkv[2];
      const long long st = w == 0 ? ops.st[0] : w == 1 ? ops.st[1] : ops.st[2];
      const long long sh = w == 0 ? ops.sh[0] : w == 1 ? ops.sh[1] : ops.sh[2];
      const long long sd = w == 0 ? ops.sd[0] : w == 1 ? ops.sd[1] : ops.sd[2];
      const long long ss = w == 0 ? ops.ss[0] : w == 1 ? ops.ss[1] : ops.ss[2];
      src += u.f0 * st + u.h * sh + u.d0 * sd + u.s0 * ss;
      const int dn = min(kChunk, D - u.d0);
      if (copy == kAsync8) {
        copy_unit<8>(dst, src, st, sd, T, u.s0, S, dn, bar_full + 8 * s, lane, pw, np);
      } else if (copy == kAsync4) {
        copy_unit<4>(dst, src, st, sd, T, u.s0, S, dn, bar_full + 8 * s, lane, pw, np);
      } else {
        copy_unit_loads(dst, src, st, sd, ss, T, u.s0, S, dn, bar_full + 8 * s, lane, pw, np);
      }
    }
    return;
  }

  // consumers: position s0 + lane and R query frames a thread
  const int t0 = (threadIdx.x / 32) * kR;
  int qrow[kR];  // the thread's query rows in a unit (frames past the ceiling read its last)
#pragma unroll
  for (int r = 0; r < kR; ++r) qrow[r] = min(t0 + r, Tc - 1) * kChunk * kRow + lane * kBytes<E>;
  const int lane_off = lane * kBytes<E>;
  const auto word = [](const uint8_t* p) { return X::widen(*reinterpret_cast<const Bits*>(p)); };

  int unit = 0;
  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    const int tile = static_cast<int>(it % tiles);
    const long long bh = it / tiles;
    const int h = static_cast<int>(bh % H);
    const long long f0 = (bh / H) * T;
    const int s = tile * kP + lane;

    float sc[kR][Tc];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
#pragma unroll
      for (int u = 0; u < Tc; ++u) sc[r][u] = 0.f;
    }
    for (int c = 0; c < chunks; ++c, unit += 2) {
      const int sq = unit % stages, sk = (unit + 1) % stages;
      mbar_wait(bar_full + 8 * sq, (unit / stages) & 1);
      mbar_wait(bar_full + 8 * sk, ((unit + 1) / stages) & 1);
      const uint8_t* qs = ring + sq * kStage;
      const uint8_t* ks = ring + sk * kStage + lane_off;
#pragma unroll 4
      for (int d = 0; d < kChunk; ++d) {
        float qa[kR];
#pragma unroll
        for (int r = 0; r < kR; ++r) qa[r] = word(qs + qrow[r] + d * kRow);
#pragma unroll
        for (int u = 0; u < Tc; ++u) {
          const float kv = word(ks + (u * kChunk + d) * kRow);
#pragma unroll
          for (int r = 0; r < kR; ++r) sc[r][u] = fmaf(qa[r], kv, sc[r][u]);
        }
      }
      mbar_arrive(bar_empty + 8 * sq);
      mbar_arrive(bar_empty + 8 * sk);
    }

    // softmax over the T key frames, in registers; P is left unnormalised
    // and o scaled by 1 / sum at the store
    float inv[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      float m = -INFINITY;
#pragma unroll
      for (int u = 0; u < Tc; ++u) {
        if (u < T) m = fmaxf(m, sc[r][u]);
      }
      const float ms = m * scale_log2;
      float l = 0.f;
#pragma unroll
      for (int u = 0; u < Tc; ++u) {
        const float p = u < T ? ex2(fmaf(sc[r][u], scale_log2, -ms)) : 0.f;
        sc[r][u] = p;
        l += p;
      }
      inv[r] = 1.f / l;
    }

    Bits* orow[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      orow[r] = reinterpret_cast<Bits*>(ops.o + (f0 + t0 + r) * ops.st[3] + h * ops.sh[3] + s * ops.ss[3]);
    }
    const bool s_ok = s < S;
    for (int c = 0; c < chunks; ++c, ++unit) {
      const int sv = unit % stages;
      mbar_wait(bar_full + 8 * sv, (unit / stages) & 1);
      const uint8_t* vs = ring + sv * kStage + lane_off;
#pragma unroll 4
      for (int d = 0; d < kChunk; ++d) {
        float acc[kR];
#pragma unroll
        for (int r = 0; r < kR; ++r) acc[r] = 0.f;
#pragma unroll
        for (int u = 0; u < Tc; ++u) {
          const float vv = word(vs + (u * kChunk + d) * kRow);
#pragma unroll
          for (int r = 0; r < kR; ++r) acc[r] = fmaf(sc[r][u], vv, acc[r]);
        }
        const int ch = c * kChunk + d;
        if (!s_ok || ch >= D) continue;
        const long long od = ch * ops.sd[3];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          if (t0 + r < T) store_evict_first(orow[r] + od, X::round(acc[r] * inv[r]));
        }
      }
      mbar_arrive(bar_empty + 8 * sv);
    }
  }
}

template <typename E, int Tc>
cudaError_t launch(const Operands<E>& ops, int b, int T, int H, int D, int S, int stages, int copy,
                   float scale_log2, cudaStream_t stream) {
  using C = Ceiling<E, Tc>;
  const int smem = kSmemHead + stages * C::kStageBytes;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const int consumers = 32 * ((T + C::kR - 1) / C::kR);
  const int threads = consumers + 32 * (copy == kTma ? 1 : C::kProducers);
  const int tiles = (S + kP - 1) / kP;
  const int chunks = (D + kChunk - 1) / kChunk;
  const long long items = static_cast<long long>(b) * H * tiles;
  CUtensorMap maps[3];
  if (copy == kTma) {
    constexpr long long e = kBytes<E>;
    for (int i = 0; i < 3; ++i) {
      const cuuint64_t dims[4] = {static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(D),
                                  static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(b) * T};
      const cuuint64_t bytes[3] = {static_cast<cuuint64_t>(ops.sd[i] * e), static_cast<cuuint64_t>(ops.sh[i] * e),
                                   static_cast<cuuint64_t>(ops.st[i] * e)};
      const cuuint32_t box[4] = {kP, kChunk, 1, static_cast<cuuint32_t>(T)};
      const cudaError_t err =
          encode_4d(&maps[i], ops.qkv[i], dims, bytes, box, CU_TENSOR_MAP_SWIZZLE_NONE, Elem<E>::kMap);
      if (err != cudaSuccess) return err;
    }
  } else {
    std::fill(reinterpret_cast<char*>(maps), reinterpret_cast<char*>(maps + 3), 0);
  }
  const auto kernel = time_any_kernel<E, Tc>;
  int resident = 0;
  const cudaError_t err = resident_blocks(kernel, C::kMaxThreads, smem, kMaxSmem, &resident);
  if (err != cudaSuccess) return err;
  const long long blocks = std::min<long long>(items, resident);
  // a block's units are counted in an int
  if ((items + blocks - 1) / blocks * 3 * chunks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<static_cast<int>(blocks), threads, smem, stream>>>(maps[0], maps[1], maps[2], ops, T, H, D, S, chunks,
                                                              tiles, items, stages, copy, consumers, scale_log2);
  return cudaGetLastError();
}

template <typename E>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, const long long (&st)[4][4], int b,
                     int T, int H, int D, int S, float scale_log2, int ceiling, int stages, int copy,
                     cudaStream_t stream) {
  Operands<E> ops{{static_cast<const E*>(q), static_cast<const E*>(k), static_cast<const E*>(v)},
                  static_cast<E*>(o)};
  for (int i = 0; i < 4; ++i) {
    ops.st[i] = st[i][0], ops.sh[i] = st[i][1], ops.sd[i] = st[i][2], ops.ss[i] = st[i][3];
  }
  switch (ceiling) {
    case 4: return launch<E, 4>(ops, b, T, H, D, S, stages, copy, scale_log2, stream);
    case 8: return launch<E, 8>(ops, b, T, H, D, S, stages, copy, scale_log2, stream);
    case 16: return launch<E, 16>(ops, b, T, H, D, S, stages, copy, scale_log2, stream);
    case 21: return launch<E, 21>(ops, b, T, H, D, S, stages, copy, scale_log2, stream);
    case 24: return launch<E, 24>(ops, b, T, H, D, S, stages, copy, scale_log2, stream);
    default: return launch<E, 32>(ops, b, T, H, D, S, stages, copy, scale_log2, stream);
  }
}

}  // namespace

// q, k, v, o: (b*T, H, D, S) of one dtype (0 fp32, 1 bf16, 2 fp16)
// addressed through (frame, head, channel, position) element strides;
// 1 <= T <= 32. scale_log2 = log2(e) / sqrt(D). The launch plan (ops/
// time_attention.py `_any_plan`): `ceiling` the smallest of 4, 8, 16, 21,
// 24, 32 that holds T; `stages` ring units (2 to 4, within a block's shared
// memory); `copy` how the producer fills them (enum Copy): kTma where every
// row of q, k and v starts on a 16-byte boundary, S times the element size
// is a multiple of 16, positions are contiguous and no stride is 0; kAsync8
// / kAsync4 where rows start on 8- / 4-byte boundaries, S times the element
// size is a multiple of 8 / 4 and positions are contiguous; kLoads for
// anything.
extern "C" int svc_time_attention_any_fwd(
    const void* q, const void* k, const void* v, void* o, int b, int T, int H, int D, int S,
    long long qst, long long qsh, long long qsd, long long qss,
    long long kst, long long ksh, long long ksd, long long kss,
    long long vst, long long vsh, long long vsd, long long vss,
    long long ost, long long osh, long long osd, long long oss,
    float scale_log2, int dtype, int ceiling, int stages, int copy, void* stream) {
  static constexpr int kCeilings[] = {4, 8, 16, 21, 24, 32};
  const int* fit = std::find_if(std::begin(kCeilings), std::end(kCeilings), [T](int c) { return c >= T; });
  if (T < 1 || T > 32 || fit == std::end(kCeilings) || *fit != ceiling || b < 0 || H < 0 || D < 0 || S < 0 ||
      dtype < 0 || dtype > 2 || stages < 2 || stages > kMaxStages || copy < kTma || copy > kLoads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long st[4][4] = {{qst, qsh, qsd, qss}, {kst, ksh, ksd, kss}, {vst, vsh, vsd, vss},
                              {ost, osh, osd, oss}};
  if (copy != kLoads) {
    // the copy mode's alignment, in bytes, of every row start and of a row
    const long long e = dtype == 0 ? 4 : 2;
    const int align = copy == kTma ? 16 : copy == kAsync8 ? 8 : 4;
    const void* ptrs[3] = {q, k, v};
    bool ok = (e * S) % align == 0;
    for (int i = 0; i < 3; ++i) {
      ok = ok && reinterpret_cast<uintptr_t>(ptrs[i]) % align == 0 && st[i][3] == 1;
      for (int j = 0; j < 3; ++j) ok = ok && (e * st[i][j]) % align == 0 && (copy != kTma || st[i][j] > 0);
    }
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || H == 0 || D == 0 || S == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0: err = dispatch<float>(q, k, v, o, st, b, T, H, D, S, scale_log2, ceiling, stages, copy, s); break;
    case 1: err = dispatch<__nv_bfloat16>(q, k, v, o, st, b, T, H, D, S, scale_log2, ceiling, stages, copy, s); break;
    default: err = dispatch<__half>(q, k, v, o, st, b, T, H, D, S, scale_log2, ceiling, stages, copy, s); break;
  }
  return static_cast<int>(err);
}
