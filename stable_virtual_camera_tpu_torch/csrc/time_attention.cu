// K2: temporal (time-mix) attention over the frame axis, bf16 in and out,
// for Hopper.
//
// Replaces stable_virtual_camera_tpu/ops/time_attention.py::
// time_attention_bhds (its Pallas TPU kernel `_kernel`, reached through
// `_kernel_call`). For every (scene, head, spatial position s) it computes,
// for each query frame t of the scene's T <= 32 frames,
//     p_t = softmax_u(q[t, :, s] . k[u, :, s] / 8),   o[t, :, s] = sum_u p_tu v[u, :, s]
// on the (b*T, H, 64, S) layout with S contiguous. All arithmetic is fp32, as
// in the TPU kernel; only o is rounded to bf16.
//
// What bounds it on an H100: bytes. A (scene, head, position) does 4 T^2 64
// FLOP on 4 T 64 bf16 values, T/2 FLOP a byte (10.5 at T = 21, at most 16),
// under the fp32 ridge of 67 TFLOP/s / 3.35 TB/s = 20. The tensor cores would
// need each position's (T, 64) slabs transposed out of the S-contiguous
// layout, T padded to 16 or 32 and P rounded to bf16, where the TPU kernel
// keeps P in fp32; so the arithmetic stays fp32 on the CUDA cores, and the
// design is about keeping the copies in flight while the FMAs run, and
// issuing few instructions besides the FMAs:
// - Work items are (scene, head, a tile of P positions): P = 64, so a
//   (frame, channel) row of a tile is 128 contiguous bytes (P = 32 at the
//   24- and 32-frame ceilings, to hold the scores in registers). Blocks are
//   persistent, as many as fit on the SMs at once; each walks items
//   blockIdx.x, + gridDim.x, ...
// - The scores sum over the 64 channels, and output channel d needs only
//   v's channel d, so q, k and v all pass through shared memory in units of
//   kChunk = 16 channels: a unit is a (T, 16, P) slab, and an item is the
//   units q0 k0 q1 k1 q2 k2 q3 k3 (scores) then v0 v1 v2 v3 (output). A ring
//   of `stages` units (4; 43 KB a unit at T = 21) holds them; the next
//   item's units stream in while this one's output is computed.
// - One producer warp fills the ring (enum Copy; the wrapper picks the
//   mode from the addresses, strides and S, ops/time_attention.py
//   `_k2_plan`; the consumers are the same for every mode). Where every row
//   of q, k and v starts on a 16-byte boundary and is a multiple of 16
//   bytes long (S % 8 == 0 on the UNet's views), a unit is one 4-D TMA box
//   {P positions, 16 channels, 1 head, T frames} (dims {S, 64, H, b*T};
//   positions past S are zero-filled) completing on the stage's full
//   mbarrier. Where rows are 8- or 4-byte aligned (S = 324 and 108 in the
//   UNet) the warp's lanes copy the unit in granules of that size with
//   cp.async, each lane arriving on the full barrier when its copies land.
//   Where rows are only 2-byte aligned (S odd: 81) but a chunk's 16 rows
//   are one packed span per frame, as in the UNet, the spans are bulk-copied
//   (`sm90::bulk_load`) into a staging area and the warp shifts the odd
//   rows by one element into the stage; any other view is copied with
//   2-byte loads. (Copying S = 81 by 2-byte loads, or by 4-byte cp.async
//   of each row, was slower than a one-warp-per-frame kernel without a
//   ring: the one producer warp issues too many instructions.)
// - Consumers: a thread owns a pair of neighbouring positions (one bf16x2
//   word of a row, so a warp reads a 128-byte row without bank conflicts)
//   and R query frames (R = 3, or 2 at the 24- and 32-frame ceilings, where
//   a block of 3-frame threads would have 9 warps, and so at most 168
//   registers a thread: the registers of an SM quarter split over 3 warps).
//   Every k or v word it reads from shared memory feeds 2 R FMAs, which
//   pays for the two integer ops of its bf16x2 -> fp32 widening (9 issued
//   instructions for 6 FMAs at R = 3). Its R x 2 x Tc scores stay
//   in registers; the softmax runs there in fp32 (exp2 of log2(e)-scaled
//   scores), and P.V runs unit by unit, storing o as bf16x2 words (4 bytes a
//   lane, 128 contiguous bytes a warp) with evict-first stores.
// - Frames: the kernel is instantiated for the ceilings Tc = 4, 8, 16, 21,
//   24 and 32 (21 is the model's chunk length, so its key loop wastes
//   nothing) and the wrapper takes the smallest that holds T. Key frames in
//   [T, Tc) read rows that are zeroed once per block and never written, and
//   their scores are masked out of the softmax; query frames >= T are
//   computed and not stored.

#include <algorithm>
#include <iterator>

#include "sm90.cuh"

namespace {

using namespace svc::sm90;
using svc::kD;

constexpr int kChunk = 16;                      // channels a ring unit
constexpr int kChunks = kD / kChunk;            // units of each of q, k, v
constexpr int kUnits = 3 * kChunks;             // units an item
constexpr int kMaxStages = 4;
constexpr int kMaxSmem = 232448;                // 227 KB, a block's most dynamic shared memory
constexpr int kBarBytes = 128;                  // a full and an empty mbarrier per stage, two for kSpan
constexpr int kSmemHead = 128 + kBarBytes;      // base alignment slack + the barriers

__host__ __device__ constexpr int round_up(int n, int m) { return (n + m - 1) / m * m; }
static_assert(16 * kMaxStages + 16 <= kBarBytes, "the barriers fit before the ring");

// What a key-frame ceiling fixes: query frames a thread (R), positions a
// tile (P), the lanes that share one frame group (a pair of positions
// each), the most frame groups, and the most threads a block (the consumer
// warps, then the producer warp).
template <int Tc>
struct Ceiling {
  static constexpr int R = Tc > 21 ? 2 : 3;
  static constexpr int P = Tc > 21 ? 32 : 64;
  static constexpr int kPairs = P / 2;
  static constexpr int kGroups = (Tc + R - 1) / R;
  static constexpr int kMaxThreads = round_up(kGroups * kPairs, 32) + 32;
  static constexpr int kUnitRow = P * 2;                       // bytes of a (frame, channel) row
  static constexpr int kStageBytes = Tc * kChunk * kUnitRow;   // a unit, padded to Tc frames
};

struct Operands {
  const __nv_bfloat16* qkv[3];
  __nv_bfloat16* o;
  long long st[4], sh[4], sd[4];  // (frame, head, channel) element strides of q, k, v, o
};

__device__ __forceinline__ float lo_f32(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_f32(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The producer warp's copy of one unit without TMA: rows (t, c) of the
// (T, kChunk, P) slab from src (the unit's first element: frame 0 of the
// scene, channel d0, position s0) into dst, in granules of G = 8 or 4 bytes
// with cp.async, each lane arriving on `bar` when its copies land. A
// granule that starts at or past S is not copied (its lanes' outputs are
// never stored).
template <int G, int P>
__device__ __forceinline__ void copy_unit(uint8_t* dst, const __nv_bfloat16* src, long long st,
                                          long long sd, int T, int s0, int S, uint32_t bar,
                                          int lane) {
  constexpr int kPerRow = P * 2 / G;          // lanes that copy one row
  constexpr int kRowsPerPass = 32 / kPerRow;  // rows the warp copies at once
  const int j = lane % kPerRow, c0 = lane / kPerRow;
  if (s0 + j * (G / 2) < S) {
    const __nv_bfloat16* g = src + c0 * sd + j * (G / 2);
    const uint32_t d = smem_u32(dst) + c0 * (P * 2) + j * G;
    for (int t = 0; t < T; ++t) {
#pragma unroll
      for (int c = 0; c < kChunk; c += kRowsPerPass) {
        cp_async<G>(d + (t * kChunk + c) * (P * 2), g + t * st + c * sd);
      }
    }
  }
  cp_async_arrive_noinc(bar);
}

// kSpan's shift: where rows start on a 2-byte boundary only and a chunk's
// rows are packed (channel stride S; so S is odd), frame t's kChunk rows
// are one span of 32 S bytes from a 16-byte boundary, bulk-copied whole
// into a staging area `raw`. This moves each row's P positions from s0
// (even) into dst as 4-byte words. Row r starts at element r S + s0 of
// raw, so even rows start on a word and odd rows one element into word
// i S + (S - 1) / 2 + s0 / 2 (r = 2 i + 1), which are shifted by one
// element; the rows go in pairs.
template <int P>
__device__ __forceinline__ void realign_span(uint8_t* dst, const uint8_t* raw, int T, int s0, int S,
                                             int lane) {
  constexpr int kPairsAStep = 8;  // T * kChunk / 2 = 8 T row pairs; their loads issue before the stores
  if (lane >= P / 2) return;
  const uint32_t* even = reinterpret_cast<const uint32_t*>(raw) + s0 / 2 + lane;
  const uint32_t* odd = even + (S - 1) / 2;
  uint32_t* out = reinterpret_cast<uint32_t*>(dst) + lane;
  for (int i = 0; i < T * kChunk / 2; i += kPairsAStep) {
    uint32_t a[kPairsAStep], b[kPairsAStep], c[kPairsAStep];
#pragma unroll
    for (int k = 0; k < kPairsAStep; ++k) {
      a[k] = even[k * S];
      b[k] = odd[k * S];
      c[k] = odd[k * S + 1];
    }
#pragma unroll
    for (int k = 0; k < kPairsAStep; ++k) {
      out[k * P] = a[k];
      out[k * P + P / 2] = __byte_perm(b[k], c[k], 0x5432);
    }
    even += kPairsAStep * S;
    odd += kPairsAStep * S;
    out += kPairsAStep * P;
  }
}

// The general fallback where rows start on a 2-byte boundary only and are
// not packed: 2-byte loads and stores by the warp's lanes, eight in flight
// each, then an arrive on `bar`.
template <int P>
__device__ __forceinline__ void copy_unit_loads(uint8_t* dst, const __nv_bfloat16* src, long long st,
                                                long long sd, int T, int s0, int S, uint32_t bar,
                                                int lane) {
  constexpr int kBatch = 8;
  const int n = T * kChunk * P;
  for (int i0 = lane; i0 < n; i0 += 32 * kBatch) {
    unsigned short h[kBatch];
#pragma unroll
    for (int e = 0; e < kBatch; ++e) {
      const int i = i0 + 32 * e, j = i % P, row = i / P;
      h[e] = (i < n && s0 + j < S)
                 ? *reinterpret_cast<const unsigned short*>(src + (row / kChunk) * st + (row % kChunk) * sd + j)
                 : 0;
    }
#pragma unroll
    for (int e = 0; e < kBatch; ++e) {
      const int i = i0 + 32 * e;
      if (i < n) reinterpret_cast<unsigned short*>(dst)[i] = h[e];
    }
  }
  mbar_arrive(bar);
}

// One of kSpan's two staging areas: a unit's T spans of kChunk rows, and
// one word past them for the last row's shift.
__host__ __device__ constexpr long long span_bytes(int T, int S) {
  return (static_cast<long long>(T) * kChunk * S * 2 + 16 + 127) / 128 * 128;
}

// Where unit j (q0 k0 q1 k1 ... v0 ... v3) of work item `item` comes from:
// `which` operand, its first element (frame 0 of the scene, channel d0,
// position s0), and the tile's first position s0.
struct UnitSrc {
  int which, d0, h, s0;
  long long f0;
};

__device__ __forceinline__ UnitSrc unit_src(long long item, int j, int T, int H, int tiles, int P) {
  const long long bh = item / tiles;
  UnitSrc u;
  u.which = j < 2 * kChunks ? (j & 1) : 2;
  u.d0 = (j < 2 * kChunks ? j >> 1 : j - 2 * kChunks) * kChunk;
  u.h = static_cast<int>(bh % H);
  u.f0 = (bh / H) * T;
  u.s0 = static_cast<int>(item % tiles) * P;
  return u;
}

// How the producer fills the ring (ops/time_attention.py `_k2_plan`).
enum Copy { kTma = 0, kAsync8 = 1, kAsync4 = 2, kSpan = 3, kLoads = 4 };

template <int Tc>
__global__ void __launch_bounds__(Ceiling<Tc>::kMaxThreads, 1)
time_attn_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v, const Operands ops, int T, int H, int S,
                 int tiles, long long items, int stages, int copy, int consumers, bool o_pairs,
                 float scale_log2) {
  using C = Ceiling<Tc>;
  constexpr int R = C::R, P = C::P, kRow = C::kUnitRow, kStage = C::kStageBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((128u - (smem_u32(smem_raw) & 127u)) & 127u);
  const uint32_t bar_full = smem_u32(base);              // + 8 s
  const uint32_t bar_empty = bar_full + 8 * kMaxStages;  // + 8 s
  const uint32_t bar_raw = bar_full + 16 * kMaxStages;   // + 8 i: kSpan's staging area i
  uint8_t* ring = base + kBarBytes;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(bar_full + 8 * s, copy == kTma ? 1 : 32);
      mbar_init(bar_empty + 8 * s, consumers);
    }
    mbar_init(bar_raw, 1);
    mbar_init(bar_raw + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // key frames T..Tc-1 of every stage read as zeros, for good
  {
    const int pad = (Tc - T) * kChunk * kRow / 16;
    for (int i = threadIdx.x; i < stages * pad; i += blockDim.x) {
      reinterpret_cast<uint4*>(ring + (i / pad) * kStage + T * kChunk * kRow)[i % pad] =
          make_uint4(0, 0, 0, 0);
    }
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  if (static_cast<int>(threadIdx.x) >= consumers) {
    // producer warp
    if (copy == kTma && lane != 0) return;
    // this block's units: kUnits for each of its items blockIdx.x, + gridDim.x, ...
    const int n_units = static_cast<int>((items - blockIdx.x + gridDim.x - 1) / gridDim.x) * kUnits;
    const auto item_of = [&](int unit) { return blockIdx.x + static_cast<long long>(unit / kUnits) * gridDim.x; };
    // selects, not an index: a run-time index into the parameter arrays
    // would copy them to local memory
    const auto operand = [&](int which, const __nv_bfloat16*& base_ptr, long long& st, long long& sh,
                             long long& sd) {
      base_ptr = which == 0 ? ops.qkv[0] : which == 1 ? ops.qkv[1] : ops.qkv[2];
      st = which == 0 ? ops.st[0] : which == 1 ? ops.st[1] : ops.st[2];
      sh = which == 0 ? ops.sh[0] : which == 1 ? ops.sh[1] : ops.sh[2];
      sd = which == 0 ? ops.sd[0] : which == 1 ? ops.sd[1] : ops.sd[2];
    };
    if (copy == kSpan) {
      // two staging areas: the next unit's spans land while this one's are
      // shifted into the ring
      uint8_t* raw = ring + stages * kStage;
      const int raw_bytes = static_cast<int>(span_bytes(T, S));
      const uint32_t span = kChunk * S * 2;
      const auto stage_spans = [&](int unit) {  // lane 0
        const UnitSrc u = unit_src(item_of(unit), unit % kUnits, T, H, tiles, P);
        const __nv_bfloat16* base_ptr;
        long long st, sh, sd;
        operand(u.which, base_ptr, st, sh, sd);
        const __nv_bfloat16* src = base_ptr + u.f0 * st + u.h * sh + u.d0 * sd;
        const uint32_t bar = bar_raw + 8 * (unit & 1);
        const uint32_t dst = smem_u32(raw + (unit & 1) * raw_bytes);
        const uint64_t policy = evict_first_policy();
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // after the warp's reads of dst
        mbar_expect_tx(bar, T * span);
        for (int t = 0; t < T; ++t) bulk_load(dst + t * span, src + t * st, span, bar, policy);
      };
      if (lane == 0 && n_units > 0) stage_spans(0);
      for (int unit = 0; unit < n_units; ++unit) {
        if (lane == 0 && unit + 1 < n_units) stage_spans(unit + 1);
        const int s = unit % stages;
        mbar_wait(bar_raw + 8 * (unit & 1), (unit >> 1) & 1);
        mbar_wait(bar_empty + 8 * s, ((unit / stages) & 1) ^ 1);  // the first round finds it free
        realign_span<P>(ring + s * kStage, raw + (unit & 1) * raw_bytes, T,
                        unit_src(item_of(unit), unit % kUnits, T, H, tiles, P).s0, S, lane);
        __syncwarp();  // the warp is done with this staging area
        mbar_arrive(bar_full + 8 * s);
      }
      return;
    }
    for (int unit = 0; unit < n_units; ++unit) {
      const UnitSrc u = unit_src(item_of(unit), unit % kUnits, T, H, tiles, P);
      const int s = unit % stages;
      uint8_t* dst = ring + s * kStage;
      mbar_wait(bar_empty + 8 * s, ((unit / stages) & 1) ^ 1);  // the first round finds it free
      if (copy == kTma) {
        const CUtensorMap& map = u.which == 0 ? map_q : u.which == 1 ? map_k : map_v;
        mbar_expect_tx(bar_full + 8 * s, static_cast<uint32_t>(T * kChunk * kRow));
        tma_load_4d(smem_u32(dst), map, bar_full + 8 * s, u.s0, u.d0, u.h, static_cast<int>(u.f0));
        continue;
      }
      const __nv_bfloat16* base_ptr;
      long long st, sh, sd;
      operand(u.which, base_ptr, st, sh, sd);
      const __nv_bfloat16* src = base_ptr + u.f0 * st + u.h * sh + u.d0 * sd + u.s0;
      if (copy == kAsync8) {
        copy_unit<8, P>(dst, src, st, sd, T, u.s0, S, bar_full + 8 * s, lane);
      } else if (copy == kAsync4) {
        copy_unit<4, P>(dst, src, st, sd, T, u.s0, S, bar_full + 8 * s, lane);
      } else {
        copy_unit_loads<P>(dst, src, st, sd, T, u.s0, S, bar_full + 8 * s, lane);
      }
    }
    return;
  }

  // consumers: a pair of positions and R query frames a thread
  const int pair = threadIdx.x % C::kPairs;
  const int t0 = (threadIdx.x / C::kPairs) * R;
  int qrow[R];  // the thread's query rows in a unit (frames past the ceiling read its last)
#pragma unroll
  for (int r = 0; r < R; ++r) qrow[r] = min(t0 + r, Tc - 1) * kChunk * kRow + pair * 4;
  const int lane_off = pair * 4;

  int unit = 0;
  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    const int tile = static_cast<int>(it % tiles);
    const long long bh = it / tiles;
    const int h = static_cast<int>(bh % H);
    const long long f0 = (bh / H) * T;
    const int s = tile * P + 2 * pair;

    float sc[R][Tc][2];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int u = 0; u < Tc; ++u) sc[r][u][0] = sc[r][u][1] = 0.f;
    }
    for (int c = 0; c < kChunks; ++c, unit += 2) {
      const int sq = unit % stages, sk = (unit + 1) % stages;
      mbar_wait(bar_full + 8 * sq, (unit / stages) & 1);
      mbar_wait(bar_full + 8 * sk, ((unit + 1) / stages) & 1);
      const uint8_t* qs = ring + sq * kStage;
      const uint8_t* ks = ring + sk * kStage + lane_off;
#pragma unroll 2
      for (int d = 0; d < kChunk; ++d) {
        float qa[R][2];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const uint32_t w = lds32(qs + qrow[r] + d * kRow);
          qa[r][0] = lo_f32(w), qa[r][1] = hi_f32(w);
        }
#pragma unroll
        for (int u = 0; u < Tc; ++u) {
          const uint32_t w = lds32(ks + (u * kChunk + d) * kRow);
          const float k0 = lo_f32(w), k1 = hi_f32(w);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            sc[r][u][0] = fmaf(qa[r][0], k0, sc[r][u][0]);
            sc[r][u][1] = fmaf(qa[r][1], k1, sc[r][u][1]);
          }
        }
      }
      mbar_arrive(bar_empty + 8 * sq);
      mbar_arrive(bar_empty + 8 * sk);
    }

    // softmax over the T key frames, in registers; P is left unnormalised
    // and o scaled by 1 / sum at the store
    float inv[R][2];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float m = -INFINITY;
#pragma unroll
        for (int u = 0; u < Tc; ++u) {
          if (u < T) m = fmaxf(m, sc[r][u][e]);
        }
        const float ms = m * scale_log2;
        float l = 0.f;
#pragma unroll
        for (int u = 0; u < Tc; ++u) {
          const float p = u < T ? ex2(fmaf(sc[r][u][e], scale_log2, -ms)) : 0.f;
          sc[r][u][e] = p;
          l += p;
        }
        inv[r][e] = 1.f / l;
      }
    }

    __nv_bfloat16* orow[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      orow[r] = ops.o + (f0 + t0 + r) * ops.st[3] + h * ops.sh[3] + s;
    }
    const bool s0_ok = s < S, s1_ok = s + 1 < S;
    for (int c = 0; c < kChunks; ++c, ++unit) {
      const int sv = unit % stages;
      mbar_wait(bar_full + 8 * sv, (unit / stages) & 1);
      const uint8_t* vs = ring + sv * kStage + lane_off;
#pragma unroll 2
      for (int d = 0; d < kChunk; ++d) {
        float acc[R][2];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r][0] = acc[r][1] = 0.f;
#pragma unroll
        for (int u = 0; u < Tc; ++u) {
          const uint32_t w = lds32(vs + (u * kChunk + d) * kRow);
          const float v0 = lo_f32(w), v1 = hi_f32(w);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            acc[r][0] = fmaf(sc[r][u][0], v0, acc[r][0]);
            acc[r][1] = fmaf(sc[r][u][1], v1, acc[r][1]);
          }
        }
        const long long od = static_cast<long long>(c * kChunk + d) * ops.sd[3];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (t0 + r >= T) continue;
          __nv_bfloat16* p = orow[r] + od;
          const float o0 = acc[r][0] * inv[r][0], o1 = acc[r][1] * inv[r][1];
          if (o_pairs && s1_ok) {
            __stcs(reinterpret_cast<unsigned int*>(p), svc::pack_bf16x2(o0, o1));
          } else {
            if (s0_ok) p[0] = __float2bfloat16(o0);
            if (s1_ok) p[1] = __float2bfloat16(o1);
          }
        }
      }
      mbar_arrive(bar_empty + 8 * sv);
    }
  }
}

template <int Tc>
cudaError_t launch(const Operands& ops, int b, int T, int H, int S, int stages, int copy,
                   float scale_log2, cudaStream_t stream) {
  using C = Ceiling<Tc>;
  const long long smem =
      kSmemHead + static_cast<long long>(stages) * C::kStageBytes + (copy == kSpan ? 2 * span_bytes(T, S) : 0);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const int consumers = round_up((T + C::R - 1) / C::R * C::kPairs, 32);
  const int threads = consumers + 32;
  const int tiles = (S + C::P - 1) / C::P;
  const long long items = static_cast<long long>(b) * H * tiles;
  CUtensorMap maps[3];
  if (copy == kTma) {
    for (int i = 0; i < 3; ++i) {
      const cuuint64_t dims[4] = {static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(kD),
                                  static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(b) * T};
      const cuuint64_t bytes[3] = {static_cast<cuuint64_t>(ops.sd[i]) * 2,
                                   static_cast<cuuint64_t>(ops.sh[i]) * 2,
                                   static_cast<cuuint64_t>(ops.st[i]) * 2};
      const cuuint32_t box[4] = {static_cast<cuuint32_t>(C::P), static_cast<cuuint32_t>(kChunk), 1,
                                 static_cast<cuuint32_t>(T)};
      const cudaError_t err = encode_4d(&maps[i], ops.qkv[i], dims, bytes, box, CU_TENSOR_MAP_SWIZZLE_NONE);
      if (err != cudaSuccess) return err;
    }
  } else {
    std::fill(reinterpret_cast<char*>(maps), reinterpret_cast<char*>(maps + 3), 0);
  }
  const auto kernel = time_attn_kernel<Tc>;
  int resident = 0;
  const cudaError_t err = resident_blocks(kernel, C::kMaxThreads, static_cast<int>(smem), kMaxSmem, &resident);
  if (err != cudaSuccess) return err;
  const int blocks = static_cast<int>(std::min<long long>(items, resident));
  const auto addr = reinterpret_cast<uintptr_t>(ops.o);
  const bool o_pairs = addr % 4 == 0 && ops.st[3] % 2 == 0 && ops.sh[3] % 2 == 0 && ops.sd[3] % 2 == 0;
  kernel<<<blocks, threads, static_cast<int>(smem), stream>>>(maps[0], maps[1], maps[2], ops, T, H, S,
                                                             tiles, items, stages, copy, consumers,
                                                             o_pairs, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: (b*T, H, 64, S) bf16 addressed through (frame, head, channel)
// element strides, S contiguous; 1 <= T <= 32. The launch plan (ops/
// time_attention.py `_k2_plan`): `ceiling` the smallest of 4, 8, 16, 21, 24,
// 32 that holds T; `stages` ring units (2 to 4, within a block's shared
// memory); `copy` how the producer fills them (enum Copy): kTma where every
// row of q, k and v starts on a 16-byte boundary and S * 2 is a multiple of
// 16, kAsync8 / kAsync4 where rows start on an 8- / 4-byte boundary and S * 2
// is a multiple of 8 / 4, kSpan where rows start on a 2-byte boundary, a
// chunk's rows are packed (channel stride S) and frames and heads start on a
// 16-byte boundary, kLoads otherwise. scale_log2 = log2(e) / 8.
extern "C" int svc_time_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int b, int T, int H, int S,
    long long qst, long long qsh, long long qsd,
    long long kst, long long ksh, long long ksd,
    long long vst, long long vsh, long long vsd,
    long long ost, long long osh, long long osd,
    float scale_log2, int ceiling, int stages, int copy, void* stream) {
  static constexpr int kCeilings[] = {4, 8, 16, 21, 24, 32};
  const int* fit = std::find_if(std::begin(kCeilings), std::end(kCeilings), [T](int c) { return c >= T; });
  if (T < 1 || T > 32 || fit == std::end(kCeilings) || *fit != ceiling || stages < 2 ||
      stages > kMaxStages || copy < kTma || copy > kLoads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the copy mode's alignment, in bytes, of every row start and of S * 2
  const int align = copy == kTma ? 16 : copy == kAsync8 ? 8 : copy == kAsync4 ? 4 : 2;
  const long long starts[3][4] = {{reinterpret_cast<long long>(q), 2 * qst, 2 * qsh, 2 * qsd},
                                  {reinterpret_cast<long long>(k), 2 * kst, 2 * ksh, 2 * ksd},
                                  {reinterpret_cast<long long>(v), 2 * vst, 2 * vsh, 2 * vsd}};
  bool ok = (2 * S) % align == 0;
  for (const auto& t : starts) {
    for (int i = 0; i < 4; ++i) ok = ok && t[i] % align == 0;
    if (copy == kSpan) ok = ok && t[0] % 16 == 0 && t[1] % 16 == 0 && t[2] % 16 == 0 && t[3] == 2LL * S;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || H == 0 || S == 0) return static_cast<int>(cudaSuccess);
  const Operands ops{{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
                      static_cast<const __nv_bfloat16*>(v)},
                     static_cast<__nv_bfloat16*>(o),
                     {qst, kst, vst, ost}, {qsh, ksh, vsh, osh}, {qsd, ksd, vsd, osd}};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (ceiling) {
    case 4: err = launch<4>(ops, b, T, H, S, stages, copy, scale_log2, s); break;
    case 8: err = launch<8>(ops, b, T, H, S, stages, copy, scale_log2, s); break;
    case 16: err = launch<16>(ops, b, T, H, S, stages, copy, scale_log2, s); break;
    case 21: err = launch<21>(ops, b, T, H, S, stages, copy, scale_log2, s); break;
    case 24: err = launch<24>(ops, b, T, H, S, stages, copy, scale_log2, s); break;
    default: err = launch<32>(ops, b, T, H, S, stages, copy, scale_log2, s); break;
  }
  return static_cast<int>(err);
}
