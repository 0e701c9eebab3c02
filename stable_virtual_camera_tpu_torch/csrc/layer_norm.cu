// K5: LayerNorm over the last axis with one-pass fp32 statistics, for Hopper.
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
// card's operations-per-byte balance, so the design keeps bytes in flight on
// every SM from the first cycle to the last and moves each byte once, in
// wide accesses:
// - Persistent blocks, as many as fit on the SMs at once (at most one per
//   tile), walk tiles of R rows: tile blockIdx.x, then + gridDim.x, and so
//   on. x is contiguous, so a tile is one span of R * C * sizeof(T) bytes.
// - One thread of a producer warp keeps a ring of stages in shared memory
//   full, with one 1-D bulk copy (TMA, `sm90::bulk_load`) per tile that
//   completes on the stage's full mbarrier. The consumer threads arrive on
//   the stage's empty mbarrier when they are done with it.
// - Consumer warps own rows of a stage (warp w: rows w, w + kConsumers, ...).
//   A warp reads its row from shared memory twice, in 16-byte vectors with
//   neighbouring lanes on neighbouring vectors: once for sum(x) and sum(x^2)
//   in fp32, reduced over the warp by a __shfl_xor_sync butterfly, and once
//   to normalise. It writes y straight to device memory in 16-byte stores.
//   No per-lane array is sized by C, so one instantiation per dtype serves
//   every width.
// - gamma and beta are read from device memory once per block, into shared
//   memory.
// - Both streams evict first from L2: the bulk copies under an evict-first
//   policy, the stores as streaming (.cs) stores. Either alone measured
//   slower than both together on an H100 (PERF.md, K5 findings).
// The wrapper (ops/layer_norm.py `_check_ln`) plans R (a multiple of 8, so
// that a whole tile is a multiple of 16 bytes for bf16 and fp32) and the
// ring's depth, and checks that x and y start on a 16-byte boundary.
//
// The ragged tail: the last tile may hold fewer than R rows, and its bytes
// need not be a multiple of 16 (3 rows of C = 2 in bf16 are 12 bytes). The
// bulk copy takes the largest multiple of 16 of them; the producer thread
// copies the other 4, 8 or 12 bytes itself, with 4-byte loads and shared
// stores, before its arrive on the full barrier, whose release orders those
// stores before the consumers' wait. Rows >= rows are never read or stored.
// A width whose rows are not a multiple of 16 bytes (bf16 C % 8 != 0, fp32
// C % 4 != 0) does not start every row on a 16-byte boundary; it moves pairs
// of elements (4 bytes in bf16, 8 in fp32) instead.

#include <algorithm>

#include "sm90.cuh"

namespace {

using namespace svc::sm90;

constexpr int kConsumers = 8;                   // consumer warps; warp kConsumers produces
constexpr int kThreads = 32 * (kConsumers + 1);
constexpr int kMaxWidth = 2048;
constexpr int kMaxStages = 8;
constexpr int kMaxSmem = 232448;  // 227 KB, a block's most dynamic shared memory

__host__ __device__ constexpr int round_up(int n, int m) { return (n + m - 1) / m * m; }

// Dynamic shared memory: gamma, beta, the stages (each 128-byte aligned),
// then a full and an empty mbarrier per stage; 128 bytes of slack align the
// base.
__host__ __device__ constexpr long long smem_bytes(int row_bytes, int rows_per_tile, int stages) {
  return 128 + 2 * round_up(row_bytes, 128) +
         stages * ((static_cast<long long>(rows_per_tile) * row_bytes + 127) / 128 * 128) + 16 * stages;
}

// The rows of the tile that starts at row r0: rows_per_tile but in the last.
__device__ __forceinline__ int tile_rows(long long rows, long long r0, int rows_per_tile) {
  return rows - r0 < rows_per_tile ? static_cast<int>(rows - r0) : rows_per_tile;
}

// W 32-bit words (one vector) from a 4 W-byte aligned address.
template <int W>
struct Words;
template <>
struct Words<4> {
  using type = uint4;
};
template <>
struct Words<2> {
  using type = uint2;
};
template <>
struct Words<1> {
  using type = uint32_t;
};

template <int W>
__device__ __forceinline__ void load_words(uint32_t (&w)[W], const uint8_t* p) {
  const auto v = *reinterpret_cast<const typename Words<W>::type*>(p);
  if constexpr (W == 4) {
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  } else if constexpr (W == 2) {
    w[0] = v.x, w[1] = v.y;
  } else {
    w[0] = v;
  }
}

// W 32-bit words to device memory as a streaming store (evict first: y is
// written once and not read back by this kernel).
template <int W>
__device__ __forceinline__ void store_words_cs(uint8_t* p, const uint32_t (&w)[W]) {
  if constexpr (W == 4) {
    asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"l"(p), "r"(w[0]), "r"(w[1]),
                 "r"(w[2]), "r"(w[3])
                 : "memory");
  } else if constexpr (W == 2) {
    asm volatile("st.global.cs.v2.u32 [%0], {%1, %2};\n" ::"l"(p), "r"(w[0]), "r"(w[1]) : "memory");
  } else {
    asm volatile("st.global.cs.u32 [%0], %1;\n" ::"l"(p), "r"(w[0]) : "memory");
  }
}

// A vector of T as fp32 values (bf16 widens exactly), and back to device
// memory (bf16 rounds to nearest even).
template <typename T, int W>
struct Vec {
  static constexpr int kWords = W;
  static constexpr int kElems = W * 4 / static_cast<int>(sizeof(T));

  static __device__ __forceinline__ void load(float (&f)[kElems], const uint8_t* p) {
    uint32_t w[W];
    load_words(w, p);
#pragma unroll
    for (int i = 0; i < W; ++i) {
      if constexpr (sizeof(T) == 2) {
        f[2 * i] = __uint_as_float(w[i] << 16);
        f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      } else {
        f[i] = __uint_as_float(w[i]);
      }
    }
  }

  static __device__ __forceinline__ void store_cs(uint8_t* p, const float (&f)[kElems]) {
    uint32_t w[W];
#pragma unroll
    for (int i = 0; i < W; ++i) {
      if constexpr (sizeof(T) == 2) {
        w[i] = svc::pack_bf16x2(f[2 * i], f[2 * i + 1]);
      } else {
        w[i] = __float_as_uint(f[i]);
      }
    }
    store_words_cs(p, w);
  }
};

// kWide: rows are a multiple of 16 bytes and move in 16-byte vectors; else
// in pairs of elements.
template <typename T, bool kWide>
__global__ void __launch_bounds__(kThreads, 2)
layer_norm_kernel(const T* __restrict__ x, const T* __restrict__ gamma, const T* __restrict__ beta,
                  T* __restrict__ y, long long rows, int C, int rows_per_tile, int stages,
                  long long tiles, float eps) {
  using V = Vec<T, kWide ? 4 : static_cast<int>(sizeof(T)) / 2>;
  constexpr int kVecBytes = 4 * V::kWords;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((128u - (smem_u32(smem_raw) & 127u)) & 127u);
  const int row_bytes = C * static_cast<int>(sizeof(T));
  const int params_bytes = round_up(row_bytes, 128);
  const int stage_bytes = round_up(rows_per_tile * row_bytes, 128);
  uint8_t* s_gamma = smem;
  uint8_t* s_beta = smem + params_bytes;
  uint8_t* s_ring = smem + 2 * params_bytes;
  const uint32_t bar_full = smem_u32(s_ring + stages * stage_bytes);  // + 8 s
  const uint32_t bar_empty = bar_full + 8 * stages;                   // + 8 s

  // gamma and beta once per block (pair-aligned, so 4-byte words)
  for (int i = threadIdx.x; i < row_bytes / 4; i += kThreads) {
    reinterpret_cast<uint32_t*>(s_gamma)[i] = reinterpret_cast<const uint32_t*>(gamma)[i];
    reinterpret_cast<uint32_t*>(s_beta)[i] = reinterpret_cast<const uint32_t*>(beta)[i];
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 32 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp == kConsumers) {
    // producer: one thread keeps the ring full
    if (lane == 0) {
      const uint64_t policy = evict_first_policy();  // x is read once
      int i = 0;
      for (long long t = blockIdx.x; t < tiles; t += gridDim.x, ++i) {
        const int s = i % stages;
        // the first round finds every stage free (parity of the phase
        // before the first)
        mbar_wait(bar_empty + 8 * s, ((i / stages) & 1) ^ 1);
        const long long r0 = t * rows_per_tile;
        const uint32_t bytes = static_cast<uint32_t>(tile_rows(rows, r0, rows_per_tile) * row_bytes);
        const uint32_t bulk = bytes & ~15u;
        const uint8_t* src = reinterpret_cast<const uint8_t*>(x) + r0 * row_bytes;
        uint8_t* dst = s_ring + s * stage_bytes;
        for (uint32_t o = bulk; o < bytes; o += 4) {  // the tail's last 4-12 bytes
          *reinterpret_cast<uint32_t*>(dst + o) = *reinterpret_cast<const uint32_t*>(src + o);
        }
        mbar_expect_tx(bar_full + 8 * s, bulk);
        if (bulk) bulk_load(smem_u32(dst), src, bulk, bar_full + 8 * s, policy);
      }
    }
    return;
  }

  // consumers
  int i = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x, ++i) {
    const int s = i % stages;
    mbar_wait(bar_full + 8 * s, (i / stages) & 1);
    const long long r0 = t * rows_per_tile;
    const int n = tile_rows(rows, r0, rows_per_tile);
    const uint8_t* tile = s_ring + s * stage_bytes;
    for (int r = warp; r < n; r += kConsumers) {
      const uint8_t* xs = tile + r * row_bytes;
      float s1 = 0.f, s2 = 0.f;
#pragma unroll 4
      for (int o = lane * kVecBytes; o < row_bytes; o += 32 * kVecBytes) {
        float f[V::kElems];
        V::load(f, xs + o);
#pragma unroll
        for (int e = 0; e < V::kElems; ++e) {
          s1 += f[e];
          s2 = fmaf(f[e], f[e], s2);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        s1 += __shfl_xor_sync(0xffffffffu, s1, off);
        s2 += __shfl_xor_sync(0xffffffffu, s2, off);
      }
      const float mean = s1 / C;
      const float rstd = rsqrtf(fmaxf(s2 / C - mean * mean, 0.f) + eps);
      const float shift = -mean * rstd;  // (x - mean) * rstd = x * rstd + shift
      uint8_t* yr = reinterpret_cast<uint8_t*>(y) + (r0 + r) * row_bytes;
#pragma unroll 4
      for (int o = lane * kVecBytes; o < row_bytes; o += 32 * kVecBytes) {
        float f[V::kElems], g[V::kElems], b[V::kElems];
        V::load(f, xs + o);
        V::load(g, s_gamma + o);
        V::load(b, s_beta + o);
#pragma unroll
        for (int e = 0; e < V::kElems; ++e) f[e] = fmaf(fmaf(f[e], rstd, shift), g[e], b[e]);
        V::store_cs(yr + o, f);
      }
    }
    mbar_arrive(bar_empty + 8 * s);
  }
}

template <typename T, bool kWide>
cudaError_t launch(const void* x, const void* g, const void* b, void* y, long long rows, int C,
                   int rows_per_tile, int stages, float eps, cudaStream_t stream) {
  const long long need = smem_bytes(C * static_cast<int>(sizeof(T)), rows_per_tile, stages);
  if (need > kMaxSmem) return cudaErrorInvalidValue;
  const int smem = static_cast<int>(need);
  const auto kernel = layer_norm_kernel<T, kWide>;
  int resident = 0;
  const cudaError_t err = resident_blocks(kernel, kThreads, smem, kMaxSmem, &resident);
  if (err != cudaSuccess) return err;
  const long long tiles = (rows + rows_per_tile - 1) / rows_per_tile;
  const int blocks = static_cast<int>(std::min<long long>(tiles, resident));
  kernel<<<blocks, kThreads, smem, stream>>>(static_cast<const T*>(x), static_cast<const T*>(g),
                                             static_cast<const T*>(b), static_cast<T*>(y), rows, C,
                                             rows_per_tile, stages, tiles, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_width(const void* x, const void* g, const void* b, void* y, long long rows, int C,
                         int rows_per_tile, int stages, float eps, cudaStream_t stream) {
  if (C * sizeof(T) % 16 == 0) {
    return launch<T, true>(x, g, b, y, rows, C, rows_per_tile, stages, eps, stream);
  }
  return launch<T, false>(x, g, b, y, rows, C, rows_per_tile, stages, eps, stream);
}

}  // namespace

// x, y: (rows, C) contiguous, starting on a 16-byte boundary; gamma, beta:
// (C,), aligned to a pair of elements; all of one dtype (0 = bf16, 1 =
// fp32). C even, 2 <= C <= 2048. The tile plan: rows_per_tile a positive
// multiple of 8, 2 <= stages <= 8, within a block's shared memory.
extern "C" int svc_layer_norm_fwd(const void* x, const void* gamma, const void* beta, void* y,
                                  long long rows, int C, int dtype, float eps, int rows_per_tile,
                                  int stages, void* stream) {
  const auto addr = [](const void* p) { return reinterpret_cast<uintptr_t>(p); };
  if (C < 2 || C > kMaxWidth || C % 2 || rows < 0 || rows_per_tile < 8 || rows_per_tile % 8 ||
      stages < 2 || stages > kMaxStages || (addr(x) | addr(y)) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_width<__nv_bfloat16>(x, gamma, beta, y, rows, C, rows_per_tile, stages, eps, s);
  } else if (dtype == 1) {
    err = launch_width<float>(x, gamma, beta, y, rows, C, rows_per_tile, stages, eps, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
