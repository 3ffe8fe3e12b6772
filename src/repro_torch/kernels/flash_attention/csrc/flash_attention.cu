// Blockwise online-softmax attention for Hopper (sm_90a): the prefill path
// of the shared attention block of zamba2.
//
// Replaces the TPU Pallas kernel `_flash_kernel` in
// src/repro/kernels/flash_attention/kernel.py:30 (wrapper `flash_attention`
// in src/repro/kernels/flash_attention/ops.py:19). For every query row it
// computes softmax(q k^T * scale) v over the keys, with the running max m,
// denominator l and accumulator acc of the online softmax, all in float32
// whatever the input type, masked scores at -1e30 (not -inf), causal masking
// by index with whole key tiles above the diagonal skipped, and the output
// acc / max(l, 1e-30) in the input type, as the TPU kernel does.
//
// What bounds it: the two products, 4 * d flops per (query, key) pair that
// the mask keeps (about 120 GFLOP for a causal 4 x 2048 x 32-head x 112
// prefill, 0.12 ms at the card's bf16 tensor-core peak); the bytes (q, k, v
// read once, o written once: 0.24 GB there, 0.07 ms) come second. The TPU
// kernel walked the key blocks on a sequential grid axis and carried (m, l,
// acc) in VMEM scratch; its products ran on the MXU with d padded to 128.
//
// Two kernels, chosen by the wrapper (ops.py `variant`) from the dtype and
// the head dim alone:
//
// `flash_wgmma_kernel` (bf16, d a multiple of 16 up to 256; the prefill's
// path): one block of two warpgroups per (query tile of 128 rows, head,
// batch), each warpgroup owning 64 rows (`wgmma` M = 64). The query tiles of
// a (batch, head) are walked longest first (the x index counts down) and
// the heads in order, so a causal prefill starts its longest blocks first
// and the K and V of the heads in flight stay in L2. A third, producer
// warpgroup (its registers given to the two consumers with setmaxnreg)
// has one thread issue the TMA copies (the map fetched through the
// runtime, rebuilt per launch, passed as a __grid_constant__ parameter):
// Q once, and K and V through a ring of 64-key stages, each with a full and
// an empty mbarrier, so the consumers never wait on one another. The ring
// is as deep as the 227 KB of shared memory allow (`stages(D)`): four
// stages up to d = 176, three to 224, two past it.
// The boxes are 16 bytes wide, so the tiles land unswizzled in the
// core-matrix layout that wgmma reads (hopper/wgmma.cuh), ragged S edges
// zero-filled by TMA. Up to d = 128, Q is read once into registers, the A
// operand of S = Q K^T (`wgmma.m64n64k16`, K-major K from shared memory,
// f32 accumulation, d / 16 steps: 112 = 7 x 16 runs unpadded); past 128
// the products read Q from shared memory instead (both operands K-major
// descriptors), which keeps the d / 2 output accumulators of a thread (128
// floats at d = 256) and the S and P fragments within the consumers' 240
// registers. Step j issues
// S of tile j and P V of tile j - 1 together and runs the softmax of tile
// j under P V; no product stays in flight from one step into the next
// (ptxas serialises the products, C7514, when it cannot prove that).
// The online softmax runs on the accumulator fragment in registers: each
// row lives in the four threads of a quad (two rows a thread), so row max
// and sum take two shuffles; only the diagonal tile and the ragged edge are
// masked. O += P V is `wgmma.m64n{d}k16` with P as the register A operand
// (the S fragment rounded to bf16 and packed pairwise) and V read MN-major
// (transpose bit); past d = 128 it is two products a k16 step, columns
// [0, 128) and [128, d), one accumulator array split at element 64. The epilogue divides by max(l, 1e-30) and writes bf16
// pairs. Numerics: the one change from the plain version is that P is
// rounded to bf16 before P V (the plain version keeps it in float32); l
// sums the float32 p. Held to the bf16 bound of 3e-2, the reference's own.
//
// `flash_attention_kernel` (float32, and bf16 with d % 16 != 0): the SIMT
// kernel. One block of 256 threads per (batch, head, 64-row query tile)
// walks the key tiles in a loop; q, k and v tiles are staged in dynamic
// shared memory as float32 (rows padded so that 16-byte reads of
// neighbouring rows hit distinct banks, the ragged S and d edges
// zero-filled, no padding copies in device memory); each warp owns 8 query
// rows: lane j scores keys j and j + 32 of the tile against the 8 rows
// (float4 reads of q and k), the row max and sum go through warp shuffles,
// p goes to a per-warp scratch row and the accumulator is split over lanes
// (lane owns dims lane + 32 t, any d <= 256: eight instantiations by
// (d + 31) / 32; at d = 256 the three tiles and the scratch take 216 KB). Float32 throughout (TF32
// stays off, as everywhere in the port); the key sum of each score runs in
// dimension order, as a dot product; only summation order and FMA
// contraction differ from the plain version.
//
// Both are built without --fmad=false (no discrete decision depends on
// these floats). A launch runs on the caller's stream, never synchronizes
// and allocates nothing: the wrapper (ops.py) checks the inputs and
// allocates the output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "wgmma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileQ = 64;                  // query rows per block
constexpr int kTileK = 64;                  // keys per tile
constexpr int kRowsPerWarp = kTileQ / kWarps;
constexpr float kNegInf = -1e30f;
constexpr int kMaxSmem = 232448;            // 227 KB, the per-block limit

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Row stride (floats) of a staged tile: d rounded up to 4, then made an odd
// multiple of 4, so 8 lanes reading float4s of 8 neighbouring rows hit 8
// distinct 4-bank groups.
__host__ __device__ __forceinline__ int row_stride(int d) {
  const int dp = (d + 3) / 4 * 4;
  return (dp / 4) % 2 == 1 ? dp : dp + 4;
}

__host__ __device__ __forceinline__ size_t smem_bytes(int d) {
  return sizeof(float) *
         (static_cast<size_t>(3) * kTileQ * row_stride(d) +
          static_cast<size_t>(kWarps) * kRowsPerWarp * kTileK);
}

// Rows [r0, r0 + 64) of one head of a [B, S, H, D] tensor into a float32
// tile [64][stride], zero past S and past D.
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ src, float* dst,
                                      size_t head0, int r0, int S, int H,
                                      int D, int stride) {
  const int dp = (D + 3) / 4 * 4;
  for (int e = threadIdx.x; e < kTileQ * dp; e += kThreads) {
    const int r = e / dp;
    const int c = e - r * dp;
    const int s = r0 + r;
    float val = 0.f;
    if (s < S && c < D)
      val = to_f32(src[head0 + static_cast<size_t>(s) * H * D + c]);
    dst[r * stride + c] = val;
  }
}

template <typename T, int kDk>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int Sq, int Skv, int H, int D, float scale,
    int causal) {
  extern __shared__ float smem[];
  const int stride = row_stride(D);
  float* qs = smem;                          // [64][stride]
  float* ks = qs + kTileQ * stride;          // [64][stride]
  float* vs = ks + kTileK * stride;          // [64][stride]
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* ps = vs + kTileK * stride + warp * kRowsPerWarp * kTileK;

  const int q0 = blockIdx.x * kTileQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t q_head = (static_cast<size_t>(b) * Sq * H + h) * D;
  const size_t kv_head = (static_cast<size_t>(b) * Skv * H + h) * D;
  stage(q, qs, q_head, q0, Sq, H, D, stride);

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kDk];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int t = 0; t < kDk; ++t) acc[i][t] = 0.f;
  }

  int n_tiles = (Skv + kTileK - 1) / kTileK;
  if (causal) {                              // skip tiles above the diagonal
    const int last = (q0 + kTileQ - 1) / kTileK + 1;
    n_tiles = n_tiles < last ? n_tiles : last;
  }
  const int dp = (D + 3) / 4 * 4;
  const float* my_q = qs + warp * kRowsPerWarp * stride;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kTileK;
    __syncthreads();                         // the previous tile is done
    stage(k, ks, kv_head, k0, Skv, H, D, stride);
    stage(v, vs, kv_head, k0, Skv, H, D, stride);
    __syncthreads();

    // Scores of keys lane and lane + 32 against the warp's 8 rows.
    float s[kRowsPerWarp][2];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i][0] = s[i][1] = 0.f;
    const float* k_a = ks + lane * stride;
    const float* k_b = ks + (lane + 32) * stride;
    for (int c = 0; c < dp; c += 4) {
      const float4 ka = *reinterpret_cast<const float4*>(k_a + c);
      const float4 kb = *reinterpret_cast<const float4*>(k_b + c);
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float4 qv =
            *reinterpret_cast<const float4*>(my_q + i * stride + c);
        s[i][0] += qv.x * ka.x;
        s[i][0] += qv.y * ka.y;
        s[i][0] += qv.z * ka.z;
        s[i][0] += qv.w * ka.w;
        s[i][1] += qv.x * kb.x;
        s[i][1] += qv.y * kb.y;
        s[i][1] += qv.z * kb.z;
        s[i][1] += qv.w * kb.w;
      }
    }

    // Online softmax per row; p to the warp's scratch rows.
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int qi = q0 + warp * kRowsPerWarp + i;
      float x[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int kj = k0 + lane + 32 * u;
        const bool keep = kj < Skv && (!causal || kj <= qi);
        x[u] = keep ? s[i][u] * scale : kNegInf;
      }
      const float m_new = fmaxf(m[i], warp_max(fmaxf(x[0], x[1])));
      const float p0 = expf(x[0] - m_new);
      const float p1 = expf(x[1] - m_new);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + warp_sum(p0 + p1);
      m[i] = m_new;
      ps[i * kTileK + lane] = p0;
      ps[i * kTileK + lane + 32] = p1;
#pragma unroll
      for (int t = 0; t < kDk; ++t) acc[i][t] *= alpha;
    }
    __syncwarp();

    // acc += p v, lane owning dims lane + 32 t.
    for (int j = 0; j < kTileK; j += 4) {
      float vv[4][kDk];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int t = 0; t < kDk; ++t) {
          const int c = lane + 32 * t;
          vv[u][t] = c < dp ? vs[(j + u) * stride + c] : 0.f;
        }
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float4 pv =
            *reinterpret_cast<const float4*>(ps + i * kTileK + j);
#pragma unroll
        for (int t = 0; t < kDk; ++t) {
          acc[i][t] += pv.x * vv[0][t];
          acc[i][t] += pv.y * vv[1][t];
          acc[i][t] += pv.z * vv[2][t];
          acc[i][t] += pv.w * vv[3][t];
        }
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int qi = q0 + warp * kRowsPerWarp + i;
    if (qi >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* out = o + q_head + static_cast<size_t>(qi) * H * D;
#pragma unroll
    for (int t = 0; t < kDk; ++t) {
      const int c = lane + 32 * t;
      if (c < D) out[c] = from_f32<T>(acc[i][t] / denom);
    }
  }
}

template <typename T, int kDk>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Skv, int H, int D, float scale,
                   int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  auto kernel = flash_attention_kernel<T, kDk>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kTileQ - 1) / kTileQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Skv, H, D, scale,
      causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     int B, int Sq, int Skv, int H, int D, float scale,
                     int causal, cudaStream_t s) {
#define FLASH_ARGS q, k, v, o, B, Sq, Skv, H, D, scale, causal, s
  switch ((D + 31) / 32) {
    case 1: return launch<T, 1>(FLASH_ARGS);
    case 2: return launch<T, 2>(FLASH_ARGS);
    case 3: return launch<T, 3>(FLASH_ARGS);
    case 4: return launch<T, 4>(FLASH_ARGS);
    case 5: return launch<T, 5>(FLASH_ARGS);
    case 6: return launch<T, 6>(FLASH_ARGS);
    case 7: return launch<T, 7>(FLASH_ARGS);
    case 8: return launch<T, 8>(FLASH_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef FLASH_ARGS
}

// ---------------------------------------------------------------------------
// The tensor-core kernel (bf16, D % 16 == 0)
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kWg = 2;                      // consumer warpgroups
constexpr int kThreads = 128 * (kWg + 1);   // and one producer warpgroup
constexpr int kRows = 64 * kWg;             // query rows per block
constexpr int kKeys = 64;                   // keys per tile (N of S)
constexpr int kProducerRegs = 24;           // 24 x 128 + 240 x 256 <= 64 K
constexpr int kConsumerRegs = 240;
constexpr float kLog2e = 1.4426950408889634f;

// q, then `stages` stages of (k, v) tiles, then the mbarriers; 1 KB of
// slack to align the tiles.
__host__ __device__ constexpr size_t smem_bytes(int D, int stages) {
  return static_cast<size_t>(kRows + 2 * stages * kKeys) * D * 2 +
         (2 * stages + 1) * 8 + 1024;
}

// The K / V ring depth at head dim D: the deepest of 4, 3, 2 that fits.
__host__ __device__ constexpr int stages(int D) {
  return smem_bytes(D, 4) <= kMaxSmem ? 4
         : smem_bytes(D, 3) <= kMaxSmem ? 3 : 2;
}

// O += P V of one k16 slice (V MN-major from shared memory, chunk step
// `chunk`): one product up to D = 128, past it two, columns [0, 128) and
// [128, D) (chunk 16 on), into the two parts of the accumulator array.
template <int D>
__device__ __forceinline__ void mma_pv(float (&acc)[D / 2],
                                       const uint32_t (&p)[4],
                                       const uint8_t* v, int chunk) {
  using namespace hopper;
  if constexpr (D <= 128) {
    Wgmma<D>::template rs<1>(acc, p, desc_mn(v, 128, chunk), 1);
  } else {
    Wgmma<128>::template rs<1>(*reinterpret_cast<float(*)[64]>(acc), p,
                               desc_mn(v, 128, chunk), 1);
    Wgmma<D - 128>::template rs<1>(
        *reinterpret_cast<float(*)[(D - 128) / 2]>(acc + 64), p,
        desc_mn(v + 16 * chunk, 128, chunk), 1);
  }
}

// Every tile is written by TMA in 16-byte-wide boxes (8 bf16 columns) of
// all its rows, box c at byte c * rows * 16: the core matrices of a chunk
// stack along the rows, so a tile's 8-row groups are 128 bytes apart and
// its chunks 16 x rows bytes apart (`hopper::desc_k` / `desc_mn`).
template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
    int Sq, int Skv, int H, float scale_log2, int causal) {
  using namespace hopper;
  constexpr int kStages = stages(D);        // K / V ring depth
  constexpr bool kQInRegs = D <= 128;       // Q as a register operand
  constexpr int kChunks = D / 8;
  constexpr int kTile = kKeys * D * 2;      // bytes of one k or v tile
  constexpr int kKChunk = kKeys * 16;       // chunk step of a k / v tile
  constexpr int kQChunk = kRows * 16;       // chunk step of the q tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ring = qs + kRows * D * 2;       // stage s: k, then v
  // full[s]: the tile in stage s has landed; empty[s]: every consumer warp
  // is done with it (one arrival each). Use u = t / kStages of stage s has
  // parity u & 1.
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + 2 * kStages * kTile);
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;

  // Query tiles longest first within each (batch, head); the heads run in
  // order, so the K and V of the few heads in flight stay in L2.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  int n_tiles = (Skv + kKeys - 1) / kKeys;
  if (causal) {                              // skip tiles above the diagonal
    const int last = (q0 + kRows - 1) / kKeys + 1;
    n_tiles = n_tiles < last ? n_tiles : last;
  }
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 4 * kWg);
    }
    mbar_init(q_full, 1);
    fence_barrier_init();
  }
  __syncthreads();                           // the barriers are initialised

  if (threadIdx.x >= 128 * kWg) {
    // Producer warpgroup: one thread issues every TMA copy, Q once, then K
    // and V tile t into stage t % kStages once every consumer warp released
    // the tile before it there.
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 128 * kWg) {
      mbar_expect_tx(q_full, kRows * D * 2);
      for (int c = 0; c < kChunks; ++c)
        tma_load_3d(qs + c * kRows * 16, &tq, h * D + 8 * c, q0, b, q_full);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages;
        if (t >= kStages) mbar_wait(empty + st, ((t / kStages) - 1) & 1);
        uint8_t* ks = ring + 2 * st * kTile;
        mbar_expect_tx(full + st, 2 * kTile);
        for (int c = 0; c < kChunks; ++c) {
          tma_load_3d(ks + c * kKChunk, &tk, h * D + 8 * c, t * kKeys, b,
                      full + st);
          tma_load_3d(ks + kTile + c * kKChunk, &tv, h * D + 8 * c,
                      t * kKeys, b, full + st);
        }
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    const int wq0 = q0 + 64 * wg;            // this warpgroup's first row
    const int row_a = wq0 + warp * 16 + lane / 4;  // fragment rows: row_a,
    const int col0 = 2 * (lane % 4);               // row_a + 8; columns
                                                   // col0, col0 + 1 of 8
    int wg_tiles = n_tiles;                  // tiles this warpgroup needs
    if (causal) {
      const int last = (wq0 + 63) / kKeys + 1;
      wg_tiles = wg_tiles < last ? wg_tiles : last;
    }

    // Q as the register A operand of S = Q K^T, read once (up to D =
    // 128); past it the products read this warpgroup's 64 rows of the Q
    // tile in shared memory.
    mbar_wait(q_full, 0);
    uint32_t qa[kQInRegs ? D / 16 : 1][4];
    if constexpr (kQInRegs) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          qa[kk][jj] = *reinterpret_cast<const uint32_t*>(
              qs + (2 * kk + (jj >> 1)) * kQChunk +
              (64 * wg + warp * 16 + lane / 4 + 8 * (jj & 1)) * 16 +
              4 * (lane % 4));
    }
    const uint8_t* wq_tile = qs + 64 * wg * 16;

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};

    float s[kKeys / 2];
    uint32_t pa[kKeys / 16][4];
    float alpha[2];
    auto issue_s = [&](int t) {              // S = Q K^T of tile t
      const uint8_t* ks = ring + 2 * (t % kStages) * kTile;
      mbar_wait(full + t % kStages, (t / kStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint64_t kd = desc_k(ks + kk * 2 * kKChunk, 128, kKChunk);
        if constexpr (kQInRegs)
          Wgmma<kKeys>::rs<0>(s, qa[kk], kd, kk > 0);
        else
          Wgmma<kKeys>::ss<0, 0>(
              s, desc_k(wq_tile + kk * 2 * kQChunk, 128, kQChunk), kd,
              kk > 0);
      }
      wgmma_commit();
    };
    // Online softmax of tile t in log2 units on the S fragment: p (in
    // place, float32) and the factor alpha that rescales the rows before
    // P V of tile t is added.
    auto softmax = [&](int t) {
      const int k0 = t * kKeys;
      const bool edge = k0 + kKeys > Skv || (causal && k0 + kKeys - 1 > wq0);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < kKeys / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[4 * i + e] * scale_log2;
          if (edge) {
            const int col = k0 + 8 * i + col0 + (e & 1);
            const int row = row_a + 8 * (e >> 1);
            if (col >= Skv || (causal && col > row)) x = kNegInf;
          }
          s[4 * i + e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = exp2f(m[r] - mx[r]);
        m[r] = mx[r];
      }
#pragma unroll
      for (int i = 0; i < kKeys / 2; ++i) {
        const float p = exp2f(s[i] - m[(i >> 1) & 1]);
        sum[(i >> 1) & 1] += p;
        s[i] = p;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        l[r] = l[r] * alpha[r] + sum[r];
      }
    };
    // p rounded to bf16 and packed as the register A operand of P V (only
    // once the last P V, which read pa, is done).
    auto pack_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          pa[kk][jj] =
              pack_bf16(s[8 * kk + 2 * jj], s[8 * kk + 2 * jj + 1]);
    };
    // acc = acc * alpha + P V of tile t, issued.
    auto issue_pv = [&](int t) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      const uint8_t* vs = ring + (2 * (t % kStages) + 1) * kTile;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk)
        mma_pv<D>(acc, pa[kk], vs + kk * 256, kKChunk);
      wgmma_commit();
    };
    auto release = [&](int t) {
      if (lane == 0) mbar_arrive(empty + t % kStages);
    };

    // Step j issues S of tile j, then P V of tile j - 1, and runs the
    // softmax of tile j while the tensor cores compute P V: the products
    // of a step overlap each other and the softmax, and no product is in
    // flight from one step into the next.
    issue_s(0);
    wgmma_wait<0>();
    fence_operands(s);
    softmax(0);
    pack_p();
    for (int j = 1; j < wg_tiles; ++j) {
      issue_s(j);
      issue_pv(j - 1);
      wgmma_wait<1>();                       // S of tile j
      fence_operands(s);
      softmax(j);
      wgmma_wait<0>();                       // P V of tile j - 1
      fence_operands(acc);
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) fence_operands(pa[kk]);
      release(j - 1);
      pack_p();
    }
    issue_pv(wg_tiles - 1);
    wgmma_wait<0>();
    fence_operands(acc);
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) fence_operands(pa[kk]);
    if constexpr (kQInRegs) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) fence_operands(qa[kk]);
    }
    // Release the last tile this warpgroup read, and those it skips.
    release(wg_tiles - 1);
    if (lane == 0) {
      for (int t = wg_tiles; t < n_tiles; ++t) {
        mbar_wait(full + t % kStages, (t / kStages) & 1);
        mbar_arrive(empty + t % kStages);
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_a + 8 * r;
      if (row >= Sq) continue;
      const float denom = fmaxf(l[r], 1e-30f);
      __nv_bfloat16* out =
          o + ((static_cast<size_t>(b) * Sq + row) * H + h) * D;
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * i + col0) =
            __floats2bfloat162_rn(acc[4 * i + 2 * r] / denom,
                                  acc[4 * i + 2 * r + 1] / denom);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, fetched through the runtime (no
// link against libcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The map of a [B, S, H, D] bf16 tensor seen as [B][S][H D]: boxes of 8
// columns x `rows` rows of one batch, zero-filled past S.
bool make_map(CUtensorMap* map, const void* base, int B, int S, int H, int D,
              int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(H) * D,
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(H) * D * 2,
                                 static_cast<cuuint64_t>(S) * H * D * 2};
  const cuuint32_t box[3] = {8, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Skv, int H, float scale, int causal,
                   cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, B, Sq, H, D, kRows) ||
      !make_map(&tk, k, B, Skv, H, D, kKeys) ||
      !make_map(&tv, v, B, Skv, H, D, kKeys))
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(D, stages(D));
  auto kernel = flash_wgmma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kRows - 1) / kRows, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), Sq, Skv, H,
      scale * kLog2e, causal);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// q [B, Sq, H, D], k and v [B, Skv, H, D], o [B, Sq, H, D], all contiguous
// and of one type: dtype 0 = float32, 1 = bfloat16. D <= 256. The SIMT
// kernel. Returns a cudaError_t.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Sq,
                                      int Skv, int H, int D, int dtype,
                                      float scale, int causal, void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || H < 1 || D < 1 || D > 256 ||
      (dtype != 0 && dtype != 1) || smem_bytes(D) > kMaxSmem ||
      H > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0
          ? launch_d<float>(q, k, v, o, B, Sq, Skv, H, D, scale, causal, s)
          : launch_d<__nv_bfloat16>(q, k, v, o, B, Sq, Skv, H, D, scale,
                                    causal, s);
  return static_cast<int>(err);
}

// The same contract for bfloat16 only, D a multiple of 16 up to 256, the
// pointers 16-byte aligned: the tensor-core kernel, one instantiation per
// head dim. Returns a cudaError_t.
extern "C" int flash_attention_wgmma_launch(const void* q, const void* k,
                                            const void* v, void* o, int B,
                                            int Sq, int Skv, int H, int D,
                                            float scale, int causal,
                                            void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || H < 1 || D < 16 || D > 256 ||
      D % 16 != 0 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) %
      16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_TC_ARGS q, k, v, o, B, Sq, Skv, H, scale, causal, s
  cudaError_t err;
  switch (D) {
    case 16: err = tc::launch<16>(FLASH_TC_ARGS); break;
    case 32: err = tc::launch<32>(FLASH_TC_ARGS); break;
    case 48: err = tc::launch<48>(FLASH_TC_ARGS); break;
    case 64: err = tc::launch<64>(FLASH_TC_ARGS); break;
    case 80: err = tc::launch<80>(FLASH_TC_ARGS); break;
    case 96: err = tc::launch<96>(FLASH_TC_ARGS); break;
    case 112: err = tc::launch<112>(FLASH_TC_ARGS); break;
    case 128: err = tc::launch<128>(FLASH_TC_ARGS); break;
    case 144: err = tc::launch<144>(FLASH_TC_ARGS); break;
    case 160: err = tc::launch<160>(FLASH_TC_ARGS); break;
    case 176: err = tc::launch<176>(FLASH_TC_ARGS); break;
    case 192: err = tc::launch<192>(FLASH_TC_ARGS); break;
    case 208: err = tc::launch<208>(FLASH_TC_ARGS); break;
    case 224: err = tc::launch<224>(FLASH_TC_ARGS); break;
    case 240: err = tc::launch<240>(FLASH_TC_ARGS); break;
    case 256: err = tc::launch<256>(FLASH_TC_ARGS); break;
    default: err = cudaErrorInvalidValue; break;
  }
#undef FLASH_TC_ARGS
  return static_cast<int>(err);
}
