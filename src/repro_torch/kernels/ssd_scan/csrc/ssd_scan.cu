// Mamba2 SSD intra-chunk step for Hopper (sm_90a): the chunked scan of every
// Mamba2 layer of zamba2 and mamba2 on the prefill path.
//
// Replaces the TPU Pallas kernel `_ssd_kernel` in
// src/repro/kernels/ssd_scan/kernel.py:29 (called through
// `ssd_intra_chunk_pallas`, wrapper `ssd_chunked_pallas` in
// src/repro/kernels/ssd_scan/ops.py:15). For each (batch, chunk, head),
// given the inclusive cumsum cum of dt * a over the chunk's Q tokens, it
// forms the intra-chunk output
//     y[q] = sum_{j <= q} (C_q . B_j) * exp(min(cum_q - cum_j, 0)) * dt_j * x_j
// and the chunk's summary state
//     S = sum_j (exp(cum_end - cum_j) * dt_j) * outer(x_j, B_j),
// both in float32. The inter-chunk recurrence stays outside (ops.py).
//
// What bounds it: the bytes (x, B, C read once in their own type, dt and cum
// once, y and S written once in float32: 0.476 GB at zamba2's layer, 0.142
// ms at 3.35 TB/s), ahead of the products (about Q^2 P + Q P N multiply-adds
// per (batch, chunk, head), the C B^T scores once per group). The TPU
// kernel ran one grid cell per (batch, chunk, head) with the [Q, Q] decay
// matrix in VMEM.
//
// Two kernels, chosen by the wrapper (ops.py `variant`) from the dtype and
// the shape alone:
//
// `ssd_wgmma_kernel` (bf16 x, B, C; Q of 64 or 128, P = 64, N of 32, 64 or
// 128; the prefill's path): one block per (batch, chunk, group, tile of 8
// heads of that group; the heads past H / G masked), Q / 64 warpgroups,
// each owning 64 query rows. x, B and C are read in place wherever each
// token's row is contiguous (the model's x, B and C are slices of one
// projection, their tokens a projection row apart). The block loads C and
// B of the group once (cp.async into the core-matrix layout of
// hopper/wgmma.cuh, each warp's shared-memory writes contiguous) and
// computes the [Q, Q] scores C B^T once with `wgmma` (bf16 x bf16 products
// are exact in float32, accumulated in float32), kept in registers for all
// its heads: zamba2 (G = 1, H = 112) computes them 14 times per (batch,
// chunk) instead of 112. Per head, with x, dt and cum of the next head
// already in flight (a three-stage cp.async ring):
//   - xw = x * exp(cum_end - cum_j) * dt_j split into two bf16 tiles in
//     shared memory (xw_hi + xw_lo);
//   - W = scores * exp(min(cum_q - cum_j, 0)) * dt_j (j <= q, else 0), in
//     float32 on the fragment, split W = W_hi + W_mid + W_lo into three
//     bf16 terms; y = W_hi x + W_mid x + W_lo x with W the register A
//     operand of `wgmma.m64n64k16` and x (exact in bf16) the shared-memory
//     B operand, 64 keys at a time, key slices above the diagonal skipped;
//   - S = xw_hi^T B + xw_lo^T B with both operands read MN-major (transpose
//     bits), each warpgroup a slice of N, computed while y goes out: y is
//     staged in shared memory and written head-major ([B, NC, H, Q, P],
//     16 KB contiguous per warpgroup), S per head is contiguous too.
// Numerics: TF32 keeps too few digits for the 1e-4 bound, so the float32
// factors are split instead: one bf16 term errs by up to 2^-8 relative, two
// by 2^-16 and three by 2^-24. Two terms met every bound on the card, but
// y with little margin, so W takes three terms; xw keeps two (the states'
// errors stay an order of magnitude inside their bound).
// The in-chunk decay is exp2 of the clamped exponent times log2(e) (a few
// ulps from exp; the weights that matter have exponents of a few units).
// The products and sums are float32 (the CPU emulation of these splits is
// held to the bounds in tests/test_torch_tc_numerics.py).
//
// `ssd_scan_kernel` (float32 inputs, and the bf16 chunks that the wgmma
// tiling does not take, such as Q = 32): the SIMT kernel. One block of 256
// threads per (batch, chunk, head): x, B, C (of the head's group g = h /
// (H / G), never repeated per head in device memory), dt and cum are staged
// as float32 in dynamic shared memory (with the weight scratch: 117 KB at
// Q = 128, P = N = 64; 183 KB at N = 128), then S (warp per 8th of the P
// rows, lanes over N), then per 32-row query tile the decay-weighted scores
// W (lanes over keys, key tiles above the diagonal skipped) into a [32, Q]
// scratch and y = W x (lanes over P). B and C rows are padded to an odd
// stride so lanes reading 32 keys of one column hit 32 banks. Float32
// throughout; only the order of the products' sums and FMA contraction
// differ from the plain version.
//
// Both: exp of a clamped exponent (the clamp comes before exp, as the
// reference's model does); built without --fmad=false (no discrete
// decision depends on these floats). The cumsum comes in from the wrapper,
// which takes it with the plain version's own op (torch.cumsum), where the
// TPU kernel took it in the kernel: a cumsum in another order moves cum by
// a few ulps of |cum|, which reaches hundreds within a chunk of mamba2's
// random-weight layers, and every decay weight by as much relative, past
// the 2e-4 bound.
//
// A launch runs on the caller's stream, never synchronizes and allocates
// nothing: the wrapper (ops.py) checks the inputs and allocates the
// outputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "wgmma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileQ = 32;                  // query rows per W / y tile
constexpr int kRowsPerWarp = kTileQ / kWarps;
constexpr int kMaxQk = 8;                   // Q <= 256
constexpr int kMaxSmem = 232448;            // 227 KB, the per-block limit

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__host__ __device__ __forceinline__ size_t smem_bytes(int Q, int P, int N) {
  const size_t ns = static_cast<size_t>(N | 1);
  return sizeof(float) * (static_cast<size_t>(Q) * P + 2 * Q * ns + 3 * Q +
                          static_cast<size_t>(kTileQ) * Q);
}

// kPk: P <= 32 kPk; kNk: N <= 32 kNk.
template <typename T, int kPk, int kNk>
__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ cum_in, const T* __restrict__ bm,
    const T* __restrict__ cm, float* __restrict__ y,
    float* __restrict__ s_out, int NC, int Q, int H, int P, int G, int N) {
  extern __shared__ float smem[];
  const int ns = N | 1;
  float* xs = smem;                    // [Q][P]
  float* bs = xs + Q * P;              // [Q][ns]
  float* cs = bs + Q * ns;             // [Q][ns]
  float* dts = cs + Q * ns;            // [Q]
  float* cum = dts + Q;                // [Q]
  float* dend = cum + Q;               // [Q] exp(cum_end - cum_j) dt_j
  float* ws = dend + Q;                // [32][Q] a query tile's weights

  const int h = blockIdx.x;
  const int c = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / G);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t row0 = (static_cast<size_t>(b) * NC + c) * Q;  // token row

  for (int e = threadIdx.x; e < Q * P; e += kThreads) {
    const int q = e / P;
    const int p = e - q * P;
    xs[e] = to_f32(x[((row0 + q) * H + h) * P + p]);
  }
  for (int e = threadIdx.x; e < Q * N; e += kThreads) {
    const int q = e / N;
    const int n = e - q * N;
    const size_t at = ((row0 + q) * G + g) * N + n;
    bs[q * ns + n] = to_f32(bm[at]);
    cs[q * ns + n] = to_f32(cm[at]);
  }
  for (int q = threadIdx.x; q < Q; q += kThreads) {
    dts[q] = dt[(row0 + q) * H + h];
    cum[q] = cum_in[(row0 + q) * H + h];
  }
  __syncthreads();
  for (int q = threadIdx.x; q < Q; q += kThreads)
    dend[q] = expf(cum[Q - 1] - cum[q]) * dts[q];
  __syncthreads();

  // Chunk state S [P, N]: warp w owns rows p = w + 8 i, lane owns columns
  // n = lane + 32 t.
  {
    float acc[4 * kPk][kNk];
#pragma unroll
    for (int i = 0; i < 4 * kPk; ++i)
#pragma unroll
      for (int t = 0; t < kNk; ++t) acc[i][t] = 0.f;
    for (int j = 0; j < Q; ++j) {
      const float d = dend[j];
      float bv[kNk];
#pragma unroll
      for (int t = 0; t < kNk; ++t) {
        const int n = lane + 32 * t;
        bv[t] = n < N ? bs[j * ns + n] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4 * kPk; ++i) {
        const int p = warp + kWarps * i;
        if (p < P) {
          const float xw = xs[j * P + p] * d;
#pragma unroll
          for (int t = 0; t < kNk; ++t) acc[i][t] += xw * bv[t];
        }
      }
    }
    float* s_cell = s_out + ((static_cast<size_t>(b) * NC + c) * H + h) *
                                static_cast<size_t>(P) * N;
#pragma unroll
    for (int i = 0; i < 4 * kPk; ++i) {
      const int p = warp + kWarps * i;
#pragma unroll
      for (int t = 0; t < kNk; ++t) {
        const int n = lane + 32 * t;
        if (p < P && n < N)
          s_cell[static_cast<size_t>(p) * N + n] = acc[i][t];
      }
    }
  }

  // y, one 32-row query tile at a time: warp w owns rows w * 4 + i.
  for (int t0 = 0; t0 < Q; t0 += kTileQ) {
    const int nk = t0 / 32 + 1;        // key tiles at or below the diagonal
    const int r0 = warp * kRowsPerWarp;
    float sc[kRowsPerWarp][kMaxQk];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
      for (int k = 0; k < kMaxQk; ++k) sc[i][k] = 0.f;
    for (int n = 0; n < N; ++n) {
      float cv[kRowsPerWarp];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i)
        cv[i] = cs[(t0 + r0 + i) * ns + n];
#pragma unroll
      for (int k = 0; k < kMaxQk; ++k) {
        if (k < nk) {
          const float bv = bs[(lane + 32 * k) * ns + n];
#pragma unroll
          for (int i = 0; i < kRowsPerWarp; ++i) sc[i][k] += cv[i] * bv;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int q = t0 + r0 + i;
#pragma unroll
      for (int k = 0; k < kMaxQk; ++k) {
        if (k < nk) {
          const int j = lane + 32 * k;
          float w = 0.f;
          if (j <= q)
            w = sc[i][k] * expf(fminf(cum[q] - cum[j], 0.f)) * dts[j];
          ws[(r0 + i) * Q + j] = w;
        }
      }
    }
    __syncthreads();

    float ya[kRowsPerWarp][kPk];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
      for (int t = 0; t < kPk; ++t) ya[i][t] = 0.f;
    const int j_end = t0 + kTileQ;
    for (int j = 0; j < j_end; ++j) {
      float xv[kPk];
#pragma unroll
      for (int t = 0; t < kPk; ++t) {
        const int p = lane + 32 * t;
        xv[t] = p < P ? xs[j * P + p] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float wv = ws[(r0 + i) * Q + j];
#pragma unroll
        for (int t = 0; t < kPk; ++t) ya[i][t] += wv * xv[t];
      }
    }
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const size_t at = ((row0 + t0 + r0 + i) * H + h) * P;
#pragma unroll
      for (int t = 0; t < kPk; ++t) {
        const int p = lane + 32 * t;
        if (p < P) y[at + p] = ya[i][t];
      }
    }
    __syncthreads();                   // ws is rewritten by the next tile
  }
}

template <typename T, int kPk, int kNk>
cudaError_t launch(const void* x, const float* dt, const float* cum,
                   const void* bm, const void* cm, float* y, float* s, int B,
                   int NC, int Q, int H, int P, int G, int N,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(Q, P, N);
  auto kernel = ssd_scan_kernel<T, kPk, kNk>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(H, NC, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, cum, static_cast<const T*>(bm),
      static_cast<const T*>(cm), y, s, NC, Q, H, P, G, N);
  return cudaGetLastError();
}

#define SSD_ARGS x, dt, cum, bm, cm, y, s, B, NC, Q, H, P, G, N, st
#define SSD_PARAMS                                                        \
  const void *x, const float *dt, const float *cum, const void *bm,       \
      const void *cm, float *y, float *s, int B, int NC, int Q, int H,    \
      int P, int G, int N, cudaStream_t st

template <typename T, int kPk>
cudaError_t launch_n(SSD_PARAMS) {
  if (N <= 32) return launch<T, kPk, 1>(SSD_ARGS);
  if (N <= 64) return launch<T, kPk, 2>(SSD_ARGS);
  return launch<T, kPk, 4>(SSD_ARGS);
}

template <typename T>
cudaError_t launch_p(SSD_PARAMS) {
  if (P <= 32) return launch_n<T, 1>(SSD_ARGS);
  if (P <= 64) return launch_n<T, 2>(SSD_ARGS);
  return launch_n<T, 4>(SSD_ARGS);
}

// ---------------------------------------------------------------------------
// The tensor-core kernel (bf16; Q 64 or 128, P 64, N 32, 64 or 128)
// ---------------------------------------------------------------------------

namespace tc {

using hopper::cp_async4;

constexpr int kP = 64;                      // head dim
constexpr int kHeads = 8;                   // heads per block
constexpr int kXStages = 3;                 // ring of x, dt, cum (heads)
constexpr int kYStride = kP + 8;            // floats a staged y row
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory (bytes): C and B [Q, N], kXStages stages of x [Q, P],
// xw_hi and xw_lo [Q, P] (bf16 core-matrix tiles), kXStages stages of dt and
// cum [Q] (float32), and y staged [Q, P] (float32, rows padded to
// kYStride).
__host__ __device__ constexpr size_t smem_bytes(int Q, int N) {
  return static_cast<size_t>(2) * Q * N * 2 + (kXStages + 2) * Q * kP * 2 +
         2 * kXStages * Q * 4 + static_cast<size_t>(Q) * kYStride * 4;
}

template <int Q, int N>
struct Smem {
  static constexpr int kC = 0;
  static constexpr int kB = kC + Q * N * 2;
  static constexpr int kX = kB + Q * N * 2;          // kXStages stages
  static constexpr int kXwHi = kX + kXStages * Q * kP * 2;
  static constexpr int kXwLo = kXwHi + Q * kP * 2;
  static constexpr int kDt = kXwLo + Q * kP * 2;     // kXStages stages
  static constexpr int kCum = kDt + kXStages * Q * 4;
  static constexpr int kY = kCum + kXStages * Q * 4;
  static_assert(kY + Q * kYStride * 4 == smem_bytes(Q, N), "layout");
};

// x, dt and cum of head h into stage buffers, by cp.async; x's tokens are
// sx elements apart.
template <int Q>
__device__ __forceinline__ void load_head(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ cum, uint8_t* xs, float* dts, float* cums,
    size_t row0, int h, int H, long long sx, int n_threads) {
  hopper::load_tile<kP / 8>(xs, Q, n_threads, [=](int r, int c) {
    return x + (row0 + r) * sx + h * kP + c * 8;
  });
  for (int r = threadIdx.x; r < Q; r += n_threads) {
    cp_async4(dts + r, dt + (row0 + r) * H + h);
    cp_async4(cums + r, cum + (row0 + r) * H + h);
  }
}

template <int Q, int N>
__global__ void __launch_bounds__(128 * (Q / 64), 1) ssd_wgmma_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ cum_in, const __nv_bfloat16* __restrict__ bm,
    const __nv_bfloat16* __restrict__ cm, float* __restrict__ y,
    float* __restrict__ s_out, int NC, int H, int G, long long sx,
    long long sb, long long sc_, int tiles_per_group) {
  using namespace hopper;
  using L = Smem<Q, N>;
  constexpr int kWg = Q / 64;
  constexpr int kThreads = 128 * kWg;
  constexpr int kChunksN = N / 8;
  constexpr int kChunksP = kP / 8;
  constexpr int kRowGroupN = N * 16;
  constexpr int kRowGroupP = kP * 16;
  constexpr int kNs = N / kWg;               // state columns per warpgroup
  extern __shared__ __align__(128) uint8_t smem[];

  const int g = blockIdx.x / tiles_per_group;
  const int tile = blockIdx.x - g * tiles_per_group;
  const int c = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = H / G;
  const int h0 = g * rep + tile * kHeads;
  const int nh = min(kHeads, rep - tile * kHeads);
  const size_t row0 = (static_cast<size_t>(b) * NC + c) * Q;  // token row
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;

  load_tile<kChunksN>(smem + L::kC, Q, kThreads, [=](int r, int cc) {
    return cm + (row0 + r) * sc_ + g * N + cc * 8;
  });
  load_tile<kChunksN>(smem + L::kB, Q, kThreads, [=](int r, int cc) {
    return bm + (row0 + r) * sb + g * N + cc * 8;
  });
  // Head t of the block: x, dt and cum into stage t % kXStages.
  auto load = [&](int t) {
    const int st = t % kXStages;
    load_head<Q>(x, dt, cum_in, smem + L::kX + st * Q * kP * 2,
                 reinterpret_cast<float*>(smem + L::kDt) + st * Q,
                 reinterpret_cast<float*>(smem + L::kCum) + st * Q, row0,
                 h0 + t, H, sx, kThreads);
  };
  load(0);                                   // one group per head, the
  cp_async_commit();                         // first with B and C
  for (int t = 1; t < kXStages - 1; ++t) {
    if (t < nh) load(t);
    cp_async_commit();
  }
  cp_async_wait<kXStages - 2>();
  fence_proxy_async();
  __syncthreads();

  // Scores C B^T of this warpgroup's 64 rows against all Q keys, once for
  // all the block's heads.
  float sc[Q / 2];
#pragma unroll
  for (int i = 0; i < Q / 2; ++i) sc[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
    Wgmma<Q>::template ss<0, 0>(
        sc, desc_k(smem + L::kC + wg * 8 * kRowGroupN + kk * 256, kRowGroupN),
        desc_k(smem + L::kB + kk * 256, kRowGroupN), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(sc);

  const int row_a = wg * 64 + warp * 16 + lane / 4;  // fragment rows row_a,
  const int col0 = 2 * (lane % 4);                    // row_a + 8

  for (int hi = 0; hi < nh; ++hi) {
    const int st = hi % kXStages;
    const int h = h0 + hi;
    if (hi > 0) {
      cp_async_wait<kXStages - 2>();         // this head's x, dt, cum
      fence_proxy_async();
      __syncthreads();                       // and the last head is done
    }
    if (hi + kXStages - 1 < nh) load(hi + kXStages - 1);
    cp_async_commit();
    const uint8_t* xs = smem + L::kX + st * Q * kP * 2;
    // Row 0 of this head in y [B, NC, H, Q, P].
    const size_t y_head = ((static_cast<size_t>(b) * NC + c) * H + h) * Q;
    const float* dts = reinterpret_cast<const float*>(smem + L::kDt) + st * Q;
    const float* cums =
        reinterpret_cast<const float*>(smem + L::kCum) + st * Q;

    // xw = x * exp(cum_end - cum_j) * dt_j, as hi + lo bf16 tiles.
    const float cum_end = cums[Q - 1];
    for (int e = threadIdx.x; e < Q * kChunksP; e += kThreads) {
      const int r = (e / (8 * kChunksP)) * 8 + (e & 7);   // at byte 16 e,
      const int off = 16 * e;                             // as load_tile
      const float w = expf(cum_end - cums[r]) * dts[r];
      const uint4 raw = *reinterpret_cast<const uint4*>(xs + off);
      const uint32_t in[4] = {raw.x, raw.y, raw.z, raw.w};
      uint32_t hv[4], lv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float2 xv = unpack_bf16(in[u]);
        split_pack_bf16(w * xv.x, w * xv.y, hv[u], lv[u]);
      }
      *reinterpret_cast<uint4*>(smem + L::kXwHi + off) =
          make_uint4(hv[0], hv[1], hv[2], hv[3]);
      *reinterpret_cast<uint4*>(smem + L::kXwLo + off) =
          make_uint4(lv[0], lv[1], lv[2], lv[3]);
    }

    // y = W x, W = scores * exp(min(cum_q - cum_j, 0)) * dt_j (j <= q) on
    // the fragment, split into hi + mid + lo A operands, 64 keys at a time
    // (the key slices of this warpgroup at or below the diagonal).
    float ya[kP / 2];
#pragma unroll
    for (int i = 0; i < kP / 2; ++i) ya[i] = 0.f;
    const float cum_r[2] = {cums[row_a], cums[row_a + 8]};
#pragma unroll
    for (int half = 0; half < kWg; ++half) {
      if (half > wg) continue;               // above the diagonal
      uint32_t wt[3][4][4];
#pragma unroll
      for (int kq = 0; kq < 4; ++kq)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int kk = 4 * half + kq;
          const int r = jj & 1;
          const int row = row_a + 8 * r;
          const int colb = 16 * kk + 8 * (jj >> 1) + col0;
          float w[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int col = colb + u;
            w[u] = 0.f;
            if (col <= row)
              w[u] = sc[8 * kk + 2 * jj + u] *
                     exp2f(fminf(cum_r[r] - cums[col], 0.f) * kLog2e) *
                     dts[col];
          }
          split3_pack_bf16(w[0], w[1], wt[0][kq][jj], wt[1][kq][jj],
                           wt[2][kq][jj]);
        }
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < 3; ++t)
#pragma unroll
        for (int kq = 0; kq < 4; ++kq)
          Wgmma<kP>::rs<1>(
              ya, wt[t][kq],
              desc_mn(xs + (4 * half + kq) * 2 * kRowGroupP, kRowGroupP), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(ya);
#pragma unroll
      for (int t = 0; t < 3; ++t)
#pragma unroll
        for (int kq = 0; kq < 4; ++kq) fence_operands(wt[t][kq]);
    }

    // The xw tiles are written by all threads: make them visible to the
    // state products.
    fence_proxy_async();
    __syncthreads();

    // S[:, this warpgroup's N slice] = xw_hi^T B + xw_lo^T B.
    float sa[kNs / 2];
#pragma unroll
    for (int i = 0; i < kNs / 2; ++i) sa[i] = 0.f;
    const uint8_t* b_slice = smem + L::kB + wg * (kNs / 8) * 128;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < Q / 16; ++kk)
      Wgmma<kNs>::template ss<1, 1>(
          sa, desc_mn(smem + L::kXwHi + kk * 2 * kRowGroupP, kRowGroupP),
          desc_mn(b_slice + kk * 2 * kRowGroupN, kRowGroupN), 1);
#pragma unroll
    for (int kk = 0; kk < Q / 16; ++kk)
      Wgmma<kNs>::template ss<1, 1>(
          sa, desc_mn(smem + L::kXwLo + kk * 2 * kRowGroupP, kRowGroupP),
          desc_mn(b_slice + kk * 2 * kRowGroupN, kRowGroupN), 1);
    wgmma_commit();

    // y, while S is computed: the fragment through this warpgroup's
    // staging tile, then its 64 rows of the head as one contiguous 16 KB
    // run of the head-major y (16 bytes a thread).
    float* ys = reinterpret_cast<float*>(smem + L::kY) + wg * 64 * kYStride;
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int i = 0; i < kP / 8; ++i)
        *reinterpret_cast<float2*>(
            ys + (warp * 16 + lane / 4 + 8 * r) * kYStride + 8 * i + col0) =
            make_float2(ya[4 * i + 2 * r], ya[4 * i + 2 * r + 1]);
    named_barrier(1 + wg, 128);
    {
      const int t = threadIdx.x % 128;
#pragma unroll
      for (int k = 0; k < 64 * kP / 4 / 128; ++k) {
        const int r = k * 8 + t / 16;          // row of this warpgroup
        const int c = (t % 16) * 4;            // first of 4 columns
        *reinterpret_cast<float4*>(y + (y_head + wg * 64 + r) * kP + c) =
            *reinterpret_cast<const float4*>(ys + r * kYStride + c);
      }
    }

    wgmma_wait<0>();
    fence_operands(sa);
    float* s_head =
        s_out + ((static_cast<size_t>(b) * NC + c) * H + h) * kP * N;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float* srow = s_head + (warp * 16 + lane / 4 + 8 * r) * N + wg * kNs;
#pragma unroll
      for (int i = 0; i < kNs / 8; ++i)
        *reinterpret_cast<float2*>(srow + 8 * i + col0) =
            make_float2(sa[4 * i + 2 * r], sa[4 * i + 2 * r + 1]);
    }
  }
}

template <int Q, int N>
cudaError_t launch(const void* x, const float* dt, const float* cum,
                   const void* bm, const void* cm, float* y, float* s, int B,
                   int NC, int H, int G, long long sx, long long sb,
                   long long sc, cudaStream_t stream) {
  const size_t smem = smem_bytes(Q, N);
  auto kernel = ssd_wgmma_kernel<Q, N>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int tiles = (H / G + kHeads - 1) / kHeads;
  const dim3 grid(G * tiles, NC, B);
  kernel<<<grid, 128 * (Q / 64), smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), dt, cum,
      static_cast<const __nv_bfloat16*>(bm),
      static_cast<const __nv_bfloat16*>(cm), y, s, NC, H, G, sx, sb, sc,
      tiles);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// Dynamic shared memory one block needs (bytes): variant 0 the SIMT kernel,
// 1 the tensor-core kernel.
extern "C" long long ssd_scan_smem_bytes(int Q, int P, int N, int variant) {
  return static_cast<long long>(variant == 1 ? tc::smem_bytes(Q, N)
                                             : smem_bytes(Q, P, N));
}

// x [B, NC, Q, H, P], dt and cum [B, NC, Q, H] float32 (cum the inclusive
// cumsum of dt * a over Q), b and c [B, NC, Q, G, N] (G divides H), all
// contiguous; x, b, c of one type: dtype 0 = float32, 1 = bfloat16. Writes
// y [B, NC, Q, H, P] and s [B, NC, H, P, N], float32. Q a multiple of 32 up
// to 256, P and N up to 128. The SIMT kernel. Returns a cudaError_t.
extern "C" int ssd_scan_launch(const void* x, const float* dt,
                               const float* cum, const void* bm,
                               const void* cm, float* y, float* s, int B,
                               int NC, int Q, int H, int P, int G, int N,
                               int dtype, void* stream) {
  if (B < 1 || B > 65535 || NC < 1 || NC > 65535 || Q < 32 || Q % 32 != 0 ||
      Q > 32 * kMaxQk || H < 1 || P < 1 || P > 128 || G < 1 || H % G != 0 ||
      N < 1 || N > 128 || (dtype != 0 && dtype != 1) ||
      smem_bytes(Q, P, N) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0 ? launch_p<float>(SSD_ARGS)
                                     : launch_p<__nv_bfloat16>(SSD_ARGS);
  return static_cast<int>(err);
}

// The same contract for bfloat16 x, b, c with Q of 64 or 128, P = 64 and N
// of 32, 64 or 128, except that x, b and c need only be contiguous within a
// token, their tokens sx, sb, sc elements apart (multiples of 8; the
// pointers 16-byte aligned), and that y is written head-major,
// [B, NC, H, Q, P] (the wrapper returns it as a [B, NC, Q, H, P] view):
// the tensor-core kernel. Returns a cudaError_t.
extern "C" int ssd_scan_wgmma_launch(const void* x, const float* dt,
                                     const float* cum, const void* bm,
                                     const void* cm, float* y, float* s,
                                     int B, int NC, int Q, int H, int P,
                                     int G, int N, long long sx,
                                     long long sb, long long sc,
                                     void* stream) {
  if (B < 1 || B > 65535 || NC < 1 || NC > 65535 || (Q != 64 && Q != 128) ||
      H < 1 || P != tc::kP || G < 1 || H % G != 0 ||
      (N != 32 && N != 64 && N != 128) || sx < H * P || sb < G * N ||
      sc < G * N || (sx | sb | sc) % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(bm) |
       reinterpret_cast<uintptr_t>(cm)) %
      16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SSD_TC_ARGS x, dt, cum, bm, cm, y, s, B, NC, H, G, sx, sb, sc, st
  cudaError_t err;
  if (Q == 64)
    err = N == 32   ? tc::launch<64, 32>(SSD_TC_ARGS)
          : N == 64 ? tc::launch<64, 64>(SSD_TC_ARGS)
                    : tc::launch<64, 128>(SSD_TC_ARGS);
  else
    err = N == 32   ? tc::launch<128, 32>(SSD_TC_ARGS)
          : N == 64 ? tc::launch<128, 64>(SSD_TC_ARGS)
                    : tc::launch<128, 128>(SSD_TC_ARGS);
#undef SSD_TC_ARGS
  return static_cast<int>(err);
}

#undef SSD_ARGS
#undef SSD_PARAMS
