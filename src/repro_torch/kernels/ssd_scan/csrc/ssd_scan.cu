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
// What bounds it: three small products per (batch, chunk, head), about
// Q^2 P + Q P N multiply-adds (2.1 MFLOP at Q = 128, P = N = 64; the C B^T
// scores are per group, not per head), held to the card's float32 peak
// outside the tensor cores, since float32 products are the contract (TF32
// keeps too few digits for the 1e-4 bound); the bytes (x, B, C read once in
// their own type, dt once, y and S written once in float32) come close
// behind. The TPU kernel ran one grid cell per (batch, chunk, head) with the
// [Q, Q] decay matrix in VMEM. Here one block of 256 threads does the same
// cell: x, B, C (of the head's group g = h / (H / G), never repeated per
// head in device memory), dt and cum are staged as float32 in dynamic
// shared memory (with the weight scratch: 117 KB at Q = 128, P = N = 64;
// 183 KB at N = 128, past the 48 KB static limit), then S (warp per 8th of
// the P rows, lanes over N), then per 32-row query tile the
// decay-weighted scores W (lanes over keys, key tiles above the diagonal
// skipped) into a [32, Q] scratch and y = W x (lanes over P). B and C rows
// are padded to an odd stride so lanes reading 32 keys of one column hit 32
// banks. Heads of one group run in neighbouring blocks, so their B and C
// reads hit L2. A plain SIMT kernel; tensor cores, TMA and pipelining are
// left for later work.
//
// Numerics: float32 throughout, exp of a clamped exponent (the clamp comes
// before exp, as the reference's model does); built without --fmad=false
// (no discrete decision depends on these floats). The cumsum comes in from
// the wrapper, which takes it with the plain version's own op
// (torch.cumsum), where the TPU kernel took it in the kernel: a cumsum in
// another order moves cum by a few ulps of |cum|, which reaches hundreds
// within a chunk of mamba2's random-weight layers, and every decay weight
// by as much relative, past the 2e-4 bound. Only the order of the
// products' sums and FMA contraction differ from the plain version.
//
// The launch runs on the caller's stream, never synchronizes and allocates
// nothing: the wrapper (ops.py) checks the inputs and allocates the outputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

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

}  // namespace

// Dynamic shared memory one block needs (bytes).
extern "C" long long ssd_scan_smem_bytes(int Q, int P, int N) {
  return static_cast<long long>(smem_bytes(Q, P, N));
}

// x [B, NC, Q, H, P], dt and cum [B, NC, Q, H] float32 (cum the inclusive
// cumsum of dt * a over Q), b and c [B, NC, Q, G, N] (G divides H), all
// contiguous; x, b, c of one type: dtype 0 = float32, 1 = bfloat16. Writes
// y [B, NC, Q, H, P] and s [B, NC, H, P, N], float32. Q a multiple of 32 up
// to 256, P and N up to 128. Returns a cudaError_t.
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

#undef SSD_ARGS
#undef SSD_PARAMS
