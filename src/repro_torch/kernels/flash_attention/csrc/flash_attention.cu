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
// This first Hopper version is a plain SIMT kernel, far from that bound:
// one block of 256 threads per (batch, head, 64-row query tile) walks the
// key tiles in a loop; q, k and v tiles are staged in dynamic shared memory
// as float32 (rows padded so that 16-byte reads of neighbouring rows hit
// distinct banks, the ragged S and d edges zero-filled, no padding copies in
// device memory); each warp owns 8 query rows: lane j scores keys j and
// j + 32 of the tile against the 8 rows (float4 reads of q and k), the row
// max and sum go through warp shuffles, p goes to a per-warp scratch row
// and the accumulator is split over lanes (lane owns dims lane + 32 t, any
// d <= 128, so zamba2's 112 runs unpadded). Tensor cores (wgmma), TMA and
// pipelining are left for later work.
//
// Numerics: float32 throughout; built without --fmad=false (no discrete
// decision depends on these floats). The key sum of each score runs in
// dimension order, as a dot product; only summation order and FMA
// contraction differ from the plain version.
//
// The launch runs on the caller's stream, never synchronizes and allocates
// nothing: the wrapper (ops.py) checks the inputs and allocates the output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

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
    default: return launch<T, 4>(FLASH_ARGS);
  }
#undef FLASH_ARGS
}

}  // namespace

// q [B, Sq, H, D], k and v [B, Skv, H, D], o [B, Sq, H, D], all contiguous
// and of one type: dtype 0 = float32, 1 = bfloat16. D <= 128. Returns a
// cudaError_t.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Sq,
                                      int Skv, int H, int D, int dtype,
                                      float scale, int causal, void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || H < 1 || D < 1 || D > 128 ||
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
