// Fluid flit-level router simulation for Hopper (sm_90a): the Fig. 13 path.
//
// Replaces the TPU Pallas kernel `_noc_kernel` in
// src/repro/kernels/noc_step/kernel.py:32. Each run is one chiplet's network
// of R nodes (mesh routers plus gateway sinks, or a padded topology with dead
// lanes). Per cycle: arrivals are added and dead lanes zeroed (a static [R]
// mask or a time-varying [T, R] one), every router offers min(occ,
// link_rate) flits to its next hop, each destination scales its senders by
// its free buffer space (proportional sharing), the moved flits land, the
// sinks drain, and a masked cycle (t_mask) freezes the whole state. Outputs
// the residency integral (sum of occupancy over cycles), the final occupancy
// and the drained total per node, for B independent runs in one launch.
//
// What bounds it: the arrivals [B, T, R] are the only large input, read
// once (the 512-run x 8192-cycle DSE needs ~0.21 ms of them at 3.35 TB/s in
// its live lanes; this kernel reads every lane, ~0.35 ms' worth), but in
// practice the serial T-cycle chain inside a run bounds it: each
// cycle is a dependent chain of three warp exchanges through shared memory
// and one IEEE division. The TPU kernel walked time chunks on a sequential
// grid and did three [1,R]@[R,R] MXU products per cycle over a 128-lane pad.
// Here the parallel axis is the run: one WARP runs one run for all T cycles,
// thread j owns nodes j, j+32, j+64, j+96 (R <= 128) and keeps their
// occupancy, residency, drained total, drain, buffer, static mask, next hop
// and in-edge list in registers; nothing carries between blocks. The
// one-hot products become a next-hop gather (scale_src = scale_dst[next])
// and per-destination sums over the in-edge list (sources in ascending
// order), read from shared memory after a __syncwarp. Arrivals (and the
// time-varying mask and t_mask) do not depend on the state, so each warp
// prefetches them kDepth cycles ahead into registers: one coalesced row per
// cycle per run. Many runs fill the card; a single run is pure chain
// latency.
//
// Numerics: build with --fmad=false. Every float is computed op for op as
// the plain PyTorch version computes it (IEEE division, min/max, masks and
// t_mask applied by multiplication), so an all-ones time-varying mask is
// bitwise the static run and a batch of runs is bitwise the runs one by one;
// against the plain version only the order of the in-edge sums may differ.
//
// The launch runs on the caller's stream, never synchronizes and allocates
// nothing: the wrapper (ops.py) derives next_hop / in_src from the one-hot
// routing matrix and allocates the outputs.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kMaxNodesPerThread = 4;           // R <= 128
constexpr int kMaxNodes = 32 * kMaxNodesPerThread;
constexpr int kMaxInDegree = 6;                 // hex neighbors; MAX_IN_DEGREE
constexpr int kDepth = 4;                       // cycles prefetched ahead

// Inputs of cycles [t0, t0 + kDepth) of run b into registers (zero past T).
template <int kPer, bool kTv>
__device__ __forceinline__ void load_cycles(
    const float* __restrict__ arrivals, const float* __restrict__ t_mask,
    const float* __restrict__ mask_t, size_t row0, int t0, int T, int R,
    int lane, float (&arr)[kDepth][kPer], float (&tm)[kDepth],
    float (&mt)[kDepth][kPer]) {
#pragma unroll
  for (int d = 0; d < kDepth; ++d) {
    const int t = t0 + d;
    const bool in_t = t < T;
    tm[d] = in_t ? __ldg(t_mask + row0 + t) : 0.f;
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int n = lane + 32 * p;
      const size_t at = (row0 + t) * R + n;
      const bool ok = in_t && n < R;
      arr[d][p] = ok ? __ldg(arrivals + at) : 0.f;
      if (kTv) mt[d][p] = ok ? __ldg(mask_t + at) : 0.f;
    }
  }
}

template <int kPer, bool kTv>
__global__ void __launch_bounds__(32 * kWarpsPerBlock) noc_step_kernel(
    const float* __restrict__ arrivals, const float* __restrict__ t_mask,
    const float* __restrict__ mask, const float* __restrict__ mask_t,
    const int* __restrict__ next_hop, const int* __restrict__ in_src,
    const float* __restrict__ drain, const float* __restrict__ buf,
    float* __restrict__ resid_out, float* __restrict__ occ_out,
    float* __restrict__ drained_out, int B, int T, int R, float link_rate) {
  __shared__ float sh_send[kWarpsPerBlock][kMaxNodes];
  __shared__ float sh_scale[kWarpsPerBlock][kMaxNodes];
  __shared__ float sh_moved[kWarpsPerBlock][kMaxNodes];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + warp;
  if (b >= B) return;                 // whole warps only: no block barrier
  float* s_send = sh_send[warp];
  float* s_scale = sh_scale[warp];
  float* s_moved = sh_moved[warp];

  float occ[kPer], resid[kPer], drained[kPer], dr[kPer], bf[kPer], ms[kPer],
      is_router[kPer];
  int nh[kPer], src[kPer][kMaxInDegree];
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int n = lane + 32 * p;
    const bool live = n < R;
    const size_t at = static_cast<size_t>(b) * R + n;
    occ[p] = resid[p] = drained[p] = 0.f;
    dr[p] = live ? drain[at] : 0.f;
    bf[p] = live ? buf[at] : 0.f;
    ms[p] = live ? mask[at] : 0.f;
    nh[p] = live ? next_hop[at] : -1;
    is_router[p] = nh[p] >= 0 ? 1.f : 0.f;
#pragma unroll
    for (int k = 0; k < kMaxInDegree; ++k)
      src[p][k] = live ? in_src[at * kMaxInDegree + k] : -1;
  }

  const size_t row0 = static_cast<size_t>(b) * T;
  float arr[kDepth][kPer], arr_next[kDepth][kPer];
  float tm[kDepth], tm_next[kDepth];
  float mt[kDepth][kPer], mt_next[kDepth][kPer];
  load_cycles<kPer, kTv>(arrivals, t_mask, mask_t, row0, 0, T, R, lane, arr,
                         tm, mt);
  for (int t0 = 0; t0 < T; t0 += kDepth) {
    load_cycles<kPer, kTv>(arrivals, t_mask, mask_t, row0, t0 + kDepth, T, R,
                           lane, arr_next, tm_next, mt_next);
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      if (t0 + d < T) {          // warp-uniform
        float m[kPer], occ1[kPer], send[kPer], moved[kPer];
#pragma unroll
        for (int p = 0; p < kPer; ++p) {
          m[p] = kTv ? mt[d][p] : ms[p];
          occ1[p] = (occ[p] + arr[d][p]) * m[p];
          send[p] = fminf(occ1[p], link_rate) * is_router[p];
          if (lane + 32 * p < R) s_send[lane + 32 * p] = send[p];
        }
        __syncwarp();
        // inflow_want = send @ next_mat; scale_dst per destination.
#pragma unroll
        for (int p = 0; p < kPer; ++p) {
          float want = 0.f;
#pragma unroll
          for (int k = 0; k < kMaxInDegree; ++k)
            if (src[p][k] >= 0) want += s_send[src[p][k]];
          const float space = fmaxf(bf[p] - occ1[p], 0.f);
          const float scale =
              want > 0.f ? fminf(1.f, space / fmaxf(want, 1e-9f)) : 0.f;
          if (lane + 32 * p < R) s_scale[lane + 32 * p] = scale;
        }
        __syncwarp();
        // scale_src = next_mat @ scale_dst: a gather at the next hop.
#pragma unroll
        for (int p = 0; p < kPer; ++p) {
          const float scale_src = nh[p] >= 0 ? s_scale[nh[p]] : 0.f;
          moved[p] = send[p] * scale_src;
          if (lane + 32 * p < R) s_moved[lane + 32 * p] = moved[p];
        }
        __syncwarp();
        // inflow = moved @ next_mat; land, drain, t_mask freeze.
#pragma unroll
        for (int p = 0; p < kPer; ++p) {
          float inflow = 0.f;
#pragma unroll
          for (int k = 0; k < kMaxInDegree; ++k)
            if (src[p][k] >= 0) inflow += s_moved[src[p][k]];
          float o = occ1[p] - moved[p] + inflow * m[p];
          const float sunk = fminf(o, dr[p]);
          o = o - sunk;
          occ[p] = tm[d] * o + (1.f - tm[d]) * occ[p];
          resid[p] = resid[p] + tm[d] * o;
          drained[p] = drained[p] + tm[d] * sunk;
        }
      }
    }
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      tm[d] = tm_next[d];
#pragma unroll
      for (int p = 0; p < kPer; ++p) {
        arr[d][p] = arr_next[d][p];
        if (kTv) mt[d][p] = mt_next[d][p];
      }
    }
  }

#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int n = lane + 32 * p;
    if (n < R) {
      const size_t at = static_cast<size_t>(b) * R + n;
      resid_out[at] = resid[p];
      occ_out[at] = occ[p];
      drained_out[at] = drained[p];
    }
  }
}

template <int kPer, bool kTv>
cudaError_t launch(const float* arrivals, const float* t_mask,
                   const float* mask, const float* mask_t,
                   const int* next_hop, const int* in_src, const float* drain,
                   const float* buf, float* resid, float* occ, float* drained,
                   int B, int T, int R, float link_rate, cudaStream_t stream) {
  const dim3 grid((B + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(32 * kWarpsPerBlock);
  noc_step_kernel<kPer, kTv><<<grid, block, 0, stream>>>(
      arrivals, t_mask, mask, mask_t, next_hop, in_src, drain, buf, resid,
      occ, drained, B, T, R, link_rate);
  return cudaGetLastError();
}

}  // namespace

// arrivals [B, T, R], t_mask [B, T], mask [B, R], mask_t [B, T, R] or null
// (the static mask ANDed in), next_hop [B, R], in_src [B, R, max_in], drain
// and buf [B, R] -> resid, occ, drained [B, R]. Returns a cudaError_t.
extern "C" int noc_step_launch(
    const float* arrivals, const float* t_mask, const float* mask,
    const float* mask_t, const int* next_hop, const int* in_src,
    const float* drain, const float* buf, float* resid, float* occ,
    float* drained, int B, int T, int R, int max_in, float link_rate,
    void* stream) {
  if (B < 1 || T < 0 || R < 1 || R > kMaxNodes || max_in != kMaxInDegree)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NOC_STEP_ARGS                                                       \
  arrivals, t_mask, mask, mask_t, next_hop, in_src, drain, buf, resid, occ, \
      drained, B, T, R, link_rate, s
  const bool tv = mask_t != nullptr;
  const int per = (R + 31) / 32;
  cudaError_t err;
  switch (per * 2 + (tv ? 1 : 0)) {
    case 2: err = launch<1, false>(NOC_STEP_ARGS); break;
    case 3: err = launch<1, true>(NOC_STEP_ARGS); break;
    case 4: err = launch<2, false>(NOC_STEP_ARGS); break;
    case 5: err = launch<2, true>(NOC_STEP_ARGS); break;
    case 6: err = launch<3, false>(NOC_STEP_ARGS); break;
    case 7: err = launch<3, true>(NOC_STEP_ARGS); break;
    case 8: err = launch<4, false>(NOC_STEP_ARGS); break;
    default: err = launch<4, true>(NOC_STEP_ARGS); break;
  }
#undef NOC_STEP_ARGS
  return static_cast<int>(err);
}
