// Fused RESIPI / RESIPI_ALL interval loop for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel `_epoch_kernel` in
// src/repro/kernels/epoch_step/kernel.py: T reconfiguration intervals of the
// Level-1 simulator (the reference's simulator.make_step for RESIPI /
// RESIPI_ALL, unpadded topology) in one launch — M/D/1 latencies, optional
// destination resolution (recv = ext @ dest and the fan-in factor phi),
// PCM-mode power with 10^(dB/10) laser scaling, the Eq. 5-7 gateway
// controller (packets rescaled under faults), the Eq. 4 kappa chain in
// closed form -> PCMC switch count x reconfiguration nJ, and the t_mask
// freeze of the carry — for B independent lanes (traces x sweep points).
//
// What bounds it: the T loop is sequential inside a lane, and each interval
// is a chain of dependent divisions, shuffles and reductions over C = 4
// chiplets, so one lane is latency-bound. The card is filled by lanes, not
// by chiplets: the TPU kernel laid the chiplet vector across 128 lanes
// (C = 4 of them real); here one WARP runs one lane, thread j owns chiplets
// j, j+32, ... and keeps their g in registers for all T intervals, so the
// only memory traffic is the trace read once and the records written once.
// A DSE grid of tens of thousands of lanes gives every SM many resident
// warps whose dependent chains interleave. Cross-chiplet sums are xor
// shuffles (bitwise identical on every thread); the kappa chain's upstream
// counts are an exclusive warp scan over per-chiplet lit totals (chain is
// chiplet-major, memory gateways last with constant kappas that never
// switch). The destination terms stage the ext row and the destination leg
// in shared memory per warp and read dest rows from global memory (they
// stay L2-resident: one [C, C] matrix per trace).
//
// Numerics: build with --fmad=false. The controller thresholds (load > l_m),
// the kappa switch test and the saturation test are discrete, and every
// float feeding them is computed op for op as the plain PyTorch version
// computes it (recv sums sources in index order), so g and saturated match
// it exactly; latencies and powers differ only by reduction order.
//
// The launch runs on the caller's stream, never synchronizes and allocates
// nothing: the wrapper (ops.py) allocates the outputs. `scal` holds the six
// per-interval scalars (latency, power, laser, reconfiguration nJ, mean
// inter-chiplet latency, saturated) and, only with fault frames, a seventh
// column of failed slots: the kernel writes no byte the records do not use.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kMaxChipletsPerThread = 4;   // C <= 128
constexpr unsigned kFull = 0xffffffffu;

struct Consts {
  float interval, burstiness, rpc, flight, feed_links, flits, packet_bits,
      ser_k, mesh_hops, mesh_feed, laser_mw, tia_mw, tuning_mw, driver_mw,
      controller_mw, reconfig_nj;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ int warp_sum_int(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Inclusive prefix sum over the warp's lanes (integers: exact).
__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int u = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// noc.NocModel._md1_wait; inv_bsat = 1 / buffer_sat (the plain version
// multiplies by the reciprocal too).
__device__ __forceinline__ float md1(float rho, float service, float inv_bsat,
                                     const Consts& k) {
  const float rho_eff = clampf(rho * inv_bsat, 0.0f, 0.995f);
  return k.burstiness * rho_eff * service / (2.0f * (1.0f - rho_eff));
}

// noc.NocModel.access_latency (burst_scale = 1 when absent: the plain
// version skips the multiply, and x * 1.0f == x exactly).
__device__ __forceinline__ float access_lat(float hops, float load,
                                            float burst_scale,
                                            float inv_bsat,
                                            const Consts& k) {
  const float walk = hops * k.rpc;
  const float fpc = load * k.flits;
  const float rho_link = clampf(fpc / k.feed_links, 0.0f, 1.0f);
  const float wait = md1(rho_link, k.flits, inv_bsat, k) * burst_scale;
  return walk + wait;
}

// noc.NocModel.gateway_latency with the lane's effective service time.
__device__ __forceinline__ float gateway_lat(float load, float s_eff,
                                             float inv_bsat,
                                             const Consts& k) {
  const float rho = clampf(load * s_eff, 0.0f, 1.0f);
  return s_eff + md1(rho, s_eff, inv_bsat, k) + k.flight;
}

template <bool kDest, bool kFaulted, bool kController>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
epoch_step_kernel(const float* __restrict__ ext,       // [N, T, C]
                  const float* __restrict__ intra,     // [N, T, C]
                  const float* __restrict__ mem,       // [N, T]
                  const float* __restrict__ t_mask,    // [N, T]
                  const float* __restrict__ drift,     // [N, T] or null
                  const int* __restrict__ lane_trace,  // [B]
                  const float* __restrict__ params,    // [B, 5]
                  const float* __restrict__ g0,        // [B, C]
                  const float* __restrict__ src_hops,  // [G]
                  const float* __restrict__ gw_loss_db,  // [G]
                  const float* __restrict__ dest,      // [N, C, C] or null
                  const float* __restrict__ gw_ok,     // [N, T, C, G] or null
                  const float* __restrict__ stuck_on,  // [N, T, C, G] or null
                  float* __restrict__ scal,            // [B, T, 6 or 7]
                  float* __restrict__ g_eff_out,       // [B, T, C]
                  float* __restrict__ g_des_out,       // [B, T, C] or null
                  float* __restrict__ gw_load_out,     // [B, T, C]
                  float* __restrict__ g_final,         // [B, C]
                  int B, int T, int C, int G, int M, Consts k) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + warp;
  if (b >= B) return;  // warp-uniform: whole warps leave together
  float* s_ext = smem + warp * 2 * C;
  float* s_leg = s_ext + C;

  const long n = lane_trace[b];
  const float lm = params[b * 5 + 0];
  const float maxg = params[b * 5 + 1];
  const float ming = params[b * 5 + 2];
  const float bsat = params[b * 5 + 3];
  const float lam = params[b * 5 + 4];
  const float inv_bsat = 1.0f / bsat;
  const float s_eff = fmaxf(k.packet_bits / (lam * k.ser_k), k.flits);
  const float cf = static_cast<float>(C);
  const float mf = static_cast<float>(M);
  const float gf = static_cast<float>(G);

  float g[kMaxChipletsPerThread];
#pragma unroll
  for (int q = 0; q < kMaxChipletsPerThread; ++q) {
    const int c = lane + 32 * q;
    g[q] = c < C ? g0[static_cast<long>(b) * C + c] : 0.0f;
  }

  for (int t = 0; t < T; ++t) {
    const long nt = n * T + t;
    const long bt = static_cast<long>(b) * T + t;
    const float tm = t_mask[nt];
    const float mem_t = mem[nt];

    float e[kMaxChipletsPerThread], ge[kMaxChipletsPerThread];
    float gwl[kMaxChipletsPerThread], src[kMaxChipletsPerThread];
    float inter[kMaxChipletsPerThread];
    int lit_old[kMaxChipletsPerThread];
    float p_src = 0.0f, p_db = 0.0f, p_ext = 0.0f, p_int = 0.0f;
    float p_intra_w = 0.0f;
    int p_failed = 0;

    // --- slot masks, effective capacity, per-chiplet latency inputs -----
#pragma unroll
    for (int q = 0; q < kMaxChipletsPerThread; ++q) {
      const int c = lane + 32 * q;
      e[q] = 0.0f; ge[q] = 0.0f; gwl[q] = 0.0f; src[q] = 0.0f;
      inter[q] = 0.0f; lit_old[q] = 0;
      if (c >= C) continue;
      const long ntc = nt * C + c;
      e[q] = ext[ntc];
      const float in = intra[ntc];
      if (kFaulted) {
        float usable = 0.0f;
        int lit = 0;
        for (int s = 0; s < G; ++s) {
          const float ok = gw_ok[ntc * G + s];
          const float st = stuck_on[ntc * G + s];
          const float des = static_cast<float>(s) < g[q] ? 1.0f : 0.0f;
          const float u = des * ok;
          usable = usable + u;
          lit += fmaxf(u, st * ok) > 0.5f;
          p_failed += (des > 0.0f) && (ok < 0.5f);
        }
        ge[q] = truncf(usable);   // the plain version's int32 cast
        lit_old[q] = lit;
      } else {
        ge[q] = g[q];
        lit_old[q] = static_cast<int>(fminf(fmaxf(g[q], 0.0f), gf));
      }
      gwl[q] = e[q] / fmaxf(ge[q], 1.0f);
      const int lev = min(static_cast<int>(fmaxf(ge[q], 1.0f)), G) - 1;
      src[q] = src_hops[lev];
      p_src += src[q];
      p_db += gw_loss_db[lev];
      p_ext += e[q];
      p_int += in;
      // intra-mesh latency (noc.NocModel.mesh_latency), weighted by load
      const float link = in * k.flits / k.mesh_feed;
      const float intra_lat = k.mesh_hops * k.rpc + k.flits
          + md1(clampf(link, 0.0f, 1.0f), k.flits, inv_bsat, k);
      p_intra_w += intra_lat * in;
      if (kDest) s_ext[c] = e[q];
    }
    const float mean_src = warp_sum(p_src) / cf;
    float access_db = warp_sum(p_db) / cf;
    if (kFaulted) access_db = access_db + drift[nt];

    // --- inter-chiplet latency --------------------------------------------
    float recv[kMaxChipletsPerThread];
    if (kDest) {
      __syncwarp();
      const float* d = dest + n * C * C;
#pragma unroll
      for (int q = 0; q < kMaxChipletsPerThread; ++q) {
        const int j = lane + 32 * q;
        recv[q] = 0.0f;
        if (j >= C) continue;
        float r = 0.0f, sq = 0.0f;
        for (int i = 0; i < C; ++i) {
          const float w = s_ext[i] * d[i * C + j];
          if (i == 0) { r = w; sq = w * w; }
          else { r = r + w; sq = sq + w * w; }
        }
        recv[q] = r;
        const float phi = sq / fmaxf(r * r, 1e-12f);
        const float bs = (1.0f + (k.burstiness - 1.0f) * phi)
            * (1.0f / k.burstiness);
        const float dst_gw = r / fmaxf(ge[q], 1.0f);
        s_leg[j] = access_lat(src[q], dst_gw, bs, inv_bsat, k);
      }
      __syncwarp();
#pragma unroll
      for (int q = 0; q < kMaxChipletsPerThread; ++q) {
        const int i = lane + 32 * q;
        if (i >= C) continue;
        float acc = 0.0f;
        for (int j = 0; j < C; ++j) acc = acc + d[i * C + j] * s_leg[j];
        inter[q] = access_lat(src[q], gwl[q], 1.0f, inv_bsat, k)
            + gateway_lat(gwl[q], s_eff, inv_bsat, k) + acc;
      }
      __syncwarp();  // s_ext / s_leg are rewritten next interval
    } else {
#pragma unroll
      for (int q = 0; q < kMaxChipletsPerThread; ++q) {
        recv[q] = 0.0f;
        if (lane + 32 * q >= C) continue;
        inter[q] = access_lat(src[q], gwl[q], 1.0f, inv_bsat, k)
            + gateway_lat(gwl[q], s_eff, inv_bsat, k)
            + access_lat(mean_src, gwl[q], 1.0f, inv_bsat, k);
      }
    }

    float p_inter_w = 0.0f;
    bool p_sat = false;
#pragma unroll
    for (int q = 0; q < kMaxChipletsPerThread; ++q) {
      if (lane + 32 * q >= C) continue;
      p_inter_w += inter[q] * e[q];
      p_sat = p_sat || (gwl[q] * s_eff > bsat);
    }
    const float inter_w = warp_sum(p_inter_w);
    const float tot_ext = warp_sum(p_ext) + 1e-9f;
    const float tot_int = warp_sum(p_int) + 1e-9f;
    const float intra_w = warp_sum(p_intra_w);
    const float tot_mem = mem_t + 1e-9f;
    const float mem_gw = mem_t / mf;
    const float mem_lat = access_lat(mean_src, mem_gw, 1.0f, inv_bsat, k)
        + gateway_lat(mem_gw, s_eff, inv_bsat, k)
        + access_lat(1.0f, mem_gw, 1.0f, inv_bsat, k);
    const float lat = (inter_w + intra_w + mem_lat * tot_mem)
        / (tot_ext + tot_int + tot_mem);
    const float minter = inter_w / tot_ext;
    const bool sat = __any_sync(kFull, p_sat) && tm > 0.0f;

    // --- power ("pcm" mode) -----------------------------------------------
    int p_lit = 0;
#pragma unroll
    for (int q = 0; q < kMaxChipletsPerThread; ++q) p_lit += lit_old[q];
    const int n_lit_old = warp_sum_int(p_lit);
    const float lit_w = static_cast<float>(n_lit_old + M) * lam;
    const float laser = lit_w * k.laser_mw * powf(10.0f, access_db * 0.1f);
    const float tia = lit_w * k.tia_mw;
    const float tuning = (lit_w + lit_w) * k.tuning_mw;
    const float driver = lit_w * k.driver_mw;
    const float total = laser + tia + tuning + driver + k.controller_mw;

    // --- controller + reconfiguration energy ------------------------------
    float g_new[kMaxChipletsPerThread];
    float reconf = 0.0f;
    if (kController) {
      int lit_new[kMaxChipletsPerThread];
#pragma unroll
      for (int q = 0; q < kMaxChipletsPerThread; ++q) {
        const int c = lane + 32 * q;
        g_new[q] = g[q];
        lit_new[q] = 0;
        if (c >= C) continue;
        const float pressure = kDest ? fmaxf(e[q], recv[q]) : e[q];
        float packets = pressure * k.interval;
        if (kFaulted) packets = packets * (g[q] / fmaxf(ge[q], 1.0f));
        const float g1 = fmaxf(g[q], 1.0f);
        const float load = packets / (k.interval * g1);
        const bool inc = (load > lm) && (g[q] < maxg);
        const bool dec = (load < lm * (1.0f - 1.0f / g1)) && (g[q] > ming);
        g_new[q] = inc ? g[q] + 1.0f : (dec ? g[q] - 1.0f : g[q]);
        if (kFaulted) {
          const long ntc = nt * C + c;
          int lit = 0;
          for (int s = 0; s < G; ++s) {
            const float ok = gw_ok[ntc * G + s];
            const float st = stuck_on[ntc * G + s];
            const float des = static_cast<float>(s) < g_new[q] ? 1.0f : 0.0f;
            lit += fmaxf(des * ok, st * ok) > 0.5f;
          }
          lit_new[q] = lit;
        } else {
          lit_new[q] = static_cast<int>(fminf(fmaxf(g_new[q], 0.0f), gf));
        }
      }
      // Chain prefix: chiplet-major order, so chiplet c's upstream count is
      // the exclusive prefix over chiplets < c, walked chunk by chunk of 32.
      const int gt_old = n_lit_old + M;
      int p_new = 0;
#pragma unroll
      for (int q = 0; q < kMaxChipletsPerThread; ++q) p_new += lit_new[q];
      const int gt_new = warp_sum_int(p_new) + M;
      int base_old = 0, base_new = 0, p_switched = 0;
#pragma unroll
      for (int q = 0; q < kMaxChipletsPerThread; ++q) {
        if (32 * q >= C) break;
        const int c = lane + 32 * q;
        const int inc_old = warp_inclusive_scan(lit_old[q], lane);
        const int inc_new = warp_inclusive_scan(lit_new[q], lane);
        int up_old = base_old + inc_old - lit_old[q];
        int up_new = base_new + inc_new - lit_new[q];
        base_old += __shfl_sync(kFull, inc_old, 31);
        base_new += __shfl_sync(kFull, inc_new, 31);
        if (c >= C) continue;
        const long ntc = nt * C + c;
        for (int s = 0; s < G; ++s) {
          bool on_old, on_new;
          if (kFaulted) {
            const float ok = gw_ok[ntc * G + s];
            const float st = stuck_on[ntc * G + s];
            const float d_old = static_cast<float>(s) < g[q] ? 1.0f : 0.0f;
            const float d_new = static_cast<float>(s) < g_new[q] ? 1.0f : 0.0f;
            on_old = fmaxf(d_old * ok, st * ok) > 0.5f;
            on_new = fmaxf(d_new * ok, st * ok) > 0.5f;
          } else {
            on_old = static_cast<float>(s) < g[q];
            on_new = static_cast<float>(s) < g_new[q];
          }
          const float k_old = on_old
              ? 1.0f / fmaxf(static_cast<float>(gt_old - up_old), 1.0f) : 0.0f;
          const float k_new = on_new
              ? 1.0f / fmaxf(static_cast<float>(gt_new - up_new), 1.0f) : 0.0f;
          p_switched += fabsf(k_new - k_old) > 1e-6f;
          up_old += on_old;
          up_new += on_new;
        }
      }
      reconf = static_cast<float>(warp_sum_int(p_switched)) * k.reconfig_nj;
    } else {
#pragma unroll
      for (int q = 0; q < kMaxChipletsPerThread; ++q) g_new[q] = g[q];
    }
    const float failed = kFaulted
        ? static_cast<float>(warp_sum_int(p_failed)) : 0.0f;

    // --- records (t_valid-masked like the plain version) ------------------
    constexpr int kCols = kFaulted ? 7 : 6;
    if (lane < kCols) {
      float v = 0.0f;
      switch (lane) {
        case 0: v = lat * tm; break;
        case 1: v = total * tm; break;
        case 2: v = laser * tm; break;
        case 3: v = reconf * tm; break;
        case 4: v = minter * tm; break;
        case 5: v = (sat ? 1.0f : 0.0f) * tm; break;
        case 6: v = failed * tm; break;
        default: break;
      }
      scal[bt * kCols + lane] = v;
    }
#pragma unroll
    for (int q = 0; q < kMaxChipletsPerThread; ++q) {
      const int c = lane + 32 * q;
      if (c >= C) continue;
      const long btc = bt * C + c;
      g_eff_out[btc] = ge[q] * tm;
      if (kFaulted) g_des_out[btc] = g[q] * tm;
      gw_load_out[btc] = gwl[q] * tm;
      // Masked intervals freeze the controller carry.
      g[q] = tm > 0.0f ? g_new[q] : g[q];
    }
  }
#pragma unroll
  for (int q = 0; q < kMaxChipletsPerThread; ++q) {
    const int c = lane + 32 * q;
    if (c < C) g_final[static_cast<long>(b) * C + c] = g[q];
  }
}

template <bool kDest, bool kFaulted, bool kController>
cudaError_t launch(const float* ext, const float* intra, const float* mem,
                   const float* t_mask, const float* drift,
                   const int* lane_trace, const float* params,
                   const float* g0, const float* src_hops,
                   const float* gw_loss_db, const float* dest,
                   const float* gw_ok, const float* stuck_on, float* scal,
                   float* g_eff, float* g_des, float* gw_load,
                   float* g_final, int B, int T, int C, int G, int M,
                   const Consts& k, cudaStream_t stream) {
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((B + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const size_t shmem = sizeof(float) * 2 * C * kWarpsPerBlock;
  epoch_step_kernel<kDest, kFaulted, kController>
      <<<grid, block, shmem, stream>>>(
          ext, intra, mem, t_mask, drift, lane_trace, params, g0, src_hops,
          gw_loss_db, dest, gw_ok, stuck_on, scal, g_eff, g_des, gw_load,
          g_final, B, T, C, G, M, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" int epoch_step_launch(
    const float* ext, const float* intra, const float* mem,
    const float* t_mask, const float* drift, const int* lane_trace,
    const float* params, const float* g0, const float* src_hops,
    const float* gw_loss_db, const float* dest, const float* gw_ok,
    const float* stuck_on, float* scal, float* g_eff, float* g_des,
    float* gw_load, float* g_final, int B, int T, int C, int G, int M,
    int use_dest, int faulted, int use_controller, float interval,
    float burstiness, float rpc, float flight, float feed_links, float flits,
    float packet_bits, float ser_k, float mesh_hops, float mesh_feed,
    float laser_mw, float tia_mw, float tuning_mw, float driver_mw,
    float controller_mw, float reconfig_nj, void* stream) {
  if (B < 1 || T < 1 || C < 1 || C > 32 * kMaxChipletsPerThread || G < 1 ||
      M < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Consts k{interval, burstiness, rpc, flight, feed_links, flits,
                 packet_bits, ser_k, mesh_hops, mesh_feed, laser_mw, tia_mw,
                 tuning_mw, driver_mw, controller_mw, reconfig_nj};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define EPOCH_STEP_ARGS                                                     \
  ext, intra, mem, t_mask, drift, lane_trace, params, g0, src_hops,         \
      gw_loss_db, dest, gw_ok, stuck_on, scal, g_eff, g_des, gw_load,       \
      g_final, B, T, C, G, M, k, s
  cudaError_t err;
  const int variant = (use_dest ? 4 : 0) | (faulted ? 2 : 0)
      | (use_controller ? 1 : 0);
  switch (variant) {
    case 0: err = launch<false, false, false>(EPOCH_STEP_ARGS); break;
    case 1: err = launch<false, false, true>(EPOCH_STEP_ARGS); break;
    case 2: err = launch<false, true, false>(EPOCH_STEP_ARGS); break;
    case 3: err = launch<false, true, true>(EPOCH_STEP_ARGS); break;
    case 4: err = launch<true, false, false>(EPOCH_STEP_ARGS); break;
    case 5: err = launch<true, false, true>(EPOCH_STEP_ARGS); break;
    case 6: err = launch<true, true, false>(EPOCH_STEP_ARGS); break;
    default: err = launch<true, true, true>(EPOCH_STEP_ARGS); break;
  }
#undef EPOCH_STEP_ARGS
  return static_cast<int>(err);
}
