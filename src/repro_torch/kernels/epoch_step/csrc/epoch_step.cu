// Fused RESIPI / RESIPI_ALL interval loop for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel `_epoch_kernel` in
// src/repro/kernels/epoch_step/kernel.py: T reconfiguration intervals of the
// Level-1 simulator (the reference's simulator.make_step for RESIPI /
// RESIPI_ALL, unpadded topology) in one call — M/D/1 latencies, optional
// destination resolution (recv = ext @ dest and the fan-in factor phi),
// PCM-mode power with 10^(dB/10) laser scaling, the Eq. 5-7 gateway
// controller (packets rescaled under faults), the Eq. 4 kappa chain in
// closed form -> PCMC switch count x reconfiguration nJ, and the t_mask
// freeze of the carry — for B independent lanes (traces x sweep points).
//
// Two designs live here; the wrapper (ops.variant) picks one from C.
//
// "split" (C <= 16, the main path). Nothing the interval metrics compute
// feeds back into the controller: its only carried state is g [C], and the
// update reads the trace's ext row, recv = ext @ dest (trace-only), g, the
// effective g under faults and the lane's l_m / gateway clamps, and each
// chiplet's g moves on its own chiplet's values alone. So the loop splits in
// two launches:
//   1. epoch_recurrence_kernel, one THREAD per (lane, chiplet), g in a
//      register: only the controller's arithmetic, op for op as the plain
//      version, with the trace rows prefetched kRecDepth intervals ahead so
//      no load sits on the dependent chain. It writes g after each interval
//      (float, the value the chain holds) into a [B, T, C] scratch the
//      wrapper allocates, and the final g. After a masked interval the
//      scratch holds the frozen carry, not the controller's output; the
//      metrics of a masked interval are all multiplied by 0, so they never
//      need it.
//   2. epoch_metrics_kernel, one thread per (lane, interval), interval
//      fastest: everything else, which is > 95% of the arithmetic and
//      independent across (lane, interval). Sums over chiplets run in
//      index order in one thread (no shuffles). The Eq. 4 kappas
//      1 / max(gt - up, 1) take integer arguments up to C*G + M, so a
//      table of 1.0f / n filled by the block with the same IEEE division
//      replaces two divisions per gateway slot. Records are staged in
//      shared memory and written as one contiguous run per block: item
//      (b, t) owns row b*T + t of every [B, T, k] output.
// The recurrence is ~20 dependent operations (two IEEE divisions among
// them) per interval per chain; the metrics are bounded by issue rate (tens
// of divisions and a powf per item) and by the records' bytes.
//
// "warp" (C <= 128, the first design, kept for C > 16 and as the yardstick
// the split is timed against): one WARP runs one lane for all T intervals,
// thread j owns chiplets j, j+32, ... and keeps their g in registers.
// Cross-chiplet sums are xor shuffles; the kappa chain's upstream counts
// are an exclusive warp scan over per-chiplet lit totals (chain is
// chiplet-major, memory gateways last with constant kappas that never
// switch); the destination terms go through shared memory per warp. One
// lane is a chain of dependent divisions, shuffles and reductions, so it
// is latency-bound: at C = 4, 28 of the 32 threads idle.
//
// Numerics: build with --fmad=false. The controller thresholds (load > l_m),
// the kappa switch test and the saturation test are discrete, and every
// float feeding them is computed op for op as the plain PyTorch version
// computes it (recv sums sources in index order), so g and saturated match
// it exactly in both designs; latencies and powers differ only by
// reduction order.
//
// Every launch runs on the caller's stream, never synchronizes and
// allocates nothing: the wrapper (ops.py) allocates the outputs and the
// split's scratch. `scal` holds the six per-interval scalars (latency,
// power, laser, reconfiguration nJ, mean inter-chiplet latency, saturated)
// and, only with fault frames, a seventh column of failed slots: the
// kernels write no byte the records do not use.

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

// --- "split": the controller recurrence, one thread per (lane, chiplet) ---

constexpr int kSplitBlock = 128;     // threads of both split kernels' blocks
constexpr int kRecDepth = 4;         // intervals of trace rows in flight
constexpr int kMaxSplitChiplets = 16;

// Each chiplet's controller is its own: g[c] moves on chiplet c's pressure
// (its ext, or the larger of ext and recv[c] = sum_i ext[i] dest[i][c]) and
// its own effective g. So one thread runs one (lane, chiplet) chain.
template <int kC, bool kDest, bool kFaulted>
__global__ void __launch_bounds__(kSplitBlock)
epoch_recurrence_kernel(const float* __restrict__ ext,       // [N, T, C]
                        const float* __restrict__ t_mask,    // [N, T]
                        const int* __restrict__ lane_trace,  // [B]
                        const float* __restrict__ params,    // [B, 5]
                        const float* __restrict__ g0,        // [B, C]
                        const float* __restrict__ dest,      // [N, C, C]
                        const float* __restrict__ gw_ok,     // [N, T, C, G]
                        float* __restrict__ g_step,          // [B, T, C]
                        float* __restrict__ g_final,         // [B, C]
                        int B, int T, int C, int G, float interval) {
  const long item = static_cast<long>(blockIdx.x) * kSplitBlock + threadIdx.x;
  if (item >= static_cast<long>(B) * C) return;
  const int b = static_cast<int>(item / C);
  const int c = static_cast<int>(item - static_cast<long>(b) * C);
  const long n = lane_trace[b];
  const float lm = params[b * 5 + 0];
  const float maxg = params[b * 5 + 1];
  const float ming = params[b * 5 + 2];
  // Destination column c: recv[c] sums ext[i] * dest[i][c] over sources i.
  constexpr int kRow = kDest ? kC : 1;
  float dcol[kRow];
#pragma unroll
  for (int i = 0; i < kRow; ++i)
    dcol[i] = kDest && i < C ? dest[(n * C + i) * C + c] : 0.0f;
  float g = g0[item];

  // Ring of trace rows: slot j holds interval t0 + j, reloaded with
  // interval t0 + j + kRecDepth as soon as it is read. Without destination
  // matrices only chiplet c's own ext is read.
  float e_ring[kRecDepth][kRow], tm_ring[kRecDepth];
#pragma unroll
  for (int j = 0; j < kRecDepth; ++j) {
    const bool in_t = j < T;
    const long nt = n * T + j;
    tm_ring[j] = in_t ? __ldg(t_mask + nt) : 0.0f;
#pragma unroll
    for (int i = 0; i < kRow; ++i)
      e_ring[j][i] = in_t && (kDest ? i < C : true)
          ? __ldg(ext + nt * C + (kDest ? i : c)) : 0.0f;
  }
  for (int t0 = 0; t0 < T; t0 += kRecDepth) {
#pragma unroll
    for (int j = 0; j < kRecDepth; ++j) {
      const int t = t0 + j;
      if (t >= T) break;
      float e[kRow];
#pragma unroll
      for (int i = 0; i < kRow; ++i) e[i] = e_ring[j][i];
      const float tm = tm_ring[j];
      const long nn = n * T + t + kRecDepth;
      const bool in_t = t + kRecDepth < T;
      tm_ring[j] = in_t ? __ldg(t_mask + nn) : 0.0f;
#pragma unroll
      for (int i = 0; i < kRow; ++i)
        e_ring[j][i] = in_t && (kDest ? i < C : true)
            ? __ldg(ext + nn * C + (kDest ? i : c)) : 0.0f;

      float pressure = e[0];
      if (kDest) {
        float own = 0.0f, r = 0.0f;
#pragma unroll
        for (int i = 0; i < kC; ++i) {
          if (i >= C) break;
          if (i == c) own = e[i];
          const float w = e[i] * dcol[i];
          r = i == 0 ? w : r + w;
        }
        pressure = fmaxf(own, r);
      }
      float packets = pressure * interval;
      if (kFaulted) {
        const float* ok = gw_ok + ((n * T + t) * C + c) * G;
        float usable = 0.0f;
        for (int s = 0; s < G; ++s) {
          const float des = static_cast<float>(s) < g ? 1.0f : 0.0f;
          usable = usable + des * __ldg(ok + s);
        }
        packets = packets * (g / fmaxf(truncf(usable), 1.0f));
      }
      const float g1 = fmaxf(g, 1.0f);
      const float load = packets / (interval * g1);
      const bool inc = (load > lm) && (g < maxg);
      const bool dec = (load < lm * (1.0f - 1.0f / g1)) && (g > ming);
      const float g_new = inc ? g + 1.0f : (dec ? g - 1.0f : g);
      // Masked intervals freeze the controller carry.
      g = tm > 0.0f ? g_new : g;
      g_step[(static_cast<long>(b) * T + t) * C + c] = g;
    }
  }
  g_final[item] = g;
}

// --- "split": the interval metrics, one thread per (lane, interval) -------

// Dynamic shared memory of one metrics block: the kappa table, then the
// staged records.
__host__ __device__ inline int kappa_table_len(int C, int G, int M) {
  return C * G + M + 1;
}

__host__ inline size_t metrics_smem_bytes(int C, int G, int M, bool faulted) {
  const int cols = faulted ? 7 : 6;
  const int per_item = cols + (faulted ? 3 : 2) * C;
  return sizeof(float)
      * (kappa_table_len(C, G, M) + static_cast<size_t>(kSplitBlock) * per_item);
}

template <int kC, bool kDest, bool kFaulted, bool kController>
__global__ void __launch_bounds__(kSplitBlock)
epoch_metrics_kernel(const float* __restrict__ ext,       // [N, T, C]
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
                     const float* __restrict__ gw_ok,     // [N, T, C, G]
                     const float* __restrict__ stuck_on,  // [N, T, C, G]
                     const float* __restrict__ g_step,    // [B, T, C]
                     float* __restrict__ scal,            // [B, T, 6 or 7]
                     float* __restrict__ g_eff_out,       // [B, T, C]
                     float* __restrict__ g_des_out,       // [B, T, C]
                     float* __restrict__ gw_load_out,     // [B, T, C]
                     float* __restrict__ g_final,         // [B, C]
                     int B, int T, int C, int G, int M, Consts k) {
  constexpr int kCols = kFaulted ? 7 : 6;
  extern __shared__ float smem[];
  const int n_kappa = kappa_table_len(C, G, M);
  float* s_inv = smem;
  float* s_scal = s_inv + n_kappa;
  float* s_ge = s_scal + kSplitBlock * kCols;
  float* s_gwl = s_ge + kSplitBlock * C;
  float* s_gdes = s_gwl + kSplitBlock * C;
  // The Eq. 4 kappas: s_inv[x] = 1 / max(x, 1), the plain version's IEEE
  // division of the same integer-valued floats.
  for (int i = threadIdx.x; i < n_kappa; i += kSplitBlock)
    s_inv[i] = 1.0f / fmaxf(static_cast<float>(i), 1.0f);
  __syncthreads();

  const int tid = threadIdx.x;
  const long n_items = static_cast<long>(B) * T;
  const long item0 = static_cast<long>(blockIdx.x) * kSplitBlock;
  const long item = item0 + tid;
  if (item < n_items) {
    const int b = static_cast<int>(item / T);
    const int t = static_cast<int>(item - static_cast<long>(b) * T);
    const long n = lane_trace[b];
    const long nt = n * T + t;
    const float bsat = params[b * 5 + 3];
    const float lam = params[b * 5 + 4];
    const float inv_bsat = 1.0f / bsat;
    const float s_eff = fmaxf(k.packet_bits / (lam * k.ser_k), k.flits);
    const float cf = static_cast<float>(C);
    const float mf = static_cast<float>(M);
    const float gf = static_cast<float>(G);
    const float tm = t_mask[nt];
    const float mem_t = mem[nt];

    // g before and (controller) after this interval, from the recurrence.
    float g[kC], g_new[kC];
#pragma unroll
    for (int q = 0; q < kC; ++q) {
      g[q] = g_new[q] = 0.0f;
      if (q >= C) continue;
      const float base = g0[static_cast<long>(b) * C + q];
      if (kController) {
        const long row = static_cast<long>(b) * T + t;
        g[q] = t == 0 ? base : g_step[(row - 1) * C + q];
        g_new[q] = g_step[row * C + q];
      } else {
        g[q] = g_new[q] = base;
        if (t == 0) g_final[static_cast<long>(b) * C + q] = base;
      }
    }

    // --- slot masks, effective capacity, per-chiplet latency inputs -----
    float e[kC], ge[kC], gwl[kC], src[kC];
    float p_src = 0.0f, p_db = 0.0f, p_ext = 0.0f, p_int = 0.0f;
    float p_intra_w = 0.0f;
    int n_lit_old = 0, p_failed = 0;
#pragma unroll
    for (int q = 0; q < kC; ++q) {
      e[q] = ge[q] = gwl[q] = src[q] = 0.0f;
      if (q >= C) continue;
      const long ntc = nt * C + q;
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
        n_lit_old += lit;
      } else {
        ge[q] = g[q];
        n_lit_old += static_cast<int>(fminf(fmaxf(g[q], 0.0f), gf));
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
    }
    const float mean_src = p_src / cf;
    float access_db = p_db / cf;
    if (kFaulted) access_db = access_db + drift[nt];

    // --- inter-chiplet latency --------------------------------------------
    float inter_w = 0.0f;
    bool any_sat = false;
    if (kDest) {
      const float* d = dest + n * C * C;
      float leg[kC];
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        leg[j] = 0.0f;
        if (j >= C) continue;
        float r = 0.0f, sq = 0.0f;
#pragma unroll
        for (int i = 0; i < kC; ++i) {
          if (i >= C) break;
          const float w = e[i] * d[i * C + j];
          if (i == 0) { r = w; sq = w * w; }
          else { r = r + w; sq = sq + w * w; }
        }
        const float phi = sq / fmaxf(r * r, 1e-12f);
        const float bs = (1.0f + (k.burstiness - 1.0f) * phi)
            * (1.0f / k.burstiness);
        const float dst_gw = r / fmaxf(ge[j], 1.0f);
        leg[j] = access_lat(src[j], dst_gw, bs, inv_bsat, k);
      }
#pragma unroll
      for (int i = 0; i < kC; ++i) {
        if (i >= C) break;
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < kC; ++j) {
          if (j >= C) break;
          acc = acc + d[i * C + j] * leg[j];
        }
        const float inter = access_lat(src[i], gwl[i], 1.0f, inv_bsat, k)
            + gateway_lat(gwl[i], s_eff, inv_bsat, k) + acc;
        inter_w += inter * e[i];
        any_sat = any_sat || (gwl[i] * s_eff > bsat);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kC; ++i) {
        if (i >= C) break;
        const float inter = access_lat(src[i], gwl[i], 1.0f, inv_bsat, k)
            + gateway_lat(gwl[i], s_eff, inv_bsat, k)
            + access_lat(mean_src, gwl[i], 1.0f, inv_bsat, k);
        inter_w += inter * e[i];
        any_sat = any_sat || (gwl[i] * s_eff > bsat);
      }
    }
    const float tot_ext = p_ext + 1e-9f;
    const float tot_int = p_int + 1e-9f;
    const float tot_mem = mem_t + 1e-9f;
    const float mem_gw = mem_t / mf;
    const float mem_lat = access_lat(mean_src, mem_gw, 1.0f, inv_bsat, k)
        + gateway_lat(mem_gw, s_eff, inv_bsat, k)
        + access_lat(1.0f, mem_gw, 1.0f, inv_bsat, k);
    const float lat = (inter_w + p_intra_w + mem_lat * tot_mem)
        / (tot_ext + tot_int + tot_mem);
    const float minter = inter_w / tot_ext;
    const bool sat = any_sat && tm > 0.0f;

    // --- power ("pcm" mode) -----------------------------------------------
    const float lit_w = static_cast<float>(n_lit_old + M) * lam;
    const float laser = lit_w * k.laser_mw * powf(10.0f, access_db * 0.1f);
    const float tia = lit_w * k.tia_mw;
    const float tuning = (lit_w + lit_w) * k.tuning_mw;
    const float driver = lit_w * k.driver_mw;
    const float total = laser + tia + tuning + driver + k.controller_mw;

    // --- reconfiguration energy: the Eq. 4 kappa chain, chiplet-major -----
    float reconf = 0.0f;
    if (kController) {
      int n_lit_new = 0;
#pragma unroll
      for (int q = 0; q < kC; ++q) {
        if (q >= C) break;
        if (kFaulted) {
          const long ntc = nt * C + q;
          for (int s = 0; s < G; ++s) {
            const float ok = gw_ok[ntc * G + s];
            const float st = stuck_on[ntc * G + s];
            const float des = static_cast<float>(s) < g_new[q] ? 1.0f : 0.0f;
            n_lit_new += fmaxf(des * ok, st * ok) > 0.5f;
          }
        } else {
          n_lit_new += static_cast<int>(fminf(fmaxf(g_new[q], 0.0f), gf));
        }
      }
      const int gt_old = n_lit_old + M;
      const int gt_new = n_lit_new + M;
      const int top = n_kappa - 1;
      int up_old = 0, up_new = 0, switched = 0;
#pragma unroll
      for (int q = 0; q < kC; ++q) {
        if (q >= C) break;
        const long ntc = nt * C + q;
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
          const float k_old =
              on_old ? s_inv[min(max(gt_old - up_old, 0), top)] : 0.0f;
          const float k_new =
              on_new ? s_inv[min(max(gt_new - up_new, 0), top)] : 0.0f;
          switched += fabsf(k_new - k_old) > 1e-6f;
          up_old += on_old;
          up_new += on_new;
        }
      }
      reconf = static_cast<float>(switched) * k.reconfig_nj;
    }

    // --- records (t_valid-masked like the plain version), staged ----------
    float* row = s_scal + tid * kCols;
    row[0] = lat * tm;
    row[1] = total * tm;
    row[2] = laser * tm;
    row[3] = reconf * tm;
    row[4] = minter * tm;
    row[5] = (sat ? 1.0f : 0.0f) * tm;
    if (kFaulted) row[6] = static_cast<float>(p_failed) * tm;
#pragma unroll
    for (int q = 0; q < kC; ++q) {
      if (q >= C) break;
      s_ge[tid * C + q] = ge[q] * tm;
      s_gwl[tid * C + q] = gwl[q] * tm;
      if (kFaulted) s_gdes[tid * C + q] = g[q] * tm;
    }
  }
  __syncthreads();
  // Items item0 .. item0 + cnt - 1 own one contiguous run of each output.
  const int cnt = static_cast<int>(min(static_cast<long>(kSplitBlock),
                                       n_items - item0));
  for (int i = tid; i < cnt * kCols; i += kSplitBlock)
    scal[item0 * kCols + i] = s_scal[i];
  for (int i = tid; i < cnt * C; i += kSplitBlock) {
    g_eff_out[item0 * C + i] = s_ge[i];
    gw_load_out[item0 * C + i] = s_gwl[i];
    if (kFaulted) g_des_out[item0 * C + i] = s_gdes[i];
  }
}

template <int kC, bool kDest, bool kFaulted, bool kController>
cudaError_t launch_split(const float* ext, const float* intra,
                         const float* mem, const float* t_mask,
                         const float* drift, const int* lane_trace,
                         const float* params, const float* g0,
                         const float* src_hops, const float* gw_loss_db,
                         const float* dest, const float* gw_ok,
                         const float* stuck_on, float* g_step, float* scal,
                         float* g_eff, float* g_des, float* gw_load,
                         float* g_final, int B, int T, int C, int G, int M,
                         const Consts& k, cudaStream_t stream) {
  if (kController) {
    const long chains = static_cast<long>(B) * C;
    epoch_recurrence_kernel<kC, kDest, kFaulted>
        <<<static_cast<unsigned>((chains + kSplitBlock - 1) / kSplitBlock),
           kSplitBlock, 0, stream>>>(
            ext, t_mask, lane_trace, params, g0, dest, gw_ok, g_step,
            g_final, B, T, C, G, k.interval);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const long items = static_cast<long>(B) * T;
  const size_t shmem = metrics_smem_bytes(C, G, M, kFaulted);
  auto kernel = epoch_metrics_kernel<kC, kDest, kFaulted, kController>;
  if (shmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shmem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<static_cast<unsigned>((items + kSplitBlock - 1) / kSplitBlock),
           kSplitBlock, shmem, stream>>>(
      ext, intra, mem, t_mask, drift, lane_trace, params, g0, src_hops,
      gw_loss_db, dest, gw_ok, stuck_on, g_step, scal, g_eff, g_des,
      gw_load, g_final, B, T, C, G, M, k);
  return cudaGetLastError();
}

}  // namespace

// kernel: 0 = "split" (C <= 16; g_step is the [B, T, C] float scratch,
// used only when use_controller), 1 = "warp" (C <= 128; g_step unused).
extern "C" int epoch_step_launch(
    const float* ext, const float* intra, const float* mem,
    const float* t_mask, const float* drift, const int* lane_trace,
    const float* params, const float* g0, const float* src_hops,
    const float* gw_loss_db, const float* dest, const float* gw_ok,
    const float* stuck_on, float* scal, float* g_eff, float* g_des,
    float* gw_load, float* g_final, float* g_step, int B, int T, int C,
    int G, int M, int use_dest, int faulted, int use_controller, int kernel,
    float interval, float burstiness, float rpc, float flight,
    float feed_links, float flits, float packet_bits, float ser_k,
    float mesh_hops, float mesh_feed, float laser_mw, float tia_mw,
    float tuning_mw, float driver_mw, float controller_mw, float reconfig_nj,
    void* stream) {
  const bool split = kernel == 0;
  if (B < 1 || T < 1 || C < 1 || G < 1 || M < 1 || (kernel != 0 && kernel != 1)
      || C > (split ? kMaxSplitChiplets : 32 * kMaxChipletsPerThread)
      || (split && use_controller && g_step == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Consts k{interval, burstiness, rpc, flight, feed_links, flits,
                 packet_bits, ser_k, mesh_hops, mesh_feed, laser_mw, tia_mw,
                 tuning_mw, driver_mw, controller_mw, reconfig_nj};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int variant = (use_dest ? 4 : 0) | (faulted ? 2 : 0)
      | (use_controller ? 1 : 0);
  cudaError_t err;
  if (split) {
#define EPOCH_SPLIT_ARGS                                                    \
  ext, intra, mem, t_mask, drift, lane_trace, params, g0, src_hops,         \
      gw_loss_db, dest, gw_ok, stuck_on, g_step, scal, g_eff, g_des,        \
      gw_load, g_final, B, T, C, G, M, k, s
#define EPOCH_SPLIT_CASES(KC)                                               \
  switch (variant) {                                                        \
    case 0: err = launch_split<KC, false, false, false>(EPOCH_SPLIT_ARGS); break; \
    case 1: err = launch_split<KC, false, false, true>(EPOCH_SPLIT_ARGS); break;  \
    case 2: err = launch_split<KC, false, true, false>(EPOCH_SPLIT_ARGS); break;  \
    case 3: err = launch_split<KC, false, true, true>(EPOCH_SPLIT_ARGS); break;   \
    case 4: err = launch_split<KC, true, false, false>(EPOCH_SPLIT_ARGS); break;  \
    case 5: err = launch_split<KC, true, false, true>(EPOCH_SPLIT_ARGS); break;   \
    case 6: err = launch_split<KC, true, true, false>(EPOCH_SPLIT_ARGS); break;   \
    default: err = launch_split<KC, true, true, true>(EPOCH_SPLIT_ARGS); break;   \
  }
    if (C <= 4) {
      EPOCH_SPLIT_CASES(4)
    } else {
      EPOCH_SPLIT_CASES(16)
    }
#undef EPOCH_SPLIT_CASES
#undef EPOCH_SPLIT_ARGS
    return static_cast<int>(err);
  }
#define EPOCH_STEP_ARGS                                                     \
  ext, intra, mem, t_mask, drift, lane_trace, params, g0, src_hops,         \
      gw_loss_db, dest, gw_ok, stuck_on, scal, g_eff, g_des, gw_load,       \
      g_final, B, T, C, G, M, k, s
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
