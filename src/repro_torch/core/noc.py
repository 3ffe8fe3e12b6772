"""Intra-chiplet NoC latency model (epoch scale), on tensors.

Port of `repro.core.noc`. Three serial segments per inter-chiplet packet
(§3.4) — source router -> source gateway, gateway -> gateway over the
photonic interposer, destination gateway -> destination router — plus plain
mesh latency for intra-chiplet packets. Queueing terms are M/D/1 waits with
a burstiness multiplier and a finite-buffer saturation knee.

`buffer_sat` may hold a tensor (a per-lane sweep knob shaped to broadcast
against the loads); every other field is a Python number. The arithmetic is
op-for-op the reference's, in float32.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.constants import NETWORK, NetworkConfig


@dataclasses.dataclass(frozen=True)
class NocModel:
    cfg: NetworkConfig = NETWORK
    router_pipeline_cycles: float = 2.0   # per-hop pipelined router traversal
    photonic_flight_cycles: float = 2.0   # time-of-flight + E/O + O/E
    burstiness: float = 3.0               # PARSEC batch-arrival factor
    # Finite-buffer backpressure: the queueing term diverges as
    # rho -> buffer_sat instead of 1.0.
    buffer_sat: float = 0.55
    # Mesh links adjacent to a gateway router that traffic converges onto.
    feed_links: float = 2.0

    def serialization_cycles(self, wavelengths) -> torch.Tensor:
        """Cycles to push one packet through a gateway with W wavelengths."""
        w = torch.as_tensor(wavelengths, dtype=torch.float32)
        bits_per_cycle = w * (self.cfg.link_gbps_per_wavelength
                              / self.cfg.noc_freq_ghz)
        return self.cfg.packet_bits / bits_per_cycle

    @property
    def port_cycles(self) -> float:
        """Electronic gateway-port service time: packet_flits cycles per
        packet regardless of optical wavelengths (1 flit/cycle ejection)."""
        return float(self.cfg.packet_flits)

    def _md1_wait(self, rho: torch.Tensor, service) -> torch.Tensor:
        """W = b * rho_eff * s / (2 (1 - rho_eff)), rho_eff = rho / rho_sat,
        clipped slightly below saturation so the epoch model stays finite.

        The division is taken as a product with the float32 reciprocal of
        rho_sat: that is what the reference's compiled code computes for
        its constant `buffer_sat` (XLA rewrites x / c as x * (1/c)), and
        near the knee 1/(1 - rho_eff) magnifies a one-ulp difference in
        rho_eff two-hundredfold.
        """
        inv_sat = 1.0 / torch.as_tensor(self.buffer_sat, dtype=torch.float32,
                                        device=rho.device)
        rho_eff = torch.clamp(rho * inv_sat, 0.0, 0.995)
        return self.burstiness * rho_eff * service / (2.0 * (1.0 - rho_eff))

    def gateway_latency(self, load_pkts_per_cycle: torch.Tensor,
                        wavelengths) -> torch.Tensor:
        """Segment (2): M/D/1 queue at the gateway + serialization +
        flight; service is the slower of optics and the electronic port."""
        s_opt = self.serialization_cycles(wavelengths).to(
            load_pkts_per_cycle.device)
        s_eff = torch.clamp_min(s_opt, self.port_cycles)
        rho = torch.clamp(load_pkts_per_cycle * s_eff, 0.0, 1.0)
        return (s_eff + self._md1_wait(rho, s_eff)
                + self.photonic_flight_cycles)

    def access_latency(self, hops, load_pkts_per_cycle: torch.Tensor,
                       burst_scale=None) -> torch.Tensor:
        """Segments (1)/(3): mesh walk to/from the gateway plus convergence
        queueing on the feed links. `burst_scale` rescales the queueing
        term (the destination-aware fan-in factor)."""
        walk = hops * self.router_pipeline_cycles
        flits_per_cycle = load_pkts_per_cycle * self.cfg.packet_flits
        rho_link = torch.clamp(flits_per_cycle / self.feed_links, 0.0, 1.0)
        link_service = float(self.cfg.packet_flits)  # 1 flit/cycle links
        wait = self._md1_wait(rho_link, link_service)
        if burst_scale is not None:
            wait = wait * burst_scale
        return walk + wait

    def mesh_latency(self, mean_hops, link_load_flits: torch.Tensor
                     ) -> torch.Tensor:
        """Intra-chiplet (non-gateway) packets: uniform-mesh M/D/1 per link."""
        walk = mean_hops * self.router_pipeline_cycles
        rho = torch.clamp(link_load_flits, 0.0, 1.0)
        service = float(self.cfg.packet_flits)
        return (walk + self.cfg.packet_flits
                + self._md1_wait(rho, service))

    def inter_chiplet_latency(self, gw_load: torch.Tensor, wavelengths,
                              src_hops, dst_hops) -> torch.Tensor:
        """End-to-end latency for an inter-chiplet packet (all segments)."""
        return (self.access_latency(src_hops, gw_load)
                + self.gateway_latency(gw_load, wavelengths)
                + self.access_latency(dst_hops, gw_load))

    def saturated(self, gw_load: torch.Tensor, wavelengths) -> torch.Tensor:
        """True when the gateway queue has crossed the buffer knee."""
        s = torch.clamp_min(self.serialization_cycles(wavelengths).to(
            gw_load.device), self.port_cycles)
        return gw_load * s > self.buffer_sat


def uniform_mesh_mean_hops(cfg: NetworkConfig = NETWORK) -> float:
    """Mean hop count between uniformly random iid routers (closed form on
    derived meshes, the BFS hop-matrix mean on explicit layouts)."""
    from repro_torch.core import topology
    return topology.mean_hops(cfg)
