"""Physical and simulation constants (port of `repro.core.constants`).

Paper-side constants come from ReSiPI Table 1 and §4.1 (power model inherited
from PROWAVES [16]/Polster [19]). A verbatim copy of the reference's
dataclasses: the port keeps its own copy so that it imports nothing of the
JAX package. In place of the reference's TPU v5e roofline constants it
holds the card's (`H100SXM`), which `launch/roofline.py` and
`chip_smoke.py`'s bounds read.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


# ---------------------------------------------------------------------------
# ReSiPI paper constants (Table 1 + §4.1 + §4.3)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PhotonicPower:
    """Silicon-photonic power model (PROWAVES model, §4.1)."""

    laser_mw_per_wavelength: float = 30.0   # per wavelength per waveguide
    tia_mw: float = 2.0                     # per active photodiode/receiver
    tuning_mw_per_mr: float = 3.0           # thermal tuning per active MR
    driver_mw: float = 3.0                  # per active modulator driver
    pcmc_reconfig_nj: float = 2.0           # PCM switch reconfiguration energy
    pcmc_reconfig_cycles: int = 100         # 100 ns @ 1 GHz (Kato et al. [10])
    laser_tune_cycles: int = 1              # SOA laser power tuning: 20-50 ps
    awgr_loss_db: float = 1.8               # AWGR insertion loss (§4.4)
    controller_lgc_uw: float = 172.0        # Table 2, per-chiplet local ctl
    controller_inc_uw: float = 787.0        # Table 2, interposer controller
    # Access-waveguide propagation loss from a gateway's TSV/coupler down to
    # the interposer waveguide: ~3 dB/cm for standard SOI strip waveguides.
    # An edge-placed gateway pays ~0; an interior placement pays its distance
    # to the nearest chiplet edge — the placement latency/power trade-off.
    waveguide_db_per_mm: float = 0.3


@dataclasses.dataclass(frozen=True)
class NetworkConfig:
    """2.5D system topology (Table 1)."""

    n_chiplets: int = 4
    mesh_x: int = 4                         # intra-chiplet mesh is 4x4
    mesh_y: int = 4
    max_gateways_per_chiplet: int = 4       # ReSiPI / AWGR
    memory_gateways: int = 2                # gateways for memory controllers
    gateway_buffer_flits: int = 8           # ReSiPI/AWGR (PROWAVES uses 32)
    router_buffer_flits: int = 4
    noc_freq_ghz: float = 1.0
    link_gbps_per_wavelength: float = 12.0  # optical data rate
    flit_bits: int = 32
    packet_flits: int = 8
    reconfig_interval_cycles: int = 1_000_000
    sim_cycles: int = 100_000_000
    warmup_cycles: int = 10_000
    # Gateway-attached router coordinates on the chiplet mesh, in activation
    # order (row k lights up at activation level k+1). None selects the
    # edge-distributed default scheme (selection.default_gateway_positions);
    # an explicit value is a tuple of (x, y) pairs — kept hashable so the
    # config stays a valid static jit key and an lru_cache key, which is what
    # makes placement a compile-free DSE axis (sweep_placement).
    gateway_positions: Optional[Tuple[Tuple[int, int], ...]] = None
    router_pitch_mm: float = 1.0            # mesh tile pitch (waveguide mm/hop)
    # Arbitrary router-layout model (PR 10). `coords=None` keeps the derived
    # mesh_x x mesh_y grid — every distance/table builder then uses the exact
    # mesh closed forms (bit parity with the pre-coords code). An explicit
    # `coords` tuple of (x, y) pairs pins an arbitrary layout whose adjacency
    # is given by `coord_model` ("mesh": 4-neighbor grid steps; "hex":
    # 6-neighbor axial steps — see repro_torch.core.topology). Kept hashable for
    # the same static-jit-key reasons as gateway_positions.
    coord_model: str = "mesh"
    coords: Optional[Tuple[Tuple[int, int], ...]] = None

    def __post_init__(self):
        if self.gateway_positions is not None:
            try:
                norm = tuple((int(x), int(y))
                             for x, y in self.gateway_positions)
            except (TypeError, ValueError) as e:
                raise ValueError(
                    "gateway_positions must be a sequence of (x, y) pairs, "
                    f"got {self.gateway_positions!r}") from e
            object.__setattr__(self, "gateway_positions", norm)
        if self.coords is not None:
            try:
                norm = tuple((int(x), int(y)) for x, y in self.coords)
            except (TypeError, ValueError) as e:
                raise ValueError(
                    "coords must be a sequence of (x, y) pairs, "
                    f"got {self.coords!r}") from e
            if not norm:
                raise ValueError("coords must name at least one router; "
                                 "use None for the derived mesh layout")
            object.__setattr__(self, "coords", norm)

    @property
    def routers_per_chiplet(self) -> int:
        if self.coords is not None:
            return len(self.coords)
        return self.mesh_x * self.mesh_y

    @property
    def packet_bits(self) -> int:
        return self.packet_flits * self.flit_bits

    @property
    def total_gateways(self) -> int:
        """All chiplet gateways + memory-controller gateways (18 in Table 1)."""
        return (self.n_chiplets * self.max_gateways_per_chiplet
                + self.memory_gateways)

    def with_topology(self, *, n_chiplets: int | None = None,
                      gateways_per_chiplet: int | None = None,
                      mesh_radix: int | None = None) -> "NetworkConfig":
        """Topology-DSE variant: one grid point of a `sweep_topology` scan.

        `mesh_radix` sets a square r x r intra-chiplet mesh. These are the
        shape-defining topology axes (TOPOLOGY_SWEEPABLE_FIELDS in
        repro_torch.core.simulator); everything else is inherited. A radix change
        invalidates any explicit `gateway_positions` (coordinates belong to
        the old mesh), so it resets them to the default edge scheme — pin a
        per-radix placement via `with_placement` / the `gateway_positions`
        sweep axis instead.
        """
        kw = {}
        if n_chiplets is not None:
            kw["n_chiplets"] = int(n_chiplets)
        if gateways_per_chiplet is not None:
            kw["max_gateways_per_chiplet"] = int(gateways_per_chiplet)
        if mesh_radix is not None:
            kw["mesh_x"] = int(mesh_radix)
            kw["mesh_y"] = int(mesh_radix)
            if int(mesh_radix) != self.mesh_x \
                    or int(mesh_radix) != self.mesh_y \
                    or self.coords is not None:
                # An actual radix change: the placement's coordinates
                # belong to the old mesh, so reset to the default scheme.
                # Likewise a radix request on an explicit-coords config
                # asks for the derived r x r grid, dropping the layout.
                kw["gateway_positions"] = None
                kw["coords"] = None
        return dataclasses.replace(self, **kw)

    def with_placement(self, positions) -> "NetworkConfig":
        """Placement-DSE variant: pin explicit gateway coordinates.

        `positions` is a sequence of (x, y) router coordinates in activation
        order (None restores the default edge scheme); normalization to a
        hashable tuple happens in `__post_init__`. Validation (bounds,
        collisions, enough slots for `max_gateways_per_chiplet`) happens in
        `selection.resolve_gateway_positions` when tables are built.
        """
        return dataclasses.replace(self, gateway_positions=positions)

    def gateway_service_cycles(self, wavelengths: int) -> float:
        """Cycles to serialize one packet through a gateway with W wavelengths.

        bits/cycle = W * (link_gbps / freq_ghz); one packet = packet_bits.
        """
        bits_per_cycle = wavelengths * (self.link_gbps_per_wavelength
                                        / self.noc_freq_ghz)
        return self.packet_bits / bits_per_cycle


# Architecture-variant wavelength budgets (§4.1): PROWAVES uses up to 16
# wavelengths on a single gateway per chiplet; ReSiPI uses 4 wavelengths on up
# to 4 gateways per chiplet (equal peak bisection bandwidth); AWGR statically
# uses one wavelength per port (18 total).
RESIPI_WAVELENGTHS = 4
PROWAVES_MAX_WAVELENGTHS = 16
PROWAVES_MIN_WAVELENGTHS = 4   # Fig. 12.d floor: PROWAVES never drops below
                               # ~4 active wavelengths on its single gateway
AWGR_WAVELENGTHS = 18

# The paper's empirically selected maximum allowable gateway load (§4.2),
# in packets/cycle/gateway, chosen accepting <=10% latency overhead.
PAPER_L_M = 0.0152


# ---------------------------------------------------------------------------
# NVIDIA H100 SXM5 80GB roofline constants (the port's counterpart of the
# reference's TPUv5e; targets of launch/roofline.py and chip_smoke.py)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class H100SXM:
    """Data-sheet peaks of one H100 SXM5 80GB at its 700 W limit (NVIDIA
    H100 Tensor Core GPU data sheet, SXM5 column; DGX H100 data sheet for
    the node's links). A card held below 700 W runs slower under load."""
    peak_bf16_flops: float = 989e12        # dense BF16 tensor-core FLOP/s
    peak_f32_flops: float = 67e12          # FP32 on the CUDA cores
    hbm_bytes_per_s: float = 3.35e12       # HBM3 bandwidth
    hbm_bytes: int = 80 * 10 ** 9          # 80 GB of HBM3
    nvlink_bytes_per_s: float = 450e9      # NVLink 4, one direction
    nvlink_domain: int = 8                 # GPUs of one NVSwitch node
    ib_bytes_per_s: float = 50e9           # one 400 Gb/s NIC per GPU


PHOTONIC_POWER = PhotonicPower()
NETWORK = NetworkConfig()
H100 = H100SXM()
