"""Quickstart for the PyTorch port: the ReSiPI pipeline end to end.

Generates PARSEC-like traffic, simulates all four interposer architectures
(the Fig. 11 comparison on one trace), then runs the same controller
managing communication lanes (`repro_torch.core.reconfig_runtime`).

    PYTHONPATH=src python examples/torch_quickstart.py            # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse

from repro_torch.core import reconfig_runtime as lanes
from repro_torch.core import traffic
from repro_torch.core.simulator import simulate_all_archs


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    dev = p.parse_args(argv).device

    # --- Level 1: the paper's network -----------------------------------
    print("== ReSiPI photonic-interposer simulation (dedup trace) ==")
    tr = traffic.generate_trace("dedup", 60, 0, device=dev)
    out = simulate_all_archs(tr, device=dev)
    for arch, s in out.items():
        print(f"  {arch:12s} latency {float(s['mean_latency']):7.2f} cyc   "
              f"power {float(s['mean_power_mw']):7.1f} mW   "
              f"energy {float(s['mean_energy']):9.1f}")
    resipi, prow = out["resipi"], out["prowaves"]
    lat = 1 - float(resipi["mean_latency"]) / float(prow["mean_latency"])
    pwr = 1 - float(resipi["mean_power_mw"]) / float(prow["mean_power_mw"])
    print(f"  -> ReSiPI vs PROWAVES: latency -{lat:.0%}, power -{pwr:.0%} "
          f"(paper: -37% / -25%)")

    # --- Level 2: the same controller on collective traffic --------------
    print("\n== Lane controller on synthetic collective traffic ==")
    cfg = lanes.LaneConfig(lane_bytes_per_step=1e6)
    st = lanes.LaneState.init(cfg, device=dev)
    history = [int(st.lanes)]
    for phase, byte_rate in (("heavy", 3.5e6), ("light", 2e5),
                             ("medium", 1.2e6)):
        for _ in range(20):
            st = lanes.meter_step(st, byte_rate)
        st, rec = lanes.epoch_update(st, cfg)
        history.append(int(rec["lanes_after"]))
        print(f"  phase {phase:6s}: load {float(rec['load']):5.2f} -> "
              f"{int(rec['lanes_after'])} lanes")
    rep = lanes.lane_energy_report(history, cfg)
    print(f"  lane power {float(rep['mean_power_mw']):.1f} mW on average, "
          f"{int(rep['switch_count'])} switches "
          f"({float(rep['reconfig_nj']):.0f} nJ of PCM reconfiguration)")
    print("  (gateway-activation law Eqs. 5-7, applied to GPU comm lanes)")


if __name__ == "__main__":
    main()
