"""H100 roofline of the dry run's records: the counterpart of the
reference's `benchmarks/roofline.py`, which holds them against TPU v5e.

Three terms per (arch x shape x mesh), in seconds:

    compute    = FLOPs_per_dev / peak_bf16_flops
    memory     = bytes_per_dev / hbm_bytes_per_s
    collective = wire_bytes_per_dev / the bandwidth of the slowest link its
                 groups span: NVLink for groups within `nvlink_domain`
                 consecutive devices (one NVSwitch node), InfiniBand
                 otherwise (both axes of the production meshes span more)

plus MODEL_FLOPS (6 N D train, 2 N D prefill, 2 N B decode; N the active
parameters), the useful-compute ratio MODEL_FLOPS / counted FLOPs, the
dominant term and the roofline fraction

    rf = (MODEL_FLOPS / (devices x peak)) / max(term)

the MFU bound this program could reach on the mesh, and the peak memory
per device against the card's HBM. The constants are the data sheet's
peaks of an H100 SXM5 80GB at 700 W (`core.constants.H100`), not
measurements.

    PYTHONPATH=src python -m repro_torch.launch.dryrun
    PYTHONPATH=src python -m repro_torch.launch.roofline   # build/analysis/
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.backend import REPO_ROOT
from repro_torch.configs import get_config, shape_by_name
from repro_torch.core.constants import H100

ANALYSIS = REPO_ROOT / "build" / "analysis"


def model_flops(arch: str, shape: str) -> float:
    cfg = get_config(arch)
    cell = shape_by_name(shape)
    n = cfg.active_param_count()
    if cell.kind == "train":
        return 6.0 * n * cell.global_batch * cell.seq_len
    if cell.kind == "prefill":
        return 2.0 * n * cell.global_batch * cell.seq_len
    return 2.0 * n * cell.global_batch          # decode: one token per seq


def link_bytes_per_s(rec: dict, chip=H100) -> float:
    """The slowest link the record's collective groups span."""
    span = rec["collectives"].get("group_span", rec["n_devices"])
    return chip.nvlink_bytes_per_s if span <= chip.nvlink_domain \
        else chip.ib_bytes_per_s


def analyze(rec: dict, chip=H100) -> dict:
    arch, shape = rec["arch"], rec["shape"]
    ndev = rec["n_devices"]
    cor = rec.get("corrected")
    if cor:
        fl, by = cor["flops_per_device"], cor["bytes_per_device"]
    else:
        fl = rec["cost"]["flops_per_device"]
        by = rec["cost"]["bytes_accessed_per_device"]
    wire = rec["collectives"]["total_wire_bytes"]

    t_compute = fl / chip.peak_bf16_flops
    t_memory = by / chip.hbm_bytes_per_s
    t_coll = wire / link_bytes_per_s(rec, chip)

    mf = model_flops(arch, shape)
    total = fl * ndev
    useful = mf / total if total > 0 else 0.0
    ideal = mf / (ndev * chip.peak_bf16_flops)
    terms = {"compute": t_compute, "memory": t_memory,
             "collective": t_coll}
    dominant = max(terms, key=terms.get)
    t_bound = max(terms.values())
    rf = ideal / t_bound if t_bound > 0 else 0.0
    peak = rec["memory"]["peak_per_device"]
    return {"arch": arch, "shape": shape, "mesh": rec["mesh"],
            "t_compute_s": t_compute, "t_memory_s": t_memory,
            "t_collective_s": t_coll, "dominant": dominant,
            "model_flops": mf, "useful_ratio": useful,
            "roofline_fraction": rf, "peak_gib": peak / 2**30,
            "peak_of_hbm": peak / chip.hbm_bytes}


def suggestion(row: dict) -> str:
    d = row["dominant"]
    if d == "memory":
        if row["useful_ratio"] < 0.5:
            return ("memory-bound with a low useful-FLOP ratio: cut the "
                    "recomputation and the plain attention / SSD backward's "
                    "materialized score and decay tensors (a backward "
                    "kernel keeping its blocks in shared memory)")
        return ("memory-bound: raise arithmetic intensity (a larger "
                "microbatch per card, fused elementwise chains, bf16 "
                "weights and optimizer reads)")
    if d == "collective":
        return ("collective-bound: reshard to cut wire bytes "
                "(reduce-scatter in place of all-reduce, activations kept "
                "sharded through norms and embeddings, tensor parallelism "
                "kept inside an NVLink node) or overlap the collectives "
                "with compute")
    return ("compute-bound: already at the right wall; check the useful "
            "ratio for recomputation and padding")


def table(rows: list) -> str:
    md = ["| arch | shape | compute s | memory s | coll s | dominant | "
          "useful | RF | peak GiB | what moves the dominant term |",
          "|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        md.append(
            f"| {r['arch']} | {r['shape']} | {r['t_compute_s']:.2e} "
            f"| {r['t_memory_s']:.2e} | {r['t_collective_s']:.2e} "
            f"| **{r['dominant']}** | {r['useful_ratio']:.2f} "
            f"| {r['roofline_fraction']:.3f} | {r['peak_gib']:.2f} "
            f"| {suggestion(r)} |")
    return "\n".join(md)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun", default=str(ANALYSIS / "dryrun.json"))
    ap.add_argument("--mesh", default="16x16",
                    help="the mesh of the table (one pod by default)")
    ap.add_argument("--out", default=str(ANALYSIS / "roofline.json"))
    ap.add_argument("--md", default=str(ANALYSIS / "roofline.md"))
    args = ap.parse_args(argv)

    data = json.loads(Path(args.dryrun).read_text())
    rows = [analyze(rec) for _, rec in sorted(data.items())
            if rec["status"] == "ok" and rec["mesh"] == args.mesh]
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(rows, indent=1))
    Path(args.md).write_text(table(rows) + "\n")
    for r in rows:
        print(f"{r['arch']:24s} {r['shape']:12s} dom={r['dominant']:10s} "
              f"RF={r['roofline_fraction']:.3f} useful={r['useful_ratio']:.2f}"
              f" peak={r['peak_gib']:.1f}GiB")
    print(f"\nwrote {args.out} and {args.md} (H100 SXM5 data-sheet peaks, "
          f"700 W)")
    return rows


if __name__ == "__main__":
    main()
