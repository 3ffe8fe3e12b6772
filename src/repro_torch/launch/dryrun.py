"""Dry run of every (architecture x input shape) cell on the production
meshes: the counterpart of the reference's `repro.launch.dryrun`.

The reference lowers and compiles each cell's program onto 256 / 512
placeholder devices and reads XLA's memory, cost and collective analyses.
The port needs no placeholder devices: its production meshes are logical
already (`launch.mesh.make_production_mesh`). It builds the reference's
three programs on `meta` inputs (shapes and dtypes, nothing allocated), the
train step, the prefill and the decode step, runs each once under the
op-by-op counter (`launch.op_analysis`), and accounts that one trace on
every mesh asked for: the op stream does not depend on the mesh, only the
shards and collectives do.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch stablelm-3b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --jobs 4  # all cells

Each record has the reference's keys (`arch`, `shape`, `mesh`, `status` ok
/ skipped / error with `reason` / `error` / `traceback`, `n_devices`,
`memory`, `cost`, `corrected`, `collectives`), `trace_s` in place of
`lower_s` and `compile_s`, and `kernels` (the work the kernel ops
credited). Memory per device: `argument_bytes` sums each argument leaf's
shard (uneven dimensions padded up, as XLA pads them), `output_bytes` each
output's (an output that is an argument at its shard, a new one at its
size over the batch shards), `alias_bytes` the donated arguments (the train
state, the decode caches), `temp_bytes` the trace's peak of live
temporaries over the batch shards, an upper estimate
(`temp_is_upper_estimate`: the port's program does not split activations
over the model axis), and `peak_per_device` argument + output + temp -
alias, as the reference sums it. `cost` is the global count over the
devices; `corrected` equals it (eager execution counts every layer; the
key keeps the reference's `roofline.analyze` able to read a record).
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import sys
import time
import traceback
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path
from typing import Optional

import torch

from repro_torch.backend import REPO_ROOT
from repro_torch.configs import (ARCH_NAMES, SHAPES, cell_applicable,
                                 get_config, shape_by_name)
from repro_torch.launch import op_analysis as OA
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import get_model
from repro_torch.models.params import abstract_params, partition_specs
from repro_torch.sharding.rules import (SP_OVERLAY, TP_ONLY_OVERLAY, Rules,
                                        use_rules)
from repro_torch.train.train_step import (abstract_train_state,
                                          make_train_step, state_pspecs)

OUT = REPO_ROOT / "build" / "analysis" / "dryrun.json"
RULE_OVERLAYS = {"default": None, "tp_only": TP_ONLY_OVERLAY,
                 "sp": SP_OVERLAY}


def mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def build_cell(arch: str, shape_name: str, accum: int = 1):
    """(program, arguments, layouts(rules), donated argument indices,
    grads) of one cell, or None with the skip reason."""
    cfg = get_config(arch)
    cell = shape_by_name(shape_name)
    ok, reason = cell_applicable(cfg, cell)
    if not ok:
        return None, reason
    model = get_model(cfg)
    spec_tree = model.spec()

    def params_layout(params, rules):
        return OA.layouts(params, partition_specs(spec_tree, rules),
                          "param", spec_tree)

    if cell.kind == "train":
        state = abstract_train_state(model)
        batch, _ = S.batch_specs(cfg, cell, _FREE_RULES)

        def lays(rules):
            ps = state_pspecs(model, rules)
            return ({"params": params_layout(state["params"], rules),
                     "opt": OA.layouts(state["opt"], ps["opt"], "state"),
                     "step": OA.layouts(state["step"], ps["step"],
                                        "state")},
                    OA.layouts(batch, S.batch_specs(cfg, cell, rules)[1],
                               "batch"))
        return (make_train_step(model, accum=accum), (state, batch), lays,
                (0,), True), ""
    # Serving runs bf16 weights (cast once at load, as the reference's
    # dry run casts them).
    params = abstract_params(spec_tree, dtype=torch.bfloat16)
    if cell.kind == "prefill":
        batch, _ = S.batch_specs(cfg, cell, _FREE_RULES)
        max_len = cell.seq_len

        def prefill(p, b):
            return model.prefill(p, b, max_len)

        def lays(rules):
            return (params_layout(params, rules),
                    OA.layouts(batch, S.batch_specs(cfg, cell, rules)[1],
                               "batch"))
        return (prefill, (params, batch), lays, (), False), ""
    tokens, _ = S.decode_tokens_specs(cfg, cell, _FREE_RULES)
    caches, _ = S.decode_cache_specs(cfg, cell, _FREE_RULES)

    def lays(rules):
        return (params_layout(params, rules),
                OA.layouts(tokens, S.decode_tokens_specs(cfg, cell,
                                                         rules)[1], "batch"),
                OA.layouts(caches, S.decode_cache_specs(cfg, cell,
                                                        rules)[1], "cache"))
    return (model.decode_step, (params, tokens, caches), lays, (2,),
            False), ""


# Shapes do not depend on the rules: the inputs are built once, against the
# one-pod mesh.
_FREE_RULES = Rules(make_production_mesh())


def trace_cell(arch: str, shape_name: str, multi_pod: bool = False,
               rule_overrides: Optional[dict] = None, accum: int = 1):
    """Build one cell's program on `meta` inputs and run it once under the
    counter: ((trace, layouts(rules), donated, seconds), "") or (None,
    the skip reason). `multi_pod` and `rule_overrides` only choose the
    layouts the trace records its leaves with; the op stream is the same
    on every mesh."""
    built, reason = build_cell(arch, shape_name, accum)
    if built is None:
        return None, reason
    fn, args, lays, donated, grads = built
    rules = Rules(make_production_mesh(multi_pod=multi_pod),
                  overrides=rule_overrides)
    t0 = time.perf_counter()
    with use_rules(rules):
        tr = OA.trace(fn, *args, specs=lays(rules), grads=grads,
                      entry=f"{arch}:{shape_name}")
    return (tr, lays, donated, time.perf_counter() - t0), ""


def account(tr: OA.Trace, lays, donated: tuple, multi_pod: bool,
            rule_overrides: Optional[dict] = None) -> dict:
    """The record's `n_devices`, `memory`, `cost`, `corrected`,
    `collectives`, `collective_rules` and `kernels` on one mesh."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    rules = Rules(mesh, overrides=rule_overrides)
    specs = lays(rules)
    nb = OA.batch_shards(OA.layout_list(tr.args, specs), mesh)
    n = mesh.size
    pieces = OA.argument_bytes(tr.args, specs, mesh)
    arg_bytes = sum(pieces)
    alias_bytes = sum(b for (path, _, _), b in zip(tr.leaves, pieces)
                      if int(path.split("/")[1]) in donated)
    by_id = {id(t): b for (_, t, _), b in zip(tr.leaves, pieces)}
    out_bytes = sum(by_id.get(id(t), -(-OA._nbytes(t) // nb))
                    for t in tr.outputs)
    temp = -(-tr.peak_live_bytes // nb)
    coll = OA.collectives(tr, mesh, specs)
    by_rule = coll.pop("by_rule")
    cost = {"flops_per_device": tr.flops / n,
            "bytes_accessed_per_device": tr.bytes / n}
    return {
        "n_devices": n,
        "memory": {"argument_bytes": int(arg_bytes),
                   "output_bytes": int(out_bytes),
                   "temp_bytes": int(temp),
                   "alias_bytes": int(alias_bytes),
                   "peak_per_device": int(arg_bytes + out_bytes + temp
                                          - alias_bytes),
                   "temp_is_upper_estimate": True},
        "cost": cost,
        "corrected": {"flops_per_device": cost["flops_per_device"],
                      "bytes_per_device":
                          cost["bytes_accessed_per_device"]},
        "collectives": coll,
        "collective_rules": by_rule,
        "kernels": {k: dict(v) for k, v in tr.kernels.items()},
    }


def analyze_pair(arch: str, shape_name: str, meshes=(False, True),
                 rule_overrides: Optional[dict] = None,
                 accum: int = 1) -> list:
    """One record per mesh of `meshes` (False: 16 x 16, True: 2 x 16 x 16)
    for one (arch, shape), all from one trace."""
    recs = [{"arch": arch, "shape": shape_name, "mesh": mesh_name(mp),
             "status": "ok"} for mp in meshes]
    try:
        built, reason = trace_cell(arch, shape_name, meshes[0],
                                   rule_overrides, accum)
        if built is None:
            for rec in recs:
                rec.update(status="skipped", reason=reason)
            return recs
        tr, lays, donated, seconds = built
        for rec, mp in zip(recs, meshes):
            rec["trace_s"] = round(seconds, 2)
            rec.update(account(tr, lays, donated, mp, rule_overrides))
    except Exception as e:          # a failing cell is a bug: record it
        for rec in recs:
            for k in list(rec):
                if k not in ("arch", "shape", "mesh"):
                    rec.pop(k)
            rec.update(status="error", error=f"{type(e).__name__}: {e}",
                       traceback=traceback.format_exc()[-2000:])
    return recs


def analyze_cell(arch: str, shape_name: str, multi_pod: bool,
                 rule_overrides: Optional[dict] = None,
                 accum: int = 1) -> dict:
    """The reference's `analyze_cell`: one record on one mesh."""
    return analyze_pair(arch, shape_name, (multi_pod,), rule_overrides,
                        accum)[0]


def run_pairs(pairs, meshes=(False, True),
              rule_overrides: Optional[dict] = None, accum: int = 1,
              jobs: int = 1):
    """`analyze_pair` over (arch, shape) `pairs`, yielding each pair's
    records in order; `jobs` > 1 traces that many pairs at once in
    spawned worker processes (each trace is single-threaded Python)."""
    args = [(a, s, tuple(meshes), rule_overrides, accum) for a, s in pairs]
    if jobs <= 1:
        for a in args:
            yield analyze_pair(*a)
        return
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(jobs, mp_context=ctx) as pool:
        yield from pool.map(_pair, args)


def _pair(a: tuple) -> list:
    return analyze_pair(*a)


def save_result(rec: dict, path: Path) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    data = json.loads(path.read_text()) if path.exists() else {}
    data[f"{rec['arch']}|{rec['shape']}|{rec['mesh']}"] = rec
    path.write_text(json.dumps(data, indent=1))


def describe(rec: dict) -> str:
    """One line for a record, as the reference prints it."""
    if rec["status"] == "ok":
        return (f"ok: peak {rec['memory']['peak_per_device'] / 2**30:.2f} "
                f"GiB/dev, {rec['cost']['flops_per_device']:.3g} flop/dev, "
                f"wire {rec['collectives']['total_wire_bytes'] / 2**20:.1f} "
                f"MiB/dev (trace {rec['trace_s']}s)")
    if rec["status"] == "skipped":
        return f"skipped: {rec['reason']}"
    return f"ERROR: {rec['error']}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all", help="architecture id or 'all'")
    ap.add_argument("--shape", default="all", help="shape cell or 'all'")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default=str(OUT))
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--rules", default="default", choices=list(RULE_OVERLAYS),
                    help="sharding-rule overlay (perf A/B comparisons)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="pairs traced at once, in worker processes")
    args = ap.parse_args(argv)

    archs = list(ARCH_NAMES) if args.arch == "all" else [args.arch]
    shapes = [s.name for s in SHAPES] if args.shape == "all" \
        else [args.shape]
    meshes = {"single": (False,), "multi": (True,),
              "both": (False, True)}[args.mesh]
    out = Path(args.out)
    n_err = 0
    pairs = [(a, s) for a in archs for s in shapes]
    for (arch, shape), recs in zip(pairs, run_pairs(
            pairs, meshes, RULE_OVERLAYS[args.rules], args.accum,
            args.jobs)):
        print(f"[dryrun] {arch} x {shape}", flush=True)
        for rec in recs:
            save_result(rec, out)
            n_err += rec["status"] == "error"
            print(f"  {rec['mesh']}: {describe(rec)}", flush=True)
    data = json.loads(out.read_text())
    counts = {s: sum(r["status"] == s for r in data.values())
              for s in ("ok", "skipped", "error")}
    print(f"[dryrun] total: {counts['ok']} ok, {counts['skipped']} skipped, "
          f"{counts['error']} errors ({out})")
    return 1 if n_err or counts["error"] else 0


if __name__ == "__main__":
    sys.exit(main())
