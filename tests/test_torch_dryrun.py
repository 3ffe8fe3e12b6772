"""The port's dry run (`repro_torch.launch.dryrun`) and H100 roofline
(`repro_torch.launch.roofline`) on the CPU, held to the reference's
(`repro.launch.dryrun`, `benchmarks/roofline.py`).

- `model_flops` equals the reference's for all 10 archs x 4 shapes;
- the roofline formula with a chip carrying TPU v5e's three values equals
  the reference's `analyze` on a port record (every key, 1e-12), so the
  reference reads a port record; the H100's collective term takes NVLink
  inside one node and InfiniBand past it;
- every leaf's per-device shard shape, for all 10 archs' train states
  (AdamW and Adafactor), bf16 serving parameters and decode caches on both
  production meshes, equals jax's `NamedSharding(AbstractMesh(...),
  P(*spec)).shard_shape`, and `argument_bytes` sums them;
- three full-size cells on the production mesh are `ok` (stablelm-3b
  train_4k, its FLOPs within [1, 2] x model FLOPs; zamba2-7b prefill_32k,
  flash and SSD credited; grok-1 decode_32k); every full-attention arch's
  long_500k is skipped with the reference's reason; the CLI exits 1 on an
  error cell and the roofline CLI writes its table;
- `LaneState.init` defaults to the card (`examples/torch_serve_batch.py`
  is held to `examples/serve_batch.py` in `test_torch_serve_launch.py`,
  beside the reference's compiled server).
"""
import contextlib
import dataclasses
import io
import json

import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as P

import benchmarks.roofline as jroof
from repro.configs import SHAPES as JSHAPES
from repro.configs import cell_applicable as jcell_applicable
from repro.configs import get_config as jget_config
from repro.core.constants import TPU
from repro_torch.configs import (ARCH_NAMES, SHAPES, cell_applicable,
                                 get_config, shape_by_name)
from repro_torch.core import reconfig_runtime
from repro_torch.core.constants import H100SXM
from repro_torch.launch import dryrun, roofline
from repro_torch.launch import op_analysis as OA
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import get_model
from repro_torch.models.params import abstract_params, partition_specs
from repro_torch.sharding.rules import Rules
from repro_torch.train.train_step import abstract_train_state, state_pspecs

SHAPE_NAMES = [s.name for s in SHAPES]
# A chip carrying TPU v5e's three roofline values.
TPU_LIKE = H100SXM(peak_bf16_flops=TPU.peak_bf16_flops,
                   hbm_bytes_per_s=TPU.hbm_bytes_per_s,
                   nvlink_bytes_per_s=TPU.ici_bytes_per_s_per_link,
                   ib_bytes_per_s=TPU.ici_bytes_per_s_per_link)


@pytest.mark.parametrize("shape", SHAPE_NAMES)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_model_flops_are_the_references(arch, shape):
    assert roofline.model_flops(arch, shape) == jroof.model_flops(arch, shape)


@pytest.fixture(scope="module")
def decode_records():
    """A port record per production mesh (mamba2-130m decode_32k)."""
    return dryrun.analyze_pair("mamba2-130m", "decode_32k")


def test_roofline_formula_and_record_are_the_references(decode_records):
    for rec in decode_records:
        assert rec["status"] == "ok", rec.get("error")
        want = jroof.analyze(rec)
        got = roofline.analyze(rec, chip=TPU_LIKE)
        for k, v in want.items():
            if isinstance(v, float):
                assert got[k] == pytest.approx(v, rel=1e-12), k
            else:
                assert got[k] == v, k
        assert "|" in roofline.table([roofline.analyze(rec)])


def test_collective_term_takes_the_slowest_link(decode_records):
    rec = dict(decode_records[0])
    wire = rec["collectives"]["total_wire_bytes"]
    assert rec["collectives"]["group_span"] > H100SXM.nvlink_domain
    ib = roofline.analyze(rec)["t_collective_s"]
    assert ib == wire / H100SXM.ib_bytes_per_s
    rec["collectives"] = dict(rec["collectives"], group_span=8)
    assert roofline.analyze(rec)["t_collective_s"] == \
        wire / H100SXM.nvlink_bytes_per_s


# ---------------------------------------------------------------------------
# Per-device shards against jax's
# ---------------------------------------------------------------------------

def _jax_shard(shape, spec, mesh) -> tuple:
    amesh = AbstractMesh(tuple(mesh.shape), tuple(mesh.axis_names))
    return tuple(NamedSharding(amesh, P(*spec)).shard_shape(tuple(shape)))


def _arg_trees(arch: str, rules):
    """(args, layouts) of the train states (both optimizers), bf16 serving
    parameters and every applicable decode cell's caches."""
    cfg = get_config(arch)
    out = []
    for opt in ("adamw", "adafactor"):
        model = get_model(dataclasses.replace(cfg, optimizer=opt))
        state = abstract_train_state(model)
        ps = state_pspecs(model, rules)
        out.append((state, {"params": OA.layouts(state["params"],
                                                 ps["params"], "param"),
                            "opt": OA.layouts(state["opt"], ps["opt"],
                                              "state"),
                            "step": OA.layouts(state["step"], (), "state")}))
    model = get_model(cfg)
    params = abstract_params(model.spec(), dtype=torch.bfloat16)
    out.append((params, OA.layouts(params, partition_specs(model.spec(),
                                                           rules), "param")))
    for cell in SHAPES:
        if cell.kind == "decode" and cell_applicable(cfg, cell)[0]:
            caches, cps = S.decode_cache_specs(cfg, cell, rules)
            out.append((caches, OA.layouts(caches, cps, "cache")))
    return out


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16",
                                                          "2x16x16"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_shard_shapes_are_jax_s(arch, multi_pod):
    mesh = make_production_mesh(multi_pod=multi_pod)
    rules = Rules(mesh)
    n = 0
    for tree, lays in _arg_trees(arch, rules):
        want_bytes = 0
        for t, lay in zip([t for _, t in OA.tree_tensors(tree)],
                          OA.layout_list((tree,), (lays,))):
            want = _jax_shard(t.shape, lay.spec, mesh)
            assert OA.shard_shape(t.shape, lay.spec, mesh) == want, \
                (arch, t.shape, lay.spec)
            want_bytes += int(torch.Size(want).numel()) * t.element_size()
            n += 1
        assert sum(OA.argument_bytes((tree,), (lays,), mesh)) == want_bytes
    assert n > 0


# ---------------------------------------------------------------------------
# Full-size cells
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,shape", [("stablelm-3b", "train_4k"),
                                        ("zamba2-7b", "prefill_32k"),
                                        ("grok-1-314b", "decode_32k")])
def test_full_size_cells(arch, shape):
    rec = dryrun.analyze_cell(arch, shape, multi_pod=False)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["n_devices"] == 256 and rec["mesh"] == "16x16"
    mem = rec["memory"]
    assert mem["peak_per_device"] == mem["argument_bytes"] \
        + mem["output_bytes"] + mem["temp_bytes"] - mem["alias_bytes"]
    assert rec["corrected"]["flops_per_device"] == \
        rec["cost"]["flops_per_device"] > 0
    ratio = rec["cost"]["flops_per_device"] * rec["n_devices"] \
        / roofline.model_flops(arch, shape)
    print(f"{arch} {shape}: counted / model FLOPs {ratio:.4f}; kernels "
          f"{rec['kernels']}; wire "
          f"{rec['collectives']['total_wire_bytes'] / 2**20:.1f} MiB/dev")
    cfg = get_config(arch)
    if shape == "train_4k":
        assert 1.0 <= ratio <= 2.0
        # forward and rematerialization a layer
        assert rec["kernels"]["flash_attention"]["calls"] == \
            2 * cfg.n_layers
        assert mem["alias_bytes"] > 0
    elif shape == "prefill_32k":
        assert rec["kernels"]["ssd_scan"]["calls"] == cfg.n_layers
        assert rec["kernels"]["flash_attention"]["calls"] == \
            cfg.n_layers // cfg.attn_every
    else:
        assert rec["kernels"] == {} and mem["alias_bytes"] > 0
        assert rec["collective_rules"]["5"] > 0


@pytest.mark.parametrize("arch", [a for a in ARCH_NAMES
                                  if not get_config(a).sub_quadratic])
def test_full_attention_long_500k_is_skipped(arch):
    rec = dryrun.analyze_cell(arch, "long_500k", multi_pod=True)
    want = jcell_applicable(jget_config(arch), next(
        s for s in JSHAPES if s.name == "long_500k"))
    assert (rec["status"], rec["reason"]) == ("skipped", want[1])
    assert not want[0] and not cell_applicable(
        get_config(arch), shape_by_name("long_500k"))[0]


def test_cli_exit_codes_and_the_roofline_table(tmp_path, monkeypatch):
    out = tmp_path / "dryrun.json"
    with contextlib.redirect_stdout(io.StringIO()):
        assert dryrun.main(["--arch", "mamba2-130m", "--shape",
                            "decode_32k", "--mesh", "single", "--out",
                            str(out)]) == 0
        rows = roofline.main(["--dryrun", str(out), "--out",
                              str(tmp_path / "r.json"), "--md",
                              str(tmp_path / "r.md")])
    assert [(r["arch"], r["shape"]) for r in rows] == \
        [("mamba2-130m", "decode_32k")]
    assert json.loads((tmp_path / "r.json").read_text()) == rows
    assert "mamba2-130m | decode_32k" in (tmp_path / "r.md").read_text()

    def broken(*a, **k):
        raise RuntimeError("a cell that fails")
    monkeypatch.setattr(dryrun, "build_cell", broken)
    with contextlib.redirect_stdout(io.StringIO()):
        assert dryrun.main(["--arch", "stablelm-3b", "--shape", "train_4k",
                            "--out", str(out)]) == 1
    recs = json.loads(out.read_text())
    assert recs["stablelm-3b|train_4k|16x16"]["status"] == "error"
    assert "a cell that fails" in recs["stablelm-3b|train_4k|2x16x16"][
        "error"]


# ---------------------------------------------------------------------------
# The lane controller's device
# ---------------------------------------------------------------------------

def test_lane_state_defaults_to_the_card():
    cfg = reconfig_runtime.LaneConfig()
    if torch.cuda.is_available():
        assert reconfig_runtime.LaneState.init(cfg).lanes.device.type \
            == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA device"):
            reconfig_runtime.LaneState.init(cfg)
    assert reconfig_runtime.LaneState.init(cfg, device="cpu") \
        .lanes.device.type == "cpu"

