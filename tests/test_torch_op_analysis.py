"""The port's op-by-op analysis (`repro_torch.launch.op_analysis`) on the
CPU, held to the reference's HLO analyzer (`repro.launch.hlo_analysis`).

- the ring wire factors equal `_wire_bytes` for the five collectives;
- the kernel ops' `meta` branches: the kernel's output shapes and dtypes,
  and `work(...)` credited once a call (the formulas `chip_smoke.py`
  imports); CPU tensors still run the plain versions; the launch takes
  CUDA tensors only, and an unsupported device raises;
- FLOPs of the smoke dense (stablelm-3b) and MoE (grok-1) train steps at
  S <= flash_block_q (both packages take dense attention) against
  `analyze_hlo` of the reference's compiled step: equal within 2% once
  the port's chunked cross-entropy is not rematerialized (the reference's
  scan keeps its logits for the backward; the port recomputes each chunk's
  unembedding product), and the port's program as it runs at the ratio
  pinned in ROADMAP queue 3, P17 (within 1%);
- the five collective rules, by hand, on one-layer smoke configs on a
  2 x 2 ("data", "model") mesh, and the whole train step's wire bytes
  against the reference's partitioner (a 4-device XLA subprocess) within
  [0.5, 2];
- bytes, peak live bytes and the views the analysis follows.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.launch.hlo_analysis import _wire_bytes
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeCell
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import reference_attention
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import reference_intra_chunk
from repro_torch.launch import op_analysis as OA
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_logical_mesh
from repro_torch.models import get_model
from repro_torch.models import transformer as T
from repro_torch.models.params import (abstract_params, partition_specs,
                                       tree_map)
from repro_torch.sharding.rules import Rules
from repro_torch.train.train_step import (abstract_train_state,
                                          make_train_step, state_pspecs)

REPO = Path(__file__).resolve().parents[1]
CELL = ShapeCell("smoke_train", 32, 4, "train")
# The port's FLOPs over the reference's compiled step (ROADMAP queue 3,
# P17): the chunked cross-entropy's unembedding product recomputed in the
# backward. Measured on these smoke steps; pinned within 1%.
CE_RECOMPUTE_RATIO = {"stablelm-3b": 1.26722, "grok-1-314b": 1.25780}


@pytest.mark.parametrize("n", [1, 2, 4, 16, 256])
@pytest.mark.parametrize("op", OA.COLLECTIVES)
def test_wire_bytes_are_the_references(op, n):
    assert OA.wire_bytes(op, 1000, n) == _wire_bytes(op, 1000, n)


# ---------------------------------------------------------------------------
# The kernel ops' meta branches
# ---------------------------------------------------------------------------

def _credits(fn):
    got = []
    from repro_torch import backend
    with backend.work_sink(lambda *a: got.append(a)):
        out = fn()
    return out, got


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal,s_kv", [(True, 48), (False, 64)])
def test_flash_meta_branch_credits_its_work(causal, s_kv, dtype):
    import chip_smoke
    b, s, h, d = 2, 48, 4, 32
    q = torch.empty(b, s, h, d, device="meta", dtype=dtype)
    kv = torch.empty(b, s_kv, h, d, device="meta", dtype=dtype)
    out, got = _credits(lambda: flash_ops.flash_attention(q, kv, kv,
                                                          causal=causal))
    assert out.device.type == "meta" and out.shape == q.shape \
        and out.dtype == dtype
    want = flash_ops.work(b, s, h, d, q.element_size(), causal, s_kv)
    assert got == [("flash_attention", *want)]
    assert chip_smoke.flash_work(b, s, h, d, q.element_size(), causal,
                                 s_kv) == want
    if s_kv == s:        # the formula chip_smoke.py bounds its kernel with
        pairs = s * (s + 1) // 2 if causal else s * s
        assert want == (4 * b * s * h * d * q.element_size(),
                        4 * d * pairs * b * h)


def _ssd_inputs(device, dtype=torch.float32, seed=0):
    rng = np.random.RandomState(seed)
    bsz, nc, q, h, p, g, n = 2, 3, 32, 4, 16, 2, 8
    t = lambda *shape: torch.tensor(  # noqa: E731
        rng.randn(*shape).astype(np.float32)).to(device)
    return (t(bsz, nc, q, h, p).to(dtype), t(bsz, nc, q, h).abs() * 0.1,
            -t(h).abs(), t(bsz, nc, q, g, n).to(dtype),
            t(bsz, nc, q, g, n).to(dtype))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ssd_meta_branch_credits_its_work(dtype):
    import chip_smoke
    args = [x.to("meta") for x in _ssd_inputs("cpu", dtype)]
    (y, s), got = _credits(lambda: ssd_ops.ssd_intra_chunk(*args))
    bsz, nc, q, h, p = args[0].shape
    g, n = args[3].shape[3:]
    assert (y.device.type, y.shape, y.dtype) == ("meta", (bsz, nc, q, h, p),
                                                 torch.float32)
    assert (s.shape, s.dtype) == ((bsz, nc, h, p, n), torch.float32)
    want = ssd_ops.work(bsz, nc, q, h, p, g, n, args[0].element_size())
    assert got == [("ssd_scan", *want)]
    assert chip_smoke.ssd_work(bsz, nc, q, h, p, g, n,
                               args[0].element_size()) == want


def test_cpu_tensors_still_run_the_plain_versions():
    x = _ssd_inputs("cpu")
    (y, s), got = _credits(lambda: ssd_ops.ssd_intra_chunk(*x))
    want_y, want_s = reference_intra_chunk(*x)
    assert got == [] and torch.equal(y, want_y) and torch.equal(s, want_s)
    rng = np.random.RandomState(1)
    q, k, v = (torch.tensor(rng.randn(2, 40, 4, 16).astype(np.float32))
               for _ in range(3))
    out, got = _credits(lambda: flash_ops.flash_attention(q, k, v))
    want = reference_attention(*(a.transpose(1, 2) for a in (q, k, v)),
                               causal=True).transpose(1, 2)
    assert got == [] and torch.equal(out, want)


class _Elsewhere(torch.Tensor):
    """A tensor that reports another device and runs no operation."""

    @staticmethod
    def __new__(cls, shape, device):
        return torch.Tensor._make_wrapper_subclass(cls, shape,
                                                   dtype=torch.float32,
                                                   device=device)

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise AssertionError(f"{func} ran on a tensor of another device")


@pytest.mark.parametrize("device", ["xpu", "hpu"])
def test_an_unsupported_device_raises(device):
    q = _Elsewhere((1, 8, 2, 16), device)
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        flash_ops.flash_attention(q, q, q)
    x = _Elsewhere((1, 1, 32, 2, 16), device)
    dt = _Elsewhere((1, 1, 32, 2), device)
    a = _Elsewhere((2,), device)
    bc = _Elsewhere((1, 1, 32, 1, 8), device)
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        ssd_ops.ssd_intra_chunk(x, dt, a, bc, bc)


def test_the_launches_take_cuda_tensors_only():
    q = torch.empty(1, 8, 2, 16, device="meta")
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        flash_ops.launch(q, q, q)
    args = [t.to("meta") for t in _ssd_inputs("cpu")]
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        ssd_ops.launch(*args)


# ---------------------------------------------------------------------------
# Counting
# ---------------------------------------------------------------------------

def test_products_bytes_views_and_peak_live_bytes():
    a = torch.empty(8, 16, device="meta")
    b = torch.empty(16, 32, device="meta")

    def fn(a, b):
        c = a @ b                          # 2 * 8 * 32 * 16 flops
        d = c.reshape(-1).view(32, 8).t()  # views: nothing moves
        e = d * 2.0                        # 256 floats written
        del c, d
        return e.sum()

    tr = OA.trace(fn, a, b)
    assert tr.flops == 2 * 8 * 32 * 16
    # mm: operands read (8*16 + 16*32) and output written (8*32); mul and
    # sum outputs; views none.
    assert tr.bytes == 4 * (8 * 16 + 16 * 32 + 8 * 32 + 8 * 32 + 1)
    # c (1 KiB) and e (1 KiB) live together at the most, then the sum.
    assert tr.peak_live_bytes == 4 * (8 * 32 + 8 * 32)


# ---------------------------------------------------------------------------
# FLOPs against the reference's analyzer
# ---------------------------------------------------------------------------

def _port_train_trace(arch, mesh=None, n_layers=None, ce_remat=True):
    cfg = get_smoke_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    model = get_model(cfg)
    mesh = mesh or make_logical_mesh((1, 1), ("data", "model"))
    rules = Rules(mesh)
    state = abstract_train_state(model)
    batch, bps = S.batch_specs(cfg, CELL, rules)
    ps = state_pspecs(model, rules)
    specs = ({"params": OA.layouts(state["params"], ps["params"], "param",
                                   model.spec()),
              "opt": OA.layouts(state["opt"], ps["opt"], "state"),
              "step": OA.layouts(state["step"], ps["step"], "state")},
             OA.layouts(batch, bps, "batch"))
    kept = T.remat
    if not ce_remat:
        T.remat = lambda policy, fn, *a: fn(*a) if fn is T._chunk_nll \
            else kept(policy, fn, *a)
    try:
        tr = OA.trace(make_train_step(model), state, batch, specs=specs,
                      grads=True)
    finally:
        T.remat = kept
    return tr, mesh


_XLA_CHILD = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import get_smoke_config
from repro.configs.base import ShapeCell
from repro.launch import specs as S
from repro.launch.hlo_analysis import analyze_hlo
from repro.models import get_model
from repro.sharding.rules import Rules, use_rules
from repro.train.train_step import (abstract_train_state, make_train_step,
                                    state_pspecs)
model = get_model(get_smoke_config(sys.argv[1]))
cell = ShapeCell("smoke_train", 32, 4, "train")
out = {}
for n, shape in ((1, (1, 1)), (4, (2, 2))):
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape), ("data", "model"))
    rules = Rules(mesh)
    sh = lambda t: jax.tree.map(lambda p: NamedSharding(mesh, p), t,
                                is_leaf=lambda x: isinstance(x, P))
    with use_rules(rules):
        state = abstract_train_state(model)
        batch, bps = S.batch_specs(model.cfg, cell, rules)
        fn = jax.jit(make_train_step(model),
                     in_shardings=(sh(state_pspecs(model, rules)), sh(bps)),
                     donate_argnums=(0,))
        out[n] = analyze_hlo(fn.lower(state, batch).compile().as_text(), n)
print("RESULT " + json.dumps(out))
"""


@functools.lru_cache(maxsize=None)
def _reference_analysis(arch: str) -> dict:
    """`analyze_hlo` of the reference's compiled smoke train step on one
    device and on a 2 x 2 mesh of 4 host devices (one subprocess: the
    device count is fixed at jax's start)."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _XLA_CHILD, arch],
                          capture_output=True, text=True, env=env,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [x for x in proc.stdout.splitlines() if x.startswith("RESULT ")]
    return {int(k): v for k, v in
            json.loads(line[0][len("RESULT "):]).items()}


@pytest.mark.parametrize("arch", ["stablelm-3b", "grok-1-314b"])
def test_train_flops_against_the_references_analyzer(arch):
    ref = _reference_analysis(arch)[1]
    want = ref["flops_per_device"]
    same, _ = _port_train_trace(arch, ce_remat=False)
    ported, _ = _port_train_trace(arch)
    print(f"{arch}: reference {want:.6g}, port {ported.flops:.6g} (ratio "
          f"{ported.flops / want:.5f}), port without the cross-entropy "
          f"recompute {same.flops:.6g}; bytes: reference "
          f"{ref['bytes_per_device']:.6g}, port {ported.bytes:.6g} (ratio "
          f"{ported.bytes / ref['bytes_per_device']:.4f}, P17)")
    assert same.flops == pytest.approx(want, rel=0.02)
    assert ported.flops / want == pytest.approx(CE_RECOMPUTE_RATIO[arch],
                                                rel=0.01)


# ---------------------------------------------------------------------------
# The five collective rules, by hand, on a 2 x 2 mesh
# ---------------------------------------------------------------------------

MESH22 = make_logical_mesh((2, 2), ("data", "model"))


def _rules(tr):
    return OA.collectives(tr, MESH22)["by_rule"]


def test_rules_1_2_3_on_a_one_layer_dense_train_step():
    """stablelm smoke, 1 layer: d 64, 4 heads of 16 (kv 4), SwiGLU 160,
    vocab 512; batch 4 x 32 sharded over data (2), weights FSDP over data
    and tensor-parallel over model (2)."""
    tr, _ = _port_train_trace("stablelm-3b", MESH22, n_layers=1)
    d, hd4, f, v = 64, 4 * 16, 160, 512
    attn, mlp, unemb = d * hd4, d * f, d * v
    # Rule 1: each matrix weight gathered in float32 over data (n 2, wire
    # 1/2 of the result, the model shard) in the forward and again in the
    # backward's recompute; the norm scales once (no cast: the layer's
    # slice is used as it is); the unembedding twice (the cross-entropy
    # chunk and its recompute); the embedding's gather is smaller than the
    # table, no use.
    rule1 = 0.5 * 4 * (2 * (4 * attn + 3 * mlp) / 2 + 3 * d
                       + 2 * unemb / 2)
    # Rule 2: every gradient reduce-scattered over data, (n-1) x its
    # float32 shard (data x model; the norm scales over data alone).
    rule2 = 4 * (unemb / 4 + 4 * attn / 4 + 3 * mlp / 4 + 3 * d / 2
                 + unemb / 4)
    # Rule 3: all-reduces over model (2 (n-1)/n = 1 x the float32 buffer
    # over the 2 batch shards): attention's wo forward and recompute, the
    # MLP's wo forward (the recompute stops before it: nothing of the
    # backward needs its output), the column-parallel input gradients of
    # wq, wk, wv, wi, wg, each [4, 32, 64]; the unembedding's input
    # gradient over its padded 512-token chunk.
    rule3 = 4 / 2 * ((2 + 1 + 5) * 4 * 32 * d + 4 * 512 * d)
    got = _rules(tr)
    assert (got["1"], got["2"], got["3"], got["4"], got["5"]) == \
        (rule1, rule2, rule3, 0.0, 0.0)


def test_rule_4_on_a_one_layer_moe_train_step():
    """grok smoke, 1 layer: 4 experts over data, top 2, capacity
    int(1.25 x 2 x 128 / 4) = 80 slots, d 64: the [4, 80, 64] bf16 tokens
    exchanged at wi and wo forward, again in the recompute, and their
    gradients backward: 6 all-to-alls over data of (n-1)/n of the buffer
    over the 2 batch shards. Expert leaves need no gradient reduction."""
    tr, _ = _port_train_trace("grok-1-314b", MESH22, n_layers=1)
    buffer = 4 * 80 * 64 * 2 / 2
    got = _rules(tr)
    assert got["4"] == 6 * 0.5 * buffer
    d, attn, kv = 64, 64 * 64, 64 * 2 * 16
    rule2 = 4 * (512 * d / 4 + (2 * attn + 2 * kv) / 4 + d * 4 / 2
                 + 3 * d / 2 + 512 * d / 4)
    assert got["2"] == rule2


def test_rule_5_and_a_decode_step():
    """stablelm smoke decode, 1 layer, bf16 weights, a [1, 4, 32, 4, 16]
    cache sharded over data (batch) and model (kv_seq): the attention
    output [4, 1, 4, 16] that contracts the cache's sequence all-reduced
    over model (rule 5); attention's and the MLP's wo outputs [4, 1, 64]
    (rule 3); each weight gathered once in bf16, the norm scales at their
    float32 casts' use (rule 1)."""
    cfg = dataclasses.replace(get_smoke_config("stablelm-3b"), n_layers=1)
    model = get_model(cfg)
    rules = Rules(MESH22)
    cell = ShapeCell("smoke_decode", 32, 4, "decode")
    spec_tree = model.spec()
    params = abstract_params(spec_tree, dtype=torch.bfloat16)
    tokens, tps = S.decode_tokens_specs(cfg, cell, rules)
    caches, cps = S.decode_cache_specs(cfg, cell, rules)
    specs = (OA.layouts(params, partition_specs(spec_tree, rules), "param",
                        spec_tree),
             OA.layouts(tokens, tps, "batch"),
             OA.layouts(caches, cps, "cache"))
    tr = OA.trace(model.decode_step, params, tokens, caches, specs=specs)
    got = _rules(tr)
    d, attn, mlp, unemb = 64, 64 * 64, 64 * 160, 64 * 512
    assert got["5"] == 4 / 2 * (4 * 1 * 4 * 16)
    assert got["3"] == 4 / 2 * (2 * 4 * 1 * d)
    assert got["1"] == 0.5 * 2 * ((4 * attn + 3 * mlp) / 2 + 3 * d
                                  + unemb / 2)
    assert got["2"] == got["4"] == 0.0


@pytest.mark.parametrize("arch", ["stablelm-3b", "grok-1-314b"])
def test_train_collectives_against_the_references_partitioner(arch):
    """The reference's smoke train step compiled on 4 host devices as a
    2 x 2 mesh with its rules and in_shardings: its `analyze_hlo` total
    against the port's rules, within [0.5, 2] (per type printed)."""
    want = _reference_analysis(arch)[4]["collectives"]
    tr, _ = _port_train_trace(arch, MESH22)
    got = OA.collectives(tr, MESH22)
    for k in OA.COLLECTIVES + ("total_wire_bytes",):
        print(f"{arch} {k:18s} port {got[k]:12.0f} reference {want[k]:12.0f}")
    ratio = got["total_wire_bytes"] / want["total_wire_bytes"]
    print(f"{arch}: port / reference total {ratio:.4f}")
    assert 0.5 <= ratio <= 2.0


@pytest.mark.parametrize("arch", ["stablelm-3b", "grok-1-314b"])
def test_meta_and_real_tensors_count_the_same_step(arch):
    """What `chip_smoke.py` phase 14 (b) checks on the card, here on CPU
    tensors at S <= flash_block_q (no kernel op: on the CPU one would run
    its plain version, counted op by op, where `meta` credits its work): a
    train step on `meta` and on zeros counts the same FLOPs, and bytes
    within 1% (the data-reading checks that `meta` skips)."""
    model = get_model(get_smoke_config(arch))
    step = make_train_step(model)
    meta = abstract_train_state(model)
    batch, _ = S.batch_specs(model.cfg, CELL, Rules(
        make_logical_mesh((1, 1), ("data", "model"))))
    on_meta = OA.trace(step, meta, batch)
    real = tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype), meta)
    real_batch = {k: torch.zeros(v.shape, dtype=v.dtype)
                  for k, v in batch.items()}
    on_cpu = OA.trace(step, real, real_batch)
    assert on_cpu.flops == on_meta.flops
    assert on_cpu.bytes == pytest.approx(on_meta.bytes, rel=0.01)



def test_a_view_the_analysis_cannot_follow_raises():
    """A parameter's layout lost through a view would drop its
    collectives silently: the trace raises instead."""
    w = torch.empty(4, 6, device="meta")
    lay = OA.Layout("param", ("model", None), ("heads", None), "/0/w")
    with pytest.raises(NotImplementedError, match="cannot follow"):
        OA.trace(lambda w: w.diagonal() * 2.0, w, specs=(lay,))
