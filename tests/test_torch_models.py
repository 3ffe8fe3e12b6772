"""The port's LLM serving slice against the JAX reference, on the CPU.

Modules (rmsnorm, rope, mlp, causal conv, mamba block, SSD decode step,
attention in its self / prefill-into-cache / decode branches) are compared
in float32: the compute dtype of both packages is patched to float32 inside
the test only (`monkeypatch` on `repro.models.layers.COMPUTE_DTYPE` and the
port's own), the JAX side run unjitted or freshly jitted after the patch.
The slice: `zamba2-smoke` and `mamba2-smoke`, the reference's weights
(`init_params` -> numpy -> `interop.params_from_numpy`), prefill then three
decode steps on both packages, logits and caches compared at 1e-4 in
float32, and at 5e-2 in relative RMS in the real bfloat16 configuration
(the reference's own bound on bf16 logits, `tests/test_models.py`, applied
to the norm: see the bf16 test for why not elementwise). Inputs are made
with numpy from a seed.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES as JARCH_NAMES
from repro.configs import get_smoke_config as jget_smoke
from repro.configs import get_config as jget_config
from repro.models import get_model as jget_model
from repro.models import layers as JL
from repro.models import ssm as JS
from repro.models.params import count_params as jcount
from repro.models.params import init_params as jinit
from repro_torch import interop
from repro_torch.configs import (ARCH_NAMES, all_configs, get_config,
                                  get_smoke_config)
from repro_torch.models import get_model
from repro_torch.models import layers as TL
from repro_torch.models import ssm as TS
from repro_torch.models.params import count_params, init_params

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["zamba2-7b", "mamba2-130m"]


@pytest.fixture
def f32(monkeypatch):
    """Both packages compute in float32 inside the test."""
    monkeypatch.setattr(JL, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(TL, "COMPUTE_DTYPE", torch.float32)


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol,
                               err_msg=what)


def _params(cfg, seed=0):
    """The reference's weights for `cfg`, as numpy and as the port's."""
    jparams = jinit(jget_model(cfg).spec(), jax.random.PRNGKey(seed))
    nparams = jax.tree.map(np.asarray, jparams)
    return jparams, interop.params_from_numpy(nparams, device="cpu")


# ---------------------------------------------------------------------------
# configs, specs, params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", JARCH_NAMES)
def test_configs_equal_the_reference(arch):
    for t, j in ((get_config(arch), jget_config(arch)),
                 (get_smoke_config(arch), jget_smoke(arch))):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.param_count() == j.param_count()


@pytest.mark.parametrize("arch", JARCH_NAMES)
@pytest.mark.parametrize("size", ["full", "smoke"])
def test_spec_trees_equal_the_reference(arch, size):
    """Same keys, shapes, axes, init kinds, scales and fan-in dims."""
    cfg = get_config(arch) if size == "full" else get_smoke_config(arch)
    jcfg = jget_config(arch) if size == "full" else jget_smoke(arch)
    tspec, jspec = get_model(cfg).spec(), jget_model(jcfg).spec()

    def walk(t, j, path):
        if isinstance(j, dict):
            assert set(t) == set(j), path
            for k in j:
                walk(t[k], j[k], path + (k,))
            return
        assert dataclasses.asdict(t) == dataclasses.asdict(j), path

    walk(tspec, jspec, ())
    assert count_params(tspec) == jcount(jspec)


def test_init_params_draws_the_reference_distributions():
    cfg = get_smoke_config("zamba2-7b")
    spec = get_model(cfg).spec()
    p = init_params(spec, torch.Generator().manual_seed(1), "cpu")
    assert torch.equal(p["groups"]["mamba"]["a_log"],
                       torch.ones_like(p["groups"]["mamba"]["a_log"]))
    assert not p["groups"]["mamba"]["conv_b"].any()
    w = p["groups"]["mamba"]["in_proj"]          # fan-in d_model = 64
    assert w.shape == (2, 2, 64, 296) and w.dtype == torch.float32
    assert abs(float(w.std()) - 1 / 8) < 0.01
    emb = p["embed"]["embedding"]                # explicit scale 0.02
    assert abs(float(emb.std()) - 0.02) < 0.002
    again = init_params(spec, torch.Generator().manual_seed(1), "cpu")
    assert torch.equal(again["shared"]["attn"]["wq"],
                       p["shared"]["attn"]["wq"])


def test_params_from_numpy_keeps_the_tree():
    cfg = jget_smoke("mamba2-130m")
    jparams, tparams = _params(cfg)
    flat_j = jax.tree_util.tree_flatten_with_path(jparams)[0]
    for path, leaf in flat_j:
        node = tparams
        for k in path:
            node = node[k.key]
        assert node.dtype == torch.float32
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


def test_unported_families_and_archs_raise():
    """Every arch of the reference and all six families resolve, in the
    reference's order; an unknown arch or family still raises."""
    assert ARCH_NAMES == JARCH_NAMES
    assert list(all_configs()) == list(ARCH_NAMES)
    families = set()
    for arch in ARCH_NAMES:
        for cfg in (get_config(arch), get_smoke_config(arch)):
            model = get_model(cfg)
            assert type(model).__name__ == type(jget_model(cfg)).__name__
            families.add(cfg.family)
    assert families == {"dense", "moe", "vlm", "ssm", "hybrid", "encdec"}
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-9")
    with pytest.raises(KeyError, match="unknown arch"):
        get_smoke_config("gpt-9")
    cfg = dataclasses.replace(get_smoke_config("zamba2-7b"), family="rnn")
    with pytest.raises(ValueError, match="unknown family"):
        get_model(cfg)


# ---------------------------------------------------------------------------
# modules, float32
# ---------------------------------------------------------------------------

def _rng(seed):
    return np.random.RandomState(seed)


def test_rmsnorm_and_rope(f32):
    rng = _rng(0)
    x = rng.randn(2, 7, 4, 16).astype(np.float32)
    scale = rng.rand(16).astype(np.float32) + 0.5
    _close(TL.rmsnorm({"scale": _t(scale)}, _t(x), 1e-5),
           JL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-5),
           1e-5)
    pos = np.tile(np.arange(7, dtype=np.int32) + 3, (2, 1))
    _close(TL.rope(_t(x), _t(pos), 10_000.0),
           JL.rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0), 1e-5)
    assert torch.equal(TL.rope(_t(x), _t(pos), 0.0), _t(x))


def test_rmsnorm_returns_the_compute_dtype():
    x = torch.randn(3, 8)
    assert TL.rmsnorm({"scale": torch.ones(8)}, x, 1e-5).dtype \
        == torch.bfloat16


@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
def test_mlp(activation, f32):
    cfg = dataclasses.replace(get_smoke_config("zamba2-7b"),
                              activation=activation)
    jcfg = dataclasses.replace(jget_smoke("zamba2-7b"),
                               activation=activation)
    jp = jinit(JL.mlp_spec(jcfg), jax.random.PRNGKey(3))
    tp = interop.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    x = _rng(1).randn(2, 5, cfg.d_model).astype(np.float32)
    _close(TL.mlp(tp, _t(x), cfg), JL.mlp(jp, jnp.asarray(x), jcfg), 1e-5)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv(with_state, f32):
    rng = _rng(2)
    xbc = rng.randn(2, 9, 12).astype(np.float32)
    w = rng.randn(4, 12).astype(np.float32)
    b = rng.randn(12).astype(np.float32)
    st = rng.randn(2, 3, 12).astype(np.float32) if with_state else None
    got = TS._causal_conv(_t(xbc), _t(w), _t(b),
                          None if st is None else _t(st))
    want = JS._causal_conv(jnp.asarray(xbc), jnp.asarray(w), jnp.asarray(b),
                           None if st is None else jnp.asarray(st))
    for u, v in zip(got, want):
        _close(u, v, 1e-5)


def test_ssd_decode_step(f32):
    rng = _rng(3)
    b, h, p, g, n = 2, 4, 8, 2, 16
    x = rng.randn(b, 1, h, p).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(b, 1, h))).astype(np.float32)
    a = -np.exp(rng.randn(h) * 0.3).astype(np.float32)
    bb, cc = (rng.randn(b, 1, g, n).astype(np.float32) for _ in range(2))
    state = rng.randn(b, h, p, n).astype(np.float32)
    got = TS.ssd_decode_step(*(_t(v) for v in (x, dt, a, bb, cc, state)))
    want = JS.ssd_decode_step(*(jnp.asarray(v) for v in
                                (x, dt, a, bb, cc, state)))
    for u, v in zip(got, want):
        _close(u, v, 1e-5)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", ["prefill", "prefill-with-state", "decode"])
def test_mamba_block(arch, mode, f32):
    cfg, jcfg = get_smoke_config(arch), jget_smoke(arch)
    jp = jinit(JS.mamba_spec(jcfg), jax.random.PRNGKey(4))
    tp = interop.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = _rng(5)
    length = 1 if mode == "decode" else 45     # ragged vs the chunk of 32
    x = rng.randn(2, length, cfg.d_model).astype(np.float32)
    s, d_inner, n_heads, conv_dim = JS._dims(jcfg)
    sst = cst = None
    if mode != "prefill":
        sst = rng.randn(2, n_heads, s.head_dim, s.d_state).astype(np.float32)
        cst = rng.randn(2, s.conv_width - 1, conv_dim).astype(np.float32)
    kw = dict(decode=mode == "decode")
    got_y, got_c = TS.mamba_block(
        tp, _t(x), cfg, ssm_state=None if sst is None else _t(sst),
        conv_state=None if cst is None else _t(cst), **kw)
    want_y, want_c = JS.mamba_block(
        jp, jnp.asarray(x), jcfg,
        ssm_state=None if sst is None else jnp.asarray(sst),
        conv_state=None if cst is None else jnp.asarray(cst), **kw)
    _close(got_y, want_y, 1e-4)
    for u, v in zip(got_c, want_c):
        _close(u, v, 1e-4)


def _attn_setup(seed=6):
    cfg, jcfg = get_smoke_config("zamba2-7b"), jget_smoke("zamba2-7b")
    jp = jinit(JL.attention_spec(jcfg), jax.random.PRNGKey(seed))
    tp = interop.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return cfg, jcfg, jp, tp


@pytest.mark.parametrize("flash", [False, True], ids=["dense", "flash"])
def test_attention_self(flash, f32):
    cfg, jcfg, jp, tp = _attn_setup()
    b, s = 2, 37
    x = _rng(7).randn(b, s, cfg.d_model).astype(np.float32)
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    got, cache = TL.attention(tp, _t(x), cfg, positions=_t(pos),
                              use_flash=flash)
    want, _ = JL.attention(jp, jnp.asarray(x), jcfg,
                           positions=jnp.asarray(pos), use_flash=flash)
    assert cache is None
    _close(got, want, 1e-5)


def test_attention_prefill_into_cache_then_decode(f32):
    """The prefill branch (flash kernel op) writes the cache; the decode
    branch appends one position and attends over it; both equal the
    reference's, caches included."""
    cfg, jcfg, jp, tp = _attn_setup()
    b, s, max_len = 2, 21, 32
    rng = _rng(8)
    x = rng.randn(b, s, cfg.d_model).astype(np.float32)
    x1 = rng.randn(b, 1, cfg.d_model).astype(np.float32)
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    tcache = TL.make_cache(cfg, b, max_len, "cpu", n_layers=1)
    tcache = TL.KVCache(tcache.k[0], tcache.v[0], tcache.length)
    jcache = JL.make_cache(jcfg, b, max_len, dtype=jnp.float32, n_layers=1)
    jcache = JL.KVCache(jcache.k[0], jcache.v[0], jcache.length)
    got, tcache = TL.attention(tp, _t(x), cfg, positions=_t(pos),
                               cache=tcache)
    want, jcache = JL.attention(jp, jnp.asarray(x), jcfg,
                                positions=jnp.asarray(pos), cache=jcache)
    _close(got, want, 1e-5)
    for name in ("k", "v", "length"):
        _close(getattr(tcache, name), getattr(jcache, name), 1e-5, name)
    pos1 = np.full((b, 1), s, np.int32)
    got, tcache = TL.attention(tp, _t(x1), cfg, positions=_t(pos1),
                               cache=tcache)
    want, jcache = JL.attention(jp, jnp.asarray(x1), jcfg,
                                positions=jnp.asarray(pos1), cache=jcache)
    _close(got, want, 1e-5)
    for name in ("k", "v", "length"):
        _close(getattr(tcache, name), getattr(jcache, name), 1e-5, name)


def test_attention_flash_path_refuses_non_index_positions():
    """The kernel masks by index: a prefill must start at an empty cache
    with positions = arange(S)."""
    cfg, _, _, tp = _attn_setup()
    b, s = 1, 9
    x = torch.randn(b, s, cfg.d_model).to(torch.bfloat16)
    pos = torch.arange(s, dtype=torch.int32)[None]
    cache = TL.make_cache(cfg, b, 16, "cpu", n_layers=1)
    cache = TL.KVCache(cache.k[0], cache.v[0], cache.length + 3)
    with pytest.raises(ValueError, match="not empty"):
        TL.attention(tp, x, cfg, positions=pos, cache=cache)
    with pytest.raises(ValueError, match="arange"):
        TL.attention(tp, x, cfg, positions=pos + 1, use_flash=True)


# ---------------------------------------------------------------------------
# the slice: prefill + decode of the two smoke models
# ---------------------------------------------------------------------------

def _leaves(tree) -> list:
    """Leaves of the port's caches (numpy) in the reference's order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def _serve(jax_side: bool, arch: str, precision: str, toks, params,
           monkeypatch, steps: int = 3):
    """Logits and cache leaves (numpy) after prefill and after each of
    `steps` decode steps of one package, fed `toks` then the given next
    tokens (`toks` [B, S + steps]: the prompt, then one token per step)."""
    monkeypatch.setattr(JL, "COMPUTE_DTYPE",
                        jnp.float32 if precision == "f32" else jnp.bfloat16)
    monkeypatch.setattr(TL, "COMPUTE_DTYPE",
                        torch.float32 if precision == "f32"
                        else torch.bfloat16)
    s, max_len = toks.shape[1] - steps, 48
    out = []
    if jax_side:
        model = jget_model(jget_smoke(arch))
        prefill = jax.jit(model.prefill, static_argnums=2)
        decode = jax.jit(model.decode_step)
        caches, logits = prefill(params[0], {"tokens": jnp.asarray(
            toks[:, :s])}, max_len)
        for i in range(steps + 1):
            out.append((np.asarray(logits, np.float32),
                        [np.asarray(x, np.float32)
                         for x in jax.tree.leaves(caches)]))
            if i < steps:
                logits, caches = decode(params[0], jnp.asarray(
                    toks[:, s + i:s + i + 1]), caches)
        return out
    model = get_model(get_smoke_config(arch))
    t = torch.tensor(toks, dtype=torch.long)
    caches, logits = model.prefill(params[1], {"tokens": t[:, :s]}, max_len)
    for i in range(steps + 1):
        assert logits.dtype == TL.COMPUTE_DTYPE
        out.append((logits.float().numpy(),
                    _leaves(interop.caches_to_numpy(caches))))
        if i < steps:
            logits, caches = model.decode_step(params[1],
                                               t[:, s + i:s + i + 1],
                                               caches)
    return out


def _tokens(cfg, b=2, s=40, steps=3):
    """A numpy-made prompt (S = 40, ragged against the chunk of 32) and
    the three decode-step tokens."""
    return _rng(9).randint(0, cfg.real_vocab, (b, s + steps)).astype(
        np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_matches_the_reference_f32(arch, monkeypatch):
    """prefill then three decode steps in float32: logits and every cache
    leaf at each step within 1e-4 of the reference."""
    cfg = get_smoke_config(arch)
    params = _params(jget_smoke(arch), seed=2)
    toks = _tokens(cfg)
    want = _serve(True, arch, "f32", toks, params, monkeypatch)
    got = _serve(False, arch, "f32", toks, params, monkeypatch)
    for step, ((tl, tc), (jl, jc)) in enumerate(zip(got, want)):
        what = f"{arch} f32 step {step}"
        assert tl.shape == (2, cfg.vocab)
        _close(tl, jl, 1e-4, what + " logits")
        assert len(tc) == len(jc)
        for i, (u, v) in enumerate(zip(tc, jc)):
            assert u.shape == v.shape, (what, i)
            _close(u, v, 1e-4, f"{what} cache leaf {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_in_bf16_matches_the_reference(arch, monkeypatch):
    """The real bfloat16 configuration, prefill then three decode steps:
    every leaf (logits, SSM and conv states, KV cache) of the port's run
    within 5e-2 of the reference's bf16 run in relative RMS,
    ||port - ref|| / ||ref||.

    Why not elementwise: two bf16 implementations round at different
    places (the reference rounds the SSD weights and the attention scores
    and probabilities to bf16 inside its jnp paths, where the port's
    kernels keep float32; XLA and PyTorch also sum matmuls in other
    orders, which flips single bf16 ulps), and the flips compound over
    the layers. On zamba2-smoke the reference's own bf16 run is up to 0.56
    (SSM states) and 0.13 (logits) from its float32 run elementwise, 2-4%
    in relative RMS, and the port's bf16 run is about as far (up to 5.5%
    on the step-3 logits); an elementwise 5e-2 does not hold between the
    two."""
    cfg = get_smoke_config(arch)
    params = _params(jget_smoke(arch), seed=2)
    toks = _tokens(cfg)
    ref = _serve(True, arch, "bf16", toks, params, monkeypatch)
    got = _serve(False, arch, "bf16", toks, params, monkeypatch)
    for step, (g, r) in enumerate(zip(got, ref)):
        assert len(g[1]) == len(r[1])
        for i, (u, v) in enumerate([(g[0], r[0])] + list(zip(g[1], r[1]))):
            assert u.shape == v.shape
            rel = np.linalg.norm(u - v) / max(np.linalg.norm(v), 1e-30)
            assert rel <= 5e-2, (f"{arch} bf16 step {step} leaf {i}", rel)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_consistent_with_prefill(arch):
    """prefill(S) equals prefill(S-1) then one decode step, within the port
    (the reference's check, `tests/test_models.py`), in bf16 at 5e-2."""
    cfg = get_smoke_config(arch)
    model = get_model(cfg)
    params = init_params(model.spec(), torch.Generator().manual_seed(0),
                         "cpu")
    toks = torch.tensor(_rng(10).randint(0, cfg.real_vocab, (2, 16)))
    _, full = model.prefill(params, {"tokens": toks}, 24)
    caches, _ = model.prefill(params, {"tokens": toks[:, :-1]}, 24)
    step, _ = model.decode_step(params, toks[:, -1:], caches)
    _close(step, full, 5e-2)


def test_llm_modules_import_and_serve_with_jax_blocked():
    """The port's LLM stack imports no JAX and no reference module: with
    both blocked it imports and serves a smoke model of every family on
    the CPU (hybrid, ssm, dense, MoE, VLM with image embeddings, encdec
    with speech frames)."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import torch\n"
        "from repro_torch import interop\n"
        "from repro_torch.configs import get_smoke_config\n"
        "from repro_torch.models import get_model\n"
        "from repro_torch.models.params import init_params\n"
        "from repro_torch.kernels.flash_attention import cases, ops\n"
        "from repro_torch.kernels.ssd_scan import cases, ops\n"
        "for arch in ('zamba2-7b', 'mamba2-130m', 'phi4-mini-3.8b',\n"
        "             'grok-1-314b', 'pixtral-12b',\n"
        "             'seamless-m4t-large-v2'):\n"
        "    cfg = get_smoke_config(arch)\n"
        "    m = get_model(cfg)\n"
        "    p = init_params(m.spec(), torch.Generator().manual_seed(0),\n"
        "                    'cpu')\n"
        "    batch = {'tokens': torch.zeros(1, 5, dtype=torch.long),\n"
        "             'image_embeds': torch.zeros(1, cfg.frontend_embeds,\n"
        "                                         cfg.d_model),\n"
        "             'frames': torch.zeros(1, 6, cfg.d_model)}\n"
        "    c, logits = m.prefill(p, batch, 5 + cfg.frontend_embeds + 3)\n"
        "    logits, c = m.decode_step(p, torch.zeros(1, 1,\n"
        "                              dtype=torch.long), c)\n"
        "    assert logits.shape == (1, cfg.vocab), arch\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
