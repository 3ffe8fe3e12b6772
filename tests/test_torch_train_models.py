"""Training of the decoder families against the JAX reference, on the CPU:
`train_loss` and every gradient leaf of dense (stablelm-3b), MoE (grok-1,
Adafactor's family) and VLM (pixtral-12b with image embeddings) at their
smoke sizes through `jax.value_and_grad` and the port's
`train_step.value_and_grad`, with the reference's weights and a numpy-made
batch taking the flash path (`torch_train_parity.py`); and
`chunked_cross_entropy` with `real_vocab` padding and a ragged S.

Bounds: in float32 compute (both packages' COMPUTE_DTYPE float32) the loss
at 1e-5 relative and each gradient leaf at 1e-4 relative RMS (measured:
1.4e-7 / 1.3e-6 at most); the MoE stats at 1e-5. In bfloat16 the loss at
1e-2 of the reference's bf16 loss, and each leaf no further from the
float32 reference gradient than 5e-2 or the reference's own bf16 gradient
is, whichever is larger: bf16 rounding of two implementations parts them
by more than that (grok-smoke's bf16 routing flips in the reference, 29%
from its float32 gradient, the port 1.4%), so each is held to the float32
truth. A leaf whose reference gradient is (mathematically) zero is held
absolutely (`LEAF_FLOOR`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as JT
from repro_torch.models import transformer as TT
from torch_train_parity import (  # noqa: F401
    check_bf16, check_f32, one_torch_thread)

ARCHS = ["stablelm-3b", "grok-1-314b", "pixtral-12b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_the_reference_f32(arch):
    check_f32(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_the_reference_bf16(arch):
    check_bf16(arch)


@pytest.mark.parametrize("s", [700, 1024])
@pytest.mark.parametrize("real_vocab", [None, 290])
def test_chunked_cross_entropy_matches_the_reference(s, real_vocab,
                                                     monkeypatch):
    """Sums at 1e-5 and their gradients (hidden and the unembedding) at
    1e-5 relative RMS (sums over up to 1400 positions), with
    the logits past `real_vocab` masked out, a ragged S (700 = 512 + 188)
    and a loss mask; float32 compute in both packages."""
    from repro.models import layers as JL
    from repro_torch.models import layers as TL

    monkeypatch.setattr(JL, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(TL, "COMPUTE_DTYPE", torch.float32)
    rng = np.random.RandomState(s)
    hidden = rng.randn(2, s, 32).astype(np.float32)
    w = (rng.randn(32, 300) * 0.2).astype(np.float32)
    labels = rng.randint(0, real_vocab or 300, (2, s)).astype(np.int32)
    mask = (rng.rand(2, s) < 0.8).astype(np.float32)

    def jfn(h, w_):
        return JT.chunked_cross_entropy({"w": w_}, h, jnp.asarray(labels),
                                        jnp.asarray(mask),
                                        real_vocab=real_vocab)

    (jsum, jw), jvjp = jax.vjp(jfn, jnp.asarray(hidden), jnp.asarray(w))
    jgh, jgw = jvjp((jnp.float32(1.0), jnp.float32(0.0)))
    th = torch.tensor(hidden, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    tsum, tw_sum = TT.chunked_cross_entropy(
        {"w": tw}, th, torch.tensor(labels), torch.tensor(mask),
        real_vocab=real_vocab)
    tsum.backward()
    np.testing.assert_allclose(float(tsum.detach()), float(jsum), rtol=1e-5)
    assert float(tw_sum) == float(jw)
    for got, want in ((th.grad, jgh), (tw.grad, jgw)):
        want = np.asarray(want, np.float64)
        rel = np.linalg.norm(got.double().numpy() - want) \
            / np.linalg.norm(want)
        assert rel <= 1e-5, rel


def test_remat_reruns_each_layer_and_the_backward_is_the_plain_vjp(
        monkeypatch):
    """stablelm-smoke on the flash path: each layer's forward runs once
    more in the backward pass (the rematerialization), and each flash call
    has one `backward_plain` backward; nothing is rematerialized without
    grad mode."""
    from repro_torch import backend
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.models import get_model
    from repro_torch.models.params import init_params
    from repro_torch.random import prng_key
    from repro_torch.train.train_step import value_and_grad
    from torch_train_parity import configs, make_batch

    cfg, _ = configs("stablelm-3b")
    model = get_model(cfg)
    params = init_params(model.spec(), prng_key(3, device="cpu"))
    batch = {k: torch.as_tensor(v) for k, v in make_batch(cfg).items()}
    calls = []
    forward = fops._FlashAttention.forward
    monkeypatch.setattr(fops._FlashAttention, "forward", staticmethod(
        lambda *a: calls.append(1) or forward(*a)))
    backend.reset_counters()
    loss, _, grads = value_and_grad(model, params, batch)
    assert len(calls) == 2 * cfg.n_layers
    assert backend.COUNTERS["variants"] == {
        "flash_attention:backward_plain": cfg.n_layers}
    assert backend.COUNTERS["launches"] == {}
    calls.clear()
    with torch.no_grad():
        again, _ = model.train_loss(params, batch)
    assert len(calls) == cfg.n_layers and float(again) == float(loss)
    assert all(g is not None and torch.isfinite(g).all()
               for g in grads["layers"]["attn"].values())
