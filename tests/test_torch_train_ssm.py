"""Training of the SSM, hybrid and encoder-decoder families against the JAX
reference, on the CPU (mamba2-130m, zamba2-7b, seamless-m4t-large-v2 at
their smoke sizes; bounds and harness as in `test_torch_train_models.py`),
and the two kernel ops under autograd: their backward is the plain
version's vector-Jacobian product, counted under `<op>:backward_plain`.
"""
import pytest
import torch

from repro_torch import backend
from repro_torch.kernels.flash_attention import cases as flash_cases
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.ssd_scan import cases as ssd_cases
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import reference_intra_chunk
from torch_train_parity import (  # noqa: F401
    check_bf16, check_f32, one_torch_thread)

ARCHS = ["mamba2-130m", "zamba2-7b", "seamless-m4t-large-v2"]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_the_reference_f32(arch):
    check_f32(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_the_reference_bf16(arch):
    check_bf16(arch)


def _grads(fn, inputs, cotangents):
    leaves = [x.detach().clone().requires_grad_() for x in inputs]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    torch.autograd.backward(outs, cotangents)
    return outs, [x.grad for x in leaves]


@pytest.mark.parametrize("case", ["f32-causal-d112-S127-BH6",
                                  "bf16-full-d64-S127-BH64",
                                  "f32-full-d160-S1024-BH2"])
def test_flash_op_backward_is_the_plain_vjp(case):
    """The op's output and its q, k, v gradients equal plain autograd
    through `reference_attention` bit for bit on CPU tensors (one
    `backward_plain` route, no kernel launch)."""
    c = flash_cases.kernel_cases("cpu", small=True, names=[case])[0]
    gen = torch.Generator().manual_seed(5)
    cot = torch.randn(c.args[0].shape, generator=gen).to(c.args[0].dtype)
    backend.reset_counters()
    got, got_g = _grads(lambda q, k, v: flash_ops.flash_attention(
        q, k, v, causal=c.causal), c.args, [cot])
    assert backend.COUNTERS["variants"] == {
        "flash_attention:backward_plain": 1}
    assert backend.COUNTERS["launches"] == {}
    want, want_g = _grads(lambda q, k, v: flash_ops._plain(q, k, v,
                                                           c.causal),
                          c.args, [cot])
    assert torch.equal(got[0], want[0])
    for a, b in zip(got_g, want_g):
        assert a.dtype == c.args[0].dtype and torch.equal(a, b)


@pytest.mark.parametrize("case", ["N16-G1-f32", "H20-G2-N32-bf16-ragged-init"])
def test_ssd_op_backward_is_the_plain_vjp(case):
    """The intra-chunk op's outputs and the gradients of x, dt, a, B and C
    equal plain autograd through `reference_intra_chunk` bit for bit on CPU
    tensors, for cotangents on both outputs and on y alone."""
    c = ssd_cases.kernel_cases("cpu", small=True, names=[case])[0]
    inputs = ssd_cases.chunked_inputs(c)
    gen = torch.Generator().manual_seed(6)
    shapes = [o.shape for o in reference_intra_chunk(*inputs)]
    for cots in ([torch.randn(s, generator=gen) for s in shapes],
                 [torch.randn(shapes[0], generator=gen), None]):
        backend.reset_counters()
        got, got_g = _grads(lambda *t: ssd_ops.ssd_intra_chunk(*t)[:len(
            [c for c in cots if c is not None])], inputs,
            [t for t in cots if t is not None])
        assert backend.COUNTERS["variants"] == {"ssd_scan:backward_plain": 1}
        want, want_g = _grads(lambda *t: reference_intra_chunk(*t)[:len(
            [c for c in cots if c is not None])], inputs,
            [t for t in cots if t is not None])
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        for x, a, b in zip(inputs, got_g, want_g):
            assert a.dtype == x.dtype and torch.equal(a, b)


@pytest.mark.parametrize("case", ["N64-G2-f32-ragged-init",
                                  "H20-G2-N32-bf16-ragged-init"])
def test_ssd_chunked_gradients_through_the_op(case):
    """`ssd_chunked` (the op, then the inter-chunk recurrence)
    differentiated through the op: its output bit for bit, and its
    gradients at 1e-6 relative RMS (1e-2 for bfloat16 inputs: one bf16 ulp)
    of the same scan with the plain intra-chunk version swapped in; the
    two sum a gradient's parts in another order."""
    c = ssd_cases.kernel_cases("cpu", small=True, names=[case])[0]
    x, dt, a, bb, cc = (t.reshape((t.shape[0], -1) + t.shape[3:])
                        if t.dim() > 1 else t
                        for t in ssd_cases.chunked_inputs(c))
    gen = torch.Generator().manual_seed(8)
    cot = torch.randn(x.shape, generator=gen).to(x.dtype)

    def run(intra):
        return _grads(lambda *t: ssd_ops.ssd_chunked(
            *t, c.chunk, intra_chunk=intra)[0], (x, dt, a, bb, cc), [cot])

    backend.reset_counters()
    got, got_g = run(None)
    assert backend.COUNTERS["variants"] == {"ssd_scan:backward_plain": 1}
    want, want_g = run(reference_intra_chunk)
    assert torch.equal(got[0], want[0])
    for t, u, w in zip((x, dt, a, bb, cc), got_g, want_g):
        tol = 1e-2 if t.dtype == torch.bfloat16 else 1e-6
        u, w = u.double(), w.double()
        assert float((u - w).norm() / w.norm()) <= tol
