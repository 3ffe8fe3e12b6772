"""The port's LLM kernel ops on the CPU against the JAX reference.

On CPU tensors `repro_torch.kernels.flash_attention.ops.flash_attention`
and `repro_torch.kernels.ssd_scan.ops.ssd_intra_chunk` run their plain
versions; they are held to the reference's Pallas kernels (interpret mode,
as the reference's own tests run them on the CPU) and to its oracles, on the
same numpy-made inputs. Tolerances are the reference's own for these
kernels: flash 2e-5 in float32 and 3e-2 in bfloat16
(`tests/test_kernels.py`), SSD 1e-4, and 2e-4 at mamba2 widths
(`tests/test_kernel_model_integration.py`). The shared card cases
(`kernels/*/cases.py`) are also run here through the plain versions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jflash
from repro.kernels.flash_attention.ref import reference_attention as jref_att
from repro.kernels.ssd_scan.kernel import ssd_intra_chunk_pallas
from repro.kernels.ssd_scan.ops import ssd_chunked_pallas
from repro.kernels.ssd_scan.ref import reference_intra_chunk as jref_ssd
from repro.models import ssm as jssm
from repro_torch.kernels.flash_attention import cases as flash_cases
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import reference_attention
from repro_torch.kernels.ssd_scan import cases as ssd_cases
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import reference_intra_chunk
from repro_torch.models import ssm as tssm

DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

def _qkv(b, s, h, d, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, s, h, d).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("d", [16, 80, 112, 160, 256])
@pytest.mark.parametrize("s", [45, 64])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_matches_reference(causal, s, d, dtype):
    """The port's op ([B,S,H,d]) against the reference's oracle, and against
    its Pallas kernel wherever that kernel runs the case (its wrapper needs
    S % block_kv == 0 without causal masking)."""
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v = _qkv(2, s, 3, d, seed=s * d)
    got = flash_ops.flash_attention(
        *(torch.tensor(a).to(tdt) for a in (q, k, v)), causal=causal)
    assert got.dtype == tdt and got.shape == (2, s, 3, d)
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    want = jref_att(*(a.transpose(0, 2, 1, 3) for a in (jq, jk, jv)),
                    causal=causal).transpose(0, 2, 1, 3)
    _close(got, want, tol)
    if causal or s % 32 == 0:
        pallas = jflash(jq, jk, jv, causal=causal, block_q=32, block_kv=32,
                        interpret=True)
        _close(got, pallas, tol)


def test_flash_plain_version_is_the_port_reference():
    """On CPU tensors the op is exactly `ref.reference_attention` in the
    [B, H, S, d] layout."""
    q, k, v = (torch.tensor(a) for a in _qkv(1, 33, 2, 16, seed=3))
    got = flash_ops.flash_attention(q, k, v, causal=True)
    want = reference_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=True).transpose(1, 2)
    assert torch.equal(got, want)


def test_flash_wrapper_checks_shapes():
    q, k, v = (torch.tensor(a) for a in _qkv(1, 8, 2, 16, seed=4))
    with pytest.raises(ValueError, match="heads"):
        flash_ops.flash_attention(q, k[:, :, :1], v[:, :, :1])
    with pytest.raises(ValueError, match=r"\[B, S, H, d\]"):
        flash_ops.flash_attention(q[0], k[0], v[0])
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        flash_ops.launch(q, k, v)


@pytest.mark.parametrize("name", flash_cases.NAMES)
def test_flash_shared_cases_on_the_plain_version(name):
    """The card's kernel cases, built here on the CPU at a small size, run
    through the plain version and hold its own invariants."""
    case = flash_cases.kernel_cases("cpu", small=True, names=[name])[0]
    out = flash_ops.flash_attention(*case.args, causal=case.causal)
    assert out.shape == case.args[0].shape and out.dtype == case.args[0].dtype
    assert torch.isfinite(out.float()).all()


# ---------------------------------------------------------------------------
# SSD intra-chunk kernel and chunked scan
# ---------------------------------------------------------------------------

def _ssd(b, nc, q, h, p, g, n, seed, scale=0.5):
    """Chunked inputs: x [B,NC,Q,H,P], dt [B,NC,Q,H], a [H], b/c grouped
    [B,NC,Q,G,N]."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, nc, q, h, p).astype(np.float32) * scale
    dt = np.log1p(np.exp(rng.randn(b, nc, q, h))).astype(np.float32)
    a = -np.exp(rng.randn(h) * 0.3).astype(np.float32)
    bb = (rng.randn(b, nc, q, g, n) * scale).astype(np.float32)
    cc = (rng.randn(b, nc, q, g, n) * scale).astype(np.float32)
    return x, dt, a, bb, cc


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("n", [16, 128])
def test_ssd_intra_chunk_matches_pallas_and_oracle(n, g):
    x, dt, a, bb, cc = _ssd(2, 2, 32, 4, 8, g, n, seed=n + g)
    got_y, got_s = ssd_ops.ssd_intra_chunk(
        *(torch.tensor(t) for t in (x, dt, a, bb, cc)))
    rep = 4 // g
    jb, jc = (jnp.repeat(jnp.asarray(t), rep, axis=3) for t in (bb, cc))
    args = (jnp.asarray(x), jnp.asarray(dt), jnp.asarray(a), jb, jc)
    for want_y, want_s in (ssd_intra_chunk_pallas(*args, interpret=True),
                           jref_ssd(*args)):
        _close(got_y, want_y, 1e-4)
        _close(got_s, want_s, 1e-4)


def test_ssd_plain_version_takes_grouped_or_broadcast_b_c():
    x, dt, a, bb, cc = (torch.tensor(t) for t in
                        _ssd(1, 2, 32, 4, 8, 2, 16, seed=7))
    grouped = reference_intra_chunk(x, dt, a, bb, cc)
    broadcast = reference_intra_chunk(x, dt, a,
                                      bb.repeat_interleave(2, dim=3),
                                      cc.repeat_interleave(2, dim=3))
    for u, v in zip(grouped, broadcast):
        torch.testing.assert_close(u, v, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("g,n", [(1, 16), (2, 128)])
def test_ssd_chunked_op_matches_pallas_wrapper(g, n):
    """ops.ssd_chunked against the reference's ssd_chunked_pallas (L a
    chunk multiple), with and without an initial state."""
    b, l, h, p, chunk = 2, 64, 4, 8, 32
    x, dt, a, bb, cc = _ssd(b, 1, l, h, p, g, n, seed=11 + n)
    x, dt, bb, cc = (t[:, 0] for t in (x, dt, bb, cc))
    init = np.random.RandomState(5).randn(b, h, p, n).astype(np.float32)
    for state in (None, init):
        got = ssd_ops.ssd_chunked(
            *(torch.tensor(t) for t in (x, dt, a, bb, cc)), chunk,
            initial_state=None if state is None else torch.tensor(state))
        if state is None:
            want = ssd_chunked_pallas(*(jnp.asarray(t) for t in
                                        (x, dt, a, bb, cc)), chunk,
                                      interpret=True)
        else:
            want = jssm.ssd_chunked(*(jnp.asarray(t) for t in
                                      (x, dt, a, bb, cc)), chunk,
                                    initial_state=jnp.asarray(state))
        _close(got[0], want[0], 1e-4)
        _close(got[1], want[1], 1e-4)


@pytest.mark.parametrize("l", [45, 96])
@pytest.mark.parametrize("g,n", [(1, 16), (2, 128)])
def test_model_ssd_chunked_matches_reference(g, n, l):
    """models.ssm.ssd_chunked (pads a ragged L with dt = 0) against the
    reference's model function, with a nonzero initial state."""
    b, h, p, chunk = 2, 4, 8, 32
    x, dt, a, bb, cc = _ssd(b, 1, l, h, p, g, n, seed=l + n)
    x, dt, bb, cc = (t[:, 0] for t in (x, dt, bb, cc))
    init = np.random.RandomState(l).randn(b, h, p, n).astype(np.float32)
    got_y, got_s = tssm.ssd_chunked(
        *(torch.tensor(t) for t in (x, dt, a, bb, cc)), chunk,
        initial_state=torch.tensor(init))
    want_y, want_s = jssm.ssd_chunked(
        *(jnp.asarray(t) for t in (x, dt, a, bb, cc)), chunk,
        initial_state=jnp.asarray(init))
    assert got_y.shape == (b, l, h, p)
    _close(got_y, want_y, 1e-4)
    _close(got_s, want_s, 1e-4)


def test_ssd_at_mamba2_widths():
    """mamba2-130m block widths (24 heads x 64, d_state 128, chunk 128):
    the port's chunked scan against the reference's model function at the
    reference's own bound for these widths, 2e-4."""
    b, l, h, p, g, n, chunk = 1, 256, 24, 64, 1, 128, 128
    x, dt, a, bb, cc = _ssd(b, 1, l, h, p, g, n, seed=1, scale=0.3)
    x, dt, bb, cc = (t[:, 0] for t in (x, dt, bb, cc))
    got = tssm.ssd_chunked(*(torch.tensor(t) for t in (x, dt, a, bb, cc)),
                           chunk)
    want = jssm.ssd_chunked(*(jnp.asarray(t) for t in (x, dt, a, bb, cc)),
                            chunk)
    _close(got[0], want[0], 2e-4)
    _close(got[1], want[1], 2e-4)


def test_ssd_wrapper_checks_shapes():
    x, dt, a, bb, cc = (torch.tensor(t) for t in
                        _ssd(1, 1, 32, 4, 8, 1, 16, seed=2))
    with pytest.raises(ValueError, match="G must divide H"):
        ssd_ops.ssd_intra_chunk(x, dt, a, bb.expand(-1, -1, -1, 3, -1),
                                cc.expand(-1, -1, -1, 3, -1))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssd_ops.ssd_chunked(x[:, 0], dt[:, 0], a, bb[:, 0], cc[:, 0], 24)
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        ssd_ops.launch(x, dt, a, bb, cc)


@pytest.mark.parametrize("name", ssd_cases.NAMES)
def test_ssd_shared_cases_on_the_plain_version(name):
    """The card's kernel cases, built here on the CPU at a small size, run
    through the chunked scan and the intra-chunk op (both plain here)."""
    case = ssd_cases.kernel_cases("cpu", small=True, names=[name])[0]
    y, s = ssd_cases.run_chunked(case)
    x = case.args[0]
    assert y.shape == x.shape and y.dtype == x.dtype
    assert torch.isfinite(y.float()).all() and torch.isfinite(s).all()
    y_intra, s_chunk = ssd_ops.ssd_intra_chunk(*ssd_cases.chunked_inputs(case))
    assert y_intra.dtype == s_chunk.dtype == torch.float32
    assert y_intra.shape[1] * y_intra.shape[2] >= x.shape[1]
