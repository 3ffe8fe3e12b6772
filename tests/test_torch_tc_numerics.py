"""The tensor-core kernels' numerics and kernel choice, on the CPU.

The bf16 path of `flash_attention` and `ssd_scan` runs on Hopper's tensor
cores (`wgmma`, bf16 x bf16 products summed in float32). Their arithmetic
differs from the plain versions in two places, emulated here in plain
torch on the shared cases of `kernels/*/cases.py` (small size):

- SSD: the float32 factors of the two products are split into bf16 terms,
  W = W_hi + W_mid + W_lo for y = W x and xw = xw_hi + xw_lo for the chunk
  states (x and B are exact in bf16). The emulation meets the float32
  bounds (1e-4, 2e-4 at chunk 128); with one bf16 term, or W rounded to
  TF32's 10 stored mantissa bits, it misses them, which is why the split.
- flash: the online softmax's p is rounded to bf16 before P V, tile by
  tile as the kernel does it; the result stays within the bf16 bound of
  3e-2 of `reference_attention`.

Also here: the pure functions that choose the kernel (`ops.variant`) and
the build cache key (`backend.build_key`), which must change when a header
the kernel includes changes.
"""
import math
import shutil

import pytest
import torch

from repro_torch import backend
from repro_torch.kernels.flash_attention import cases as flash_cases
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import (NEG_INF,
                                                     reference_attention)
from repro_torch.kernels.ssd_scan import cases as ssd_cases
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import reference_intra_chunk

SSD_BF16 = [n for n in ssd_cases.NAMES if ssd_cases.SPECS[n][7] == "bf16"]
FLASH_BF16 = [n for n in flash_cases.NAMES
              if flash_cases.SPECS[n][4] == "bf16"]
KEY_TILE = 64                     # keys per tile of the flash wgmma kernel


# ---------------------------------------------------------------------------
# Kernel choice
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [8, 16, 20, 64, 100, 112, 128, 144, 160, 200,
                               240, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_variant(dtype, d):
    want = "wgmma" if dtype == torch.bfloat16 and d % 16 == 0 else "simt"
    assert flash_ops.variant(dtype, d) == want


def test_flash_variant_refuses_what_no_kernel_takes():
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_ops.variant(torch.float16, 64)
    for d in (0, 257, 272, 512):
        with pytest.raises(ValueError, match="up to 256"):
            flash_ops.variant(torch.bfloat16, d)


@pytest.mark.parametrize("n", [16, 32, 64, 128])
@pytest.mark.parametrize("p", [16, 64, 128])
@pytest.mark.parametrize("q", [32, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_variant(dtype, q, p, n):
    """bf16 with Q 64 / 128, P 64 and N 32-128 runs the tensor-core kernel;
    every other shape the SIMT kernel, when its shared memory fits."""
    tc = dtype == torch.bfloat16 and q in (64, 128) and p == 64 \
        and n in (32, 64, 128)
    if tc:
        assert ssd_ops.variant(dtype, q, p, n) == "wgmma"
        assert ssd_ops.smem_bytes("wgmma", q, p, n) <= ssd_ops.SMEM_LIMIT
    elif ssd_ops.smem_bytes("simt", q, p, n) <= ssd_ops.SMEM_LIMIT:
        assert ssd_ops.variant(dtype, q, p, n) == "simt"
    else:
        with pytest.raises(ValueError, match="shared memory"):
            ssd_ops.variant(dtype, q, p, n)


def test_ssd_variant_refuses_what_no_kernel_takes():
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ssd_ops.variant(torch.float16, 128, 64, 64)
    for q, p, n in ((16, 64, 64), (96 + 8, 64, 64), (288, 64, 64),
                    (128, 136, 64), (128, 64, 160), (128, 0, 64)):
        with pytest.raises(ValueError, match="multiples of 32"):
            ssd_ops.variant(torch.bfloat16, q, p, n)
    # Q 256, P = N = 128: x, B, C and the weight scratch need 428 KB.
    with pytest.raises(ValueError, match="shared memory"):
        ssd_ops.variant(torch.float32, 256, 128, 128)


def test_the_cases_reach_both_kernels():
    """The shared card cases run each kernel: all bf16 flash cases the
    tensor-core one, among them a causal S one past a query tile; the bf16
    SSD cases with chunks of 64 and 128 and 10 heads a group the
    tensor-core one, a bf16 chunk of 32 the SIMT one."""
    flash = {n: flash_ops.variant(flash_cases.DTYPES[s[4]], s[3])
             for n, s in flash_cases.SPECS.items()}
    assert {flash[n] for n in FLASH_BF16} == {"wgmma"}
    assert set(flash.values()) == {"wgmma", "simt"}
    assert any(s[1] % 64 and s[5] for n, s in flash_cases.SPECS.items()
               if n in FLASH_BF16)
    ssd = {n: ssd_ops.variant(ssd_cases.DTYPES[s[7]], s[6], s[3], s[5])
           for n, s in ssd_cases.SPECS.items()}
    tc = [ssd_cases.SPECS[n] for n, v in ssd.items() if v == "wgmma"]
    assert {s[6] for s in tc} == {64, 128}
    assert any((s[2] // s[4]) % 8 for s in tc)
    assert "simt" in {ssd[n] for n in SSD_BF16}


def test_ssd_reads_the_models_projection_slices_in_place():
    """The Mamba2 block cuts x, B and C from one projection: the tensor-core
    kernel reads such slices in place (tokens one projection row apart);
    a tensor whose tokens are not evenly strided, or not 16-byte aligned,
    is copied contiguous first."""
    proj = torch.zeros((2, 256, 64 * 10 + 2 * 64 + 8), dtype=torch.bfloat16)
    xs, bs, cs, _ = torch.split(proj, [640, 64, 64, 8], dim=-1)
    x = xs.reshape(2, 2, 128, 10, 64)
    bb = bs.reshape(2, 2, 128, 1, 64)
    assert ssd_ops._token_strided(x) is x
    assert ssd_ops._token_strided(bb) is bb
    assert x.stride(2) == bb.stride(2) == proj.shape[-1]
    odd = torch.zeros((2, 256, 641), dtype=torch.bfloat16)[..., :640]
    y = ssd_ops._token_strided(odd.reshape(2, 2, 128, 10, 64))
    assert y.is_contiguous() and torch.equal(y, odd.reshape(2, 2, 128, 10, 64))
    swapped = x.transpose(3, 4)
    assert ssd_ops._token_strided(swapped).is_contiguous()


# ---------------------------------------------------------------------------
# SSD: the split-bf16 products
# ---------------------------------------------------------------------------

def _terms(t: torch.Tensor, n: int):
    """`t` (float32) as n bf16 terms, hi first: each term rounds what the
    ones before it left over."""
    out, rest = [], t
    for _ in range(n):
        term = rest.to(torch.bfloat16).float()
        out.append(term)
        rest = rest - term
    return out


def _tf32(t: torch.Tensor):
    """`t` rounded to TF32 (10 stored mantissa bits, nearest even)."""
    bits = t.view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return [bits.view(torch.float32)]


def _ssd_emulated(x, dt, a, b_in, c_in, w_terms, xw_terms):
    """The intra-chunk op as the tensor-core kernel computes it: W and xw in
    float32 as the plain version forms them, each split by `w_terms` /
    `xw_terms` (a function of a tensor returning its terms), every product
    of a term with x or B summed in float32."""
    bsz, nc, q, h, p = x.shape
    g, n = b_in.shape[3], b_in.shape[4]
    rep = h // g
    dtf = dt.float()
    cum = torch.cumsum(dtf * a.float(), dim=2)
    seg = torch.clamp_max(cum[:, :, :, None, :] - cum[:, :, None, :, :], 0.0)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool))
    decay = torch.where(tri[None, None, :, :, None], torch.exp(seg),
                        torch.zeros(()))
    scores = torch.einsum("bcqgn,bckgn->bcqkg", c_in.float(), b_in.float())
    w = scores.repeat_interleave(rep, dim=4) * decay * dtf[:, :, None]
    xf = x.float()
    y = sum(torch.einsum("bcqkh,bckhp->bcqhp", t, xf) for t in w_terms(w))
    xw = torch.exp(cum[:, :, -1:, :] - cum)[..., None] * dtf[..., None] * xf
    bh = b_in.float().repeat_interleave(rep, dim=3)            # [B,NC,Q,H,N]
    s = sum(torch.einsum("bcqhp,bcqhn->bchpn", t, bh) for t in xw_terms(xw))
    return y, s


def _kernel_split(w):
    return _terms(w, 3)


def _state_split(xw):
    return _terms(xw, 2)


@pytest.mark.parametrize("name", SSD_BF16)
def test_ssd_split_bf16_meets_the_float32_bounds(name):
    case = ssd_cases.kernel_cases("cpu", small=True, names=[name])[0]
    inputs = ssd_cases.chunked_inputs(case)
    want = reference_intra_chunk(*inputs)
    got = _ssd_emulated(*inputs, _kernel_split, _state_split)
    for u, v in zip(got, want):
        torch.testing.assert_close(u, v, rtol=case.tol, atol=case.tol)


@pytest.mark.parametrize("name", SSD_BF16)
def test_ssd_one_bf16_term_or_tf32_misses_the_bounds(name):
    """One bf16 term (2^-8 relative a weight) or TF32 rounding (2^-11)
    misses the float32 bound of y, so the kernel splits W; a second term
    for the states alone would not rescue y."""
    case = ssd_cases.kernel_cases("cpu", small=True, names=[name])[0]
    inputs = ssd_cases.chunked_inputs(case)
    want_y, _ = reference_intra_chunk(*inputs)
    for w_terms in (lambda w: _terms(w, 1), _tf32):
        y, _ = _ssd_emulated(*inputs, w_terms, _state_split)
        assert not torch.allclose(y, want_y, rtol=case.tol, atol=case.tol)


def test_ssd_split_errors_shrink_term_by_term():
    """Max abs error of y against the plain version at mamba2's widths (one
    chunk of 128, N 128): each bf16 term gains about 2^8."""
    case = ssd_cases.kernel_cases("cpu", small=True,
                                  names=["mamba2-N128-bf16"])[0]
    inputs = ssd_cases.chunked_inputs(case)
    want_y, _ = reference_intra_chunk(*inputs)
    errs = [float((_ssd_emulated(*inputs, lambda w: _terms(w, n),
                                 _state_split)[0] - want_y).abs().max())
            for n in (1, 2, 3)]
    assert errs[0] > 1e-3 > 16 * errs[1] and errs[1] > 16 * errs[2]


# ---------------------------------------------------------------------------
# flash: p rounded to bf16 before P V
# ---------------------------------------------------------------------------

def _flash_emulated(q, k, v, causal, round_p=True):
    """[B, S, H, d] attention as the wgmma kernel computes it: scores in
    float32, online softmax over 64-key tiles (masked at -1e30, tiles above
    the diagonal skipped), p summed in float32 into l but rounded to bf16
    for P V (`round_p`), output acc / max(l, 1e-30) in q's dtype."""
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))
    s_q, s_kv, d = qf.shape[2], kf.shape[2], qf.shape[3]
    m = torch.full(qf.shape[:3] + (1,), NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    rows = torch.arange(s_q)[:, None]
    for k0 in range(0, s_kv, KEY_TILE):
        if causal and k0 > s_q - 1:
            break
        kt, vt = kf[:, :, k0:k0 + KEY_TILE], vf[:, :, k0:k0 + KEY_TILE]
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kt) / math.sqrt(d)
        if causal:
            cols = torch.arange(k0, k0 + kt.shape[2])[None, :]
            s = torch.where(cols <= rows, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        if round_p:
            p = p.to(torch.bfloat16).float()
        acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p, vt)
        m = m_new
    return (acc / l.clamp(min=1e-30)).transpose(1, 2).to(q.dtype)


@pytest.mark.parametrize("name", FLASH_BF16)
def test_flash_bf16_p_meets_the_bf16_bound(name):
    case = flash_cases.kernel_cases("cpu", small=True, names=[name])[0]
    got = _flash_emulated(*case.args, case.causal)
    want = flash_cases.plain(case)
    assert got.dtype == want.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=case.tol,
                               atol=case.tol)


def test_flash_emulation_is_the_plain_version_without_rounding():
    """The tile walk itself is exact up to float32 noise: with p kept in
    float32 it equals `reference_attention` at the float32 bound."""
    case = flash_cases.kernel_cases(
        "cpu", small=True, names=["bf16-causal-d112-S2049-BH2"])[0]
    q, k, v = (t.float() for t in case.args)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    want = reference_attention(qt, kt, vt, causal=True).transpose(1, 2)
    got = _flash_emulated(q, k, v, True, round_p=False)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# The build cache key
# ---------------------------------------------------------------------------

def test_build_key_covers_every_header_the_kernel_includes(tmp_path):
    """Editing the kernel's own header, a header in a `-I` directory or the
    flags changes the key; a file nvcc never reads does not."""
    csrc, inc = tmp_path / "csrc", tmp_path / "include"
    csrc.mkdir()
    shutil.copytree(backend.HOPPER_INCLUDE, inc)
    source = csrc / "kernel.cu"
    source.write_text('#include "local.cuh"\n#include "wgmma.cuh"\n')
    (csrc / "local.cuh").write_text("// v1\n")
    flags = backend.NVCC_FLAGS_FMA + ("-I", str(inc))
    key = backend.build_key(source, flags)
    assert key == backend.build_key(source, flags)
    (csrc / "notes.txt").write_text("not a source")
    assert backend.build_key(source, flags) == key
    (csrc / "local.cuh").write_text("// v2\n")
    key2 = backend.build_key(source, flags)
    assert key2 != key
    with open(inc / "wgmma.cuh", "a") as f:
        f.write("// edited\n")
    key3 = backend.build_key(source, flags)
    assert key3 != key2
    assert backend.build_key(source, flags + ("-lcuda",)) != key3


def test_link_flags_follow_the_source():
    cmd = backend.nvcc_command("nvcc", backend.HOPPER_INCLUDE / "x.cu",
                               ("-O3", "-lcuda", "-L/opt/lib", "-shared"),
                               "out.so")
    src = cmd.index(str(backend.HOPPER_INCLUDE / "x.cu"))
    assert cmd[src + 1:] == ["-lcuda", "-L/opt/lib"]
    assert cmd[1:src] == ["-O3", "-shared", "-o", "out.so"]


def test_both_llm_kernels_build_with_the_shared_headers():
    for ops in (flash_ops, ssd_ops):
        i = ops.FLAGS.index("-I")
        assert ops.FLAGS[i + 1] == str(backend.HOPPER_INCLUDE)
        assert (backend.HOPPER_INCLUDE / "wgmma.cuh").is_file()
