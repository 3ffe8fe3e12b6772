"""Wrapper of the flash-attention kernel: the model's [B, S, H, d] layout.

`flash_attention(q, k, v, causal=...)` stands in for the reference's
`repro.kernels.flash_attention.ops.flash_attention` and for the model's
`_flash_attend` on the prefill path. Given CUDA tensors it launches one
kernel of `csrc/flash_attention.cu` once, with no padding copies (the
kernels mask the ragged S edge and take head dims up to 256 unpadded; the
scale is 1/sqrt(d)); given CPU tensors it runs the plain version
(`ref.reference_attention`). `variant(dtype, d)` picks the kernel from the
dtype and head dim alone: "wgmma" (the tensor-core kernel) for bfloat16
with d a multiple of 16, "simt" for the rest. Each launch counts under the
op's name and under `flash_attention:<variant>`
(`backend.COUNTERS["variants"]`). There is no fallback: what no kernel
runs raises, and a kernel that fails to build or launch raises.

The op is a `torch.autograd.Function`: the forward is the kernel launch
(the plain version on CPU tensors); the backward is the vector-Jacobian
product of the plain version, recomputed from the saved q, k, v, counted
under `flash_attention:backward_plain` (a route, not a launch). The
reference differentiates its blockwise jnp attention the same way and has
no backward kernel.

On `meta` tensors (an analysis of the program, `launch.op_analysis`) the
forward computes nothing: it returns the kernel's output shape and dtype.
There and after each launch on the card it credits `work(...)`, the bytes
and float ops of one call, to the active analysis
(`backend.record_work`); the backward runs as aten operations everywhere.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Optional

import torch

from repro_torch import backend
from repro_torch.kernels.flash_attention.ref import reference_attention

NAME = "flash_attention"
SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
FLAGS = backend.NVCC_FLAGS_FMA + ("-I", str(backend.HOPPER_INCLUDE))
MAX_HEAD_DIM = 256
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int


def build() -> ctypes.CDLL:
    """Build (or load the cached build of) the kernel library."""
    lib = backend.build_library(NAME, SOURCE, FLAGS)
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 4 + [_I] * 6 + [ctypes.c_float, _I, _P]
        fn.restype = _I
        fn = lib.flash_attention_wgmma_launch
        fn.argtypes = [_P] * 4 + [_I] * 5 + [ctypes.c_float, _I, _P]
        fn.restype = _I
    return lib


def variant(dtype: torch.dtype, d: int) -> str:
    """The kernel that runs q, k, v of `dtype` with head dim `d` (1 to
    MAX_HEAD_DIM): "wgmma" for bfloat16 with d a multiple of 16 (the
    tensor-core kernel), "simt" for float32 and other bfloat16 head dims.
    Raises for what no kernel takes."""
    if dtype not in DTYPES:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16 "
                        f"q, k, v of one dtype, got {dtype}")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention kernel takes head dims up to "
                         f"{MAX_HEAD_DIM}, got {d}")
    return "wgmma" if dtype == torch.bfloat16 and d % 16 == 0 else "simt"


def work(b: int, s: int, h: int, d: int, in_bytes: int, causal=True,
         s_kv: Optional[int] = None) -> tuple:
    """(bytes read once + written once, flops) of one attention call of
    `s` queries over `s_kv` keys (default `s`): q, k, v read and o written
    in the inputs' type; two products of 2 d flops per (query, key) pair
    the mask keeps (query i keeps keys 0..i under causal masking)."""
    s_kv = s if s_kv is None else s_kv
    if not causal:
        pairs = s * s_kv
    elif s <= s_kv:
        pairs = s * (s + 1) // 2
    else:
        pairs = s_kv * (s_kv + 1) // 2 + (s - s_kv) * s_kv
    return 2 * b * (s + s_kv) * h * d * in_bytes, 4 * d * pairs * b * h


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    devs = {t.device for t in (q, k, v)}
    if len(devs) != 1:
        raise ValueError(f"flash_attention: q, k, v on "
                         f"{sorted(map(str, devs))}; all must be on one "
                         f"device")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q, k, v must be [B, S, H, d] with "
                         f"k and v alike, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if (q.shape[0], q.shape[2], q.shape[3]) != (k.shape[0], k.shape[2],
                                                k.shape[3]):
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} differ in batch, heads or head "
                         f"dim (repeat the kv heads first)")


def _plain(q, k, v, causal: bool) -> torch.Tensor:
    """The plain version in the model's [B, S, H, d] layout."""
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    return reference_attention(qt, kt, vt, causal=causal).transpose(1, 2)


class _FlashAttention(torch.autograd.Function):
    """The kernel forward with the plain version's vector-Jacobian
    product as its backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        if q.device.type == "cpu":
            return _plain(q, k, v, causal)
        with backend.kernel_region():
            out = torch.empty_like(q) if q.device.type == "meta" \
                else launch(q, k, v, causal=causal)
        b, s, h, d = q.shape
        backend.record_work(NAME, *work(b, s, h, d, q.element_size(),
                                        causal, k.shape[1]))
        return out

    @staticmethod
    def backward(ctx, grad):
        backend.count_variant(NAME, "backward_plain")
        inputs = [x.detach().requires_grad_() for x in ctx.saved_tensors]
        with torch.enable_grad():
            out = _plain(*inputs, ctx.causal)
            grads = torch.autograd.grad(out, inputs, grad)
        return (*grads, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q [B, Sq, H, d], k and v [B, Skv, H, d] (kv heads repeated to H) ->
    [B, Sq, H, d] in q's dtype. Causal masking compares indices (query i
    sees keys 0..i). Differentiable (see the module's docstring)."""
    _check(q, k, v)
    return _FlashAttention.apply(q, k, v, causal)


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool = True, kernel: Optional[str] = None
           ) -> torch.Tensor:
    """One kernel launch on CUDA tensors (checked, made contiguous), on the
    current stream; never synchronizes. `kernel` names the variant to run
    (default: `variant(q.dtype, d)`); the SIMT kernel takes every shape, so
    a caller may time it on the inputs of the tensor-core one."""
    _check(q, k, v)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention kernel needs CUDA tensors, got "
                           f"{q.device}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16 "
                        f"q, k, v of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    b, s_q, h, d = q.shape
    s_kv = k.shape[1]
    chosen = variant(q.dtype, d)
    kernel = chosen if kernel is None else kernel
    if kernel not in (chosen, "simt"):
        raise ValueError(f"flash_attention: the {kernel} kernel does not "
                         f"take {q.dtype} with head dim {d}")
    lib = build()
    q, k, v = (backend.contiguous_aligned(x) for x in (q, k, v))
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    scale = 1.0 / math.sqrt(d)
    if kernel == "wgmma":
        err = lib.flash_attention_wgmma_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
            s_q, s_kv, h, d, scale, int(causal), stream)
    else:
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
            s_q, s_kv, h, d, DTYPES[q.dtype], scale, int(causal), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention {kernel} kernel launch failed: "
                           f"CUDA error {err}")
    backend.count_launch(NAME, kernel)
    return out
