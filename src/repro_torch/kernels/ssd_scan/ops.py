"""Wrapper of the SSD intra-chunk kernel, and the full chunked scan on top.

`ssd_intra_chunk(x, dt, a, b_in, c_in)` is the counterpart of the
reference's `ssd_intra_chunk_pallas`: given CUDA tensors it launches one
kernel of `csrc/ssd_scan.cu` once for every (batch, chunk, head); given CPU
tensors it runs the plain version (`ref.reference_intra_chunk`). B and C come
grouped ([..., G, N], head h reading group h // (H / G)) and are never
repeated per head. `variant(dtype, q, p, n)` picks the kernel from the dtype
and shape alone: "wgmma" (the tensor-core kernel) for bfloat16 with Q of 64
or 128, P = 64 and N of 32, 64 or 128, "simt" for the rest. Each launch
counts under the op's name and under `ssd_scan:<variant>`. There is no
fallback: what no kernel runs raises, and a kernel that fails to build or
launch raises.

The intra-chunk op is a `torch.autograd.Function`: the forward is the
kernel launch (the plain version on CPU tensors); the backward is the
vector-Jacobian product of the plain version, recomputed from the saved
x, dt, a, B, C and counted under `ssd_scan:backward_plain` (a route, not a
launch). The reference differentiates its jnp scan the same way and has
no backward kernel.

`ssd_chunked(...)` is the counterpart of `ssd_chunked_pallas`
(`repro.kernels.ssd_scan.ops`): the intra-chunk op, then the inter-chunk
state recurrence and the inter-chunk output in plain PyTorch.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Callable, Optional, Tuple

import torch

from repro_torch import backend
from repro_torch.kernels.ssd_scan.ref import reference_intra_chunk

NAME = "ssd_scan"
SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu"
FLAGS = backend.NVCC_FLAGS_FMA + ("-I", str(backend.HOPPER_INCLUDE))
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE = 256, 128, 128
SMEM_LIMIT = 232448           # 227 KB of shared memory per block
# The tensor-core kernel's tiling: chunks of one or two 64-row warpgroups,
# P = 64 (the M of the state product) and N split over the warpgroups in
# wgmma widths.
WGMMA_CHUNKS, WGMMA_HEAD_DIM, WGMMA_STATES = (64, 128), 64, (32, 64, 128)

_P = ctypes.c_void_p
_I = ctypes.c_int


def build() -> ctypes.CDLL:
    """Build (or load the cached build of) the kernel library."""
    lib = backend.build_library(NAME, SOURCE, FLAGS)
    fn = lib.ssd_scan_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 7 + [_I] * 8 + [_P]
        fn.restype = _I
        fn = lib.ssd_scan_wgmma_launch
        fn.argtypes = [_P] * 7 + [_I] * 7 + [ctypes.c_longlong] * 3 + [_P]
        fn.restype = _I
        lib.ssd_scan_smem_bytes.argtypes = [_I] * 4
        lib.ssd_scan_smem_bytes.restype = ctypes.c_longlong
    return lib


def smem_bytes(kernel: str, q: int, p: int, n: int) -> int:
    """Dynamic shared memory of one block of `kernel` (the sources'
    `smem_bytes`, which `ssd_scan_smem_bytes` returns on the card)."""
    if kernel == "wgmma":        # C, B; 3 x, xw_hi, xw_lo; 3 dt, cum; y
        return (2 * q * n * 2 + 5 * q * WGMMA_HEAD_DIM * 2 + 6 * q * 4
                + q * (WGMMA_HEAD_DIM + 8) * 4)
    return 4 * (q * p + 2 * q * (n | 1) + 3 * q + 32 * q)


def variant(dtype: torch.dtype, q: int, p: int, n: int) -> str:
    """The kernel that runs x, B, C of `dtype` in chunks of `q` tokens,
    head dim `p` and state `n`: "wgmma" (the tensor-core kernel) for
    bfloat16 with q in WGMMA_CHUNKS, p == WGMMA_HEAD_DIM and n in
    WGMMA_STATES; "simt" for the rest. Raises for what no kernel takes."""
    if dtype not in DTYPES:
        raise TypeError(f"ssd_scan kernel takes float32 or bfloat16 x, b, c "
                        f"of one dtype, got {dtype}")
    if q % 32 or not 0 < q <= MAX_CHUNK or not 0 < p <= MAX_HEAD_DIM \
            or not 0 < n <= MAX_STATE:
        raise ValueError(f"ssd_scan kernel takes chunks that are multiples "
                         f"of 32 up to {MAX_CHUNK}, head dims up to "
                         f"{MAX_HEAD_DIM} and states up to {MAX_STATE}; got "
                         f"Q={q}, P={p}, N={n}")
    if dtype == torch.bfloat16 and q in WGMMA_CHUNKS \
            and p == WGMMA_HEAD_DIM and n in WGMMA_STATES:
        return "wgmma"
    if smem_bytes("simt", q, p, n) > SMEM_LIMIT:
        raise ValueError(f"ssd_scan kernel needs "
                         f"{smem_bytes('simt', q, p, n)} bytes of shared "
                         f"memory at Q={q}, P={p}, N={n}, past the "
                         f"{SMEM_LIMIT} limit")
    return "simt"


def _check(x, dt, a, b_in, c_in) -> None:
    devs = {t.device for t in (x, dt, a, b_in, c_in)}
    if len(devs) != 1:
        raise ValueError(f"ssd_scan: inputs on {sorted(map(str, devs))}; all "
                         f"must be on one device")
    if x.dim() != 5 or b_in.dim() != 5 or b_in.shape != c_in.shape:
        raise ValueError(f"ssd_scan: x must be [B, NC, Q, H, P] and b, c "
                         f"[B, NC, Q, G, N] alike, got {tuple(x.shape)}, "
                         f"{tuple(b_in.shape)}, {tuple(c_in.shape)}")
    bsz, nc, q, h, _ = x.shape
    g = b_in.shape[3]
    if tuple(dt.shape) != (bsz, nc, q, h) or tuple(a.shape) != (h,) \
            or tuple(b_in.shape[:3]) != (bsz, nc, q) or h % g:
        raise ValueError(f"ssd_scan: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, a {tuple(a.shape)}, b "
                         f"{tuple(b_in.shape)} do not match (G must divide H)")


def _token_strided(t: torch.Tensor) -> torch.Tensor:
    """`t` [B, NC, Q, A, Z] as the tensor-core kernel reads it: each token's
    [A, Z] contiguous and the tokens evenly strided (stride(2) elements
    apart, a multiple of 16 bytes, from a 16-byte aligned start); a tensor
    laid out otherwise is copied contiguous."""
    bsz, nc, q, a, z = t.shape
    st = t.stride()
    even = (st[4] == 1 and (a == 1 or st[3] == z)
            and (nc == 1 or st[1] == q * st[2])
            and (bsz == 1 or st[0] == nc * q * st[2])
            and st[2] * t.element_size() % 16 == 0
            and t.data_ptr() % 16 == 0)
    return t if even else backend.contiguous_aligned(t)


def ssd_intra_chunk(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                    b_in: torch.Tensor, c_in: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-chunk SSD compute. x [B, NC, Q, H, P], dt [B, NC, Q, H], a [H],
    b_in / c_in [B, NC, Q, G, N]. Returns (y_intra [B, NC, Q, H, P],
    s_chunk [B, NC, H, P, N]), float32; the tensor-core kernel's y_intra is
    a view of a head-major buffer (not contiguous)."""
    _check(x, dt, a, b_in, c_in)
    return _IntraChunk.apply(x, dt, a, b_in, c_in)


class _IntraChunk(torch.autograd.Function):
    """The kernel forward with the plain version's vector-Jacobian
    product as its backward."""

    @staticmethod
    def forward(ctx, x, dt, a, b_in, c_in):
        ctx.save_for_backward(x, dt, a, b_in, c_in)
        if x.device.type == "cpu":
            return reference_intra_chunk(x, dt, a, b_in, c_in)
        return launch(x, dt, a, b_in, c_in)

    @staticmethod
    def backward(ctx, grad_y, grad_s):
        backend.count_variant(NAME, "backward_plain")
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            outs = reference_intra_chunk(*inputs)
            pairs = [(o, g) for o, g in zip(outs, (grad_y, grad_s))
                     if g is not None]
            return torch.autograd.grad([o for o, _ in pairs], inputs,
                                       [g for _, g in pairs],
                                       allow_unused=True)


def launch(x, dt, a, b_in, c_in, *, kernel: Optional[str] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One kernel launch on CUDA tensors (checked; x, B and C made
    contiguous, except where the tensor-core kernel reads them in place; dt
    as float32; the cumsum of dt * a taken here), on the current stream;
    never synchronizes. `kernel` names the variant to run (default:
    `variant`);
    the SIMT kernel takes every shape that fits its shared memory, so a
    caller may time it on the inputs of the tensor-core one."""
    _check(x, dt, a, b_in, c_in)
    if x.device.type != "cuda":
        raise RuntimeError(f"ssd_scan kernel needs CUDA tensors, got "
                           f"{x.device}")
    if b_in.dtype != x.dtype or c_in.dtype != x.dtype:
        raise TypeError(f"ssd_scan kernel takes float32 or bfloat16 x, b, c "
                        f"of one dtype, got {x.dtype}, {b_in.dtype}, "
                        f"{c_in.dtype}")
    bsz, nc, q, h, p = x.shape
    g, n = b_in.shape[3], b_in.shape[4]
    chosen = variant(x.dtype, q, p, n)
    kernel = chosen if kernel is None else kernel
    if kernel not in (chosen, "simt") or smem_bytes(kernel, q, p, n) \
            > SMEM_LIMIT:
        raise ValueError(f"ssd_scan: the {kernel} kernel does not take "
                         f"{x.dtype} at Q={q}, P={p}, N={n}")
    lib = build()
    # The cumsum of dt * a, taken as the plain version takes it: in
    # another order it would move every decay weight (see the source).
    cum = torch.cumsum(dt.float() * a.float(), dim=2).contiguous()
    if kernel == "wgmma":
        # The model's x, B and C are slices of one projection: the kernel
        # reads them in place, their tokens a row of that projection apart.
        x, b_in, c_in = (_token_strided(t) for t in (x, b_in, c_in))
    else:
        x, b_in, c_in = (backend.contiguous_aligned(t)
                         for t in (x, b_in, c_in))
    dt = dt.to(torch.float32).contiguous()
    # The tensor-core kernel writes y head-major ([B, NC, H, Q, P]: each
    # head's chunk one contiguous run, where [B, NC, Q, H, P] scatters it
    # in 256-byte pieces) and returns it as a [B, NC, Q, H, P] view.
    y = torch.empty((bsz, nc, h, q, p) if kernel == "wgmma"
                    else (bsz, nc, q, h, p), dtype=torch.float32,
                    device=x.device)
    s = torch.empty((bsz, nc, h, p, n), dtype=torch.float32, device=x.device)
    ptrs = (x.data_ptr(), dt.data_ptr(), cum.data_ptr(), b_in.data_ptr(),
            c_in.data_ptr(), y.data_ptr(), s.data_ptr())
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if kernel == "wgmma":
        err = lib.ssd_scan_wgmma_launch(*ptrs, bsz, nc, q, h, p, g, n,
                                        x.stride(2), b_in.stride(2),
                                        c_in.stride(2), stream)
    else:
        err = lib.ssd_scan_launch(*ptrs, bsz, nc, q, h, p, g, n,
                                  DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan {kernel} kernel launch failed: CUDA "
                           f"error {err}")
    backend.count_launch(NAME, kernel)
    return (y.transpose(2, 3) if kernel == "wgmma" else y), s


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b_in: torch.Tensor, c_in: torch.Tensor, chunk: int,
                initial_state: Optional[torch.Tensor] = None, *,
                intra_chunk: Optional[Callable] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan, L a multiple of `chunk` (the model's `ssd_chunked`
    pads). x [B, L, H, P], dt [B, L, H], a [H], b_in / c_in [B, L, G, N],
    initial_state [B, H, P, N] or None. Returns (y [B, L, H, P] in x's
    dtype, final_state [B, H, P, N] float32).

    `intra_chunk` replaces the intra-chunk op (default `ssd_intra_chunk`),
    for example with the plain version on CUDA tensors to compare."""
    bsz, l, h, p = x.shape
    g, n = b_in.shape[2], b_in.shape[3]
    if l % chunk:
        raise ValueError(f"ssd_chunked: L={l} is not a multiple of the chunk "
                         f"{chunk}")
    nc = l // chunk
    rep = h // g
    xr = x.reshape(bsz, nc, chunk, h, p)
    dtr = dt.reshape(bsz, nc, chunk, h)
    br = b_in.reshape(bsz, nc, chunk, g, n)
    cr = c_in.reshape(bsz, nc, chunk, g, n)

    intra = ssd_intra_chunk if intra_chunk is None else intra_chunk
    y_intra, s_chunk = intra(xr, dtr, a, br, cr)

    cum = torch.cumsum(dtr.float() * a.float(), dim=2)        # [B,NC,Q,H]
    total_decay = torch.exp(cum[:, :, -1, :])                  # [B,NC,H]
    state = (torch.zeros((bsz, h, p, n), dtype=torch.float32,
                         device=x.device)
             if initial_state is None else initial_state.float())
    states_in = []
    for c in range(nc):
        states_in.append(state)                                # entering
        state = state * total_decay[:, c, :, None, None] + s_chunk[:, c]
    states = torch.stack(states_in, dim=1).reshape(bsz, nc, g, rep, p, n)
    y_inter = torch.einsum("bcqgn,bcgrpn->bcqgrp", cr.float(), states)
    y_inter = y_inter.reshape(bsz, nc, chunk, h, p) * torch.exp(cum)[..., None]
    # In place into the contiguous y_inter: y_intra may be a strided view.
    y = y_inter.add_(y_intra).reshape(bsz, l, h, p).to(x.dtype)
    return y, state
