"""The cases that hold the `flash_attention` kernel against its plain
version, built in one place for every caller.

`chip_smoke.py` runs them on the card at their full size, the card tests
(`tests/test_torch_cuda.py`) too, and the CPU tests at a small size through
the plain version. Inputs are drawn from a seeded `torch.Generator` on the
device, in float32, then cast. The cases cover float32 and bfloat16,
causal and not, head dims 16 to 256 (16 / 64 / 80 / 112 / 128, and past 128
160 / 192 / 200 / 240 / 256: the tensor-core kernel's four-, three- and
two-stage rings and its split P V product, the SIMT kernel's wider
instantiations), S of 1, 127, 1024, 2048 and 2049 (a causal bf16 S one past
a multiple of the 64-row query tile), and B x H from 1 to 128 (the first
case is zamba2-7b's prefill shape, the second pixtral-12b's). The bfloat16
cases run the tensor-core kernel, the float32 ones the SIMT kernel
(`ops.variant`).
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import torch

from repro_torch.kernels.flash_attention.ref import reference_attention

# name: (B, S, H, d, dtype, causal)
SPECS = {
    "zamba2-bf16-causal-d112-S2048-BH128": (4, 2048, 32, 112, "bf16", True),
    "pixtral-bf16-causal-d160-S2048-BH64": (2, 2048, 32, 160, "bf16", True),
    "f32-causal-d128-S1024-BH2": (1, 1024, 2, 128, "f32", True),
    "bf16-full-d64-S127-BH64": (4, 127, 16, 64, "bf16", False),
    "f32-full-d16-S2048-BH1": (1, 2048, 1, 16, "f32", False),
    "bf16-causal-d16-S1-BH8": (2, 1, 4, 16, "bf16", True),
    "f32-causal-d112-S127-BH6": (2, 127, 3, 112, "f32", True),
    "f32-full-d128-S1-BH3": (1, 1, 3, 128, "f32", False),
    "bf16-full-d112-S1024-BH8": (2, 1024, 4, 112, "bf16", False),
    "f32-causal-d64-S2048-BH4": (2, 2048, 2, 64, "f32", True),
    "bf16-causal-d128-S127-BH1": (1, 127, 1, 128, "bf16", True),
    "bf16-causal-d112-S2049-BH2": (1, 2049, 2, 112, "bf16", True),
    "bf16-causal-d80-S1024-BH16": (2, 1024, 8, 80, "bf16", True),
    "f32-causal-d80-S127-BH4": (2, 127, 2, 80, "f32", True),
    "f32-full-d160-S1024-BH2": (1, 1024, 2, 160, "f32", False),
    "bf16-full-d160-S127-BH4": (2, 127, 2, 160, "bf16", False),
    "bf16-causal-d192-S2049-BH2": (1, 2049, 2, 192, "bf16", True),
    "f32-causal-d200-S127-BH2": (1, 127, 2, 200, "f32", True),
    "bf16-full-d240-S1024-BH4": (1, 1024, 4, 240, "bf16", False),
    "bf16-causal-d256-S2049-BH2": (1, 2049, 2, 256, "bf16", True),
    "bf16-full-d256-S127-BH8": (2, 127, 4, 256, "bf16", False),
    "f32-causal-d256-S2048-BH2": (1, 2048, 2, 256, "f32", True),
    "f32-full-d256-S1-BH3": (1, 1, 3, 256, "f32", False),
}
NAMES = tuple(SPECS)
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
# The reference's own bounds for this kernel (tests/test_kernels.py).
TOLERANCE = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
SMALL_S = {1: 1, 127: 33, 1024: 64, 2048: 96, 2049: 97}


class Case(NamedTuple):
    name: str
    args: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]   # q, k, v
    causal: bool
    tol: float


def kernel_cases(dev, small: bool = False,
                 names: Sequence[str] = NAMES) -> List[Case]:
    """The cases named in `names` on `dev`; `small` cuts S and B x H for
    runs of the plain version on the CPU."""
    out = []
    for i, name in enumerate(names):
        b, s, h, d, dt, causal = SPECS[name]
        if small:
            b, s, h = 1, SMALL_S[s], min(h, 2)
        gen = torch.Generator(device=dev).manual_seed(100 + i)
        qkv = tuple(torch.randn((b, s, h, d), generator=gen, device=dev)
                    .to(DTYPES[dt]) for _ in range(3))
        out.append(Case(name, qkv, causal, TOLERANCE[DTYPES[dt]]))
    return out


def plain(case: Case) -> torch.Tensor:
    """The plain version of the op on the case's inputs, [B, S, H, d]."""
    q, k, v = (x.transpose(1, 2) for x in case.args)
    return reference_attention(q, k, v, causal=case.causal).transpose(1, 2)
