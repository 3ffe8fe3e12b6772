"""The cases that hold the `ssd_scan` kernel against its plain version,
built in one place for every caller.

`chip_smoke.py` runs them on the card at their full size, the card tests
(`tests/test_torch_cuda.py`) too, and the CPU tests at a small size through
the plain version. Inputs are drawn from a seeded `torch.Generator` on the
device. The cases cover d_state N of 16, 64 and 128, one and two groups,
float32 and bfloat16 inputs, chunk-ragged sequence lengths (padded by the
model's `ssd_chunked`) and nonzero initial states; two of them have the
head counts and widths of zamba2-7b and mamba2-130m. The bfloat16 cases with
chunks of 64 or 128, P = 64 and N of 32-128 run the tensor-core kernel
(`ops.variant`), among them a head count per group (10) that is not a
multiple of its 8-head tiles and a chunk of 64; the rest run the SIMT
kernel.

A case is run through `models.ssm.ssd_chunked` (the kernel op on CUDA
tensors, or the plain intra-chunk version with `plain=True`) and, on its
padded chunked inputs, through the intra-chunk op alone.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan.ref import reference_intra_chunk
from repro_torch.models import ssm

# name: (B, L, H, P, G, N, chunk, dtype, initial state)
SPECS = {
    "zamba2-heads-N64-bf16": (1, 512, 112, 64, 1, 64, 128, "bf16", False),
    "mamba2-N128-bf16": (2, 512, 24, 64, 1, 128, 128, "bf16", False),
    "N16-G1-f32": (2, 256, 8, 16, 1, 16, 32, "f32", False),
    "N64-G2-f32-ragged-init": (2, 300, 8, 64, 2, 64, 128, "f32", True),
    "N128-G2-f32-init": (1, 256, 4, 32, 2, 128, 64, "f32", True),
    "N16-G2-bf16-ragged-init": (3, 77, 6, 16, 2, 16, 32, "bf16", True),
    "P128-N128-Q64-f32": (1, 128, 2, 128, 1, 128, 64, "f32", False),
    "H20-G2-N32-bf16-ragged-init": (2, 300, 20, 64, 2, 32, 128, "bf16",
                                    True),
    "Q64-N128-bf16": (2, 256, 6, 64, 1, 128, 64, "bf16", False),
}
NAMES = tuple(SPECS)
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
# Float32 outputs (y_intra, chunk states, final state): the reference's
# bound, 1e-4, and 2e-4 at Q = 128 (its bound at mamba2 widths). The
# chunked scan's y comes back in the inputs' dtype: in bfloat16 a float32
# difference of a few ulps can move it by one bfloat16 ulp (2**-8 relative),
# so y of a bfloat16 case is held to the bfloat16 bound of 3e-2.
BF16_Y_TOL = 3e-2


class Case(NamedTuple):
    name: str
    args: Tuple[torch.Tensor, ...]          # x, dt, a, b, c ([B, L, ...])
    chunk: int
    initial_state: Optional[torch.Tensor]
    tol: float                              # float32 outputs

    @property
    def y_tol(self) -> float:
        return BF16_Y_TOL if self.args[0].dtype == torch.bfloat16 \
            else self.tol


def kernel_cases(dev, small: bool = False,
                 names: Sequence[str] = NAMES) -> List[Case]:
    """The cases named in `names` on `dev`; `small` cuts B, L and H for
    runs of the plain version on the CPU."""
    out = []
    for i, name in enumerate(names):
        b, l, h, p, g, n, chunk, dt_name, init = SPECS[name]
        if small:
            b, l, h = 1, min(l, chunk + 13), min(h, 2 * g)
        gen = torch.Generator(device=dev).manual_seed(200 + i)

        def randn(*shape, scale=1.0):
            return torch.randn(shape, generator=gen, device=dev) * scale

        dtype = DTYPES[dt_name]
        x = randn(b, l, h, p, scale=0.5).to(dtype)
        dt = F.softplus(randn(b, l, h))
        a = -torch.exp(randn(h, scale=0.3))
        bb = randn(b, l, g, n, scale=0.5).to(dtype)
        cc = randn(b, l, g, n, scale=0.5).to(dtype)
        state = randn(b, h, p, n) if init else None
        tol = 2e-4 if chunk >= 128 else 1e-4
        out.append(Case(name, (x, dt, a, bb, cc), chunk, state, tol))
    return out


def chunked_inputs(case: Case) -> Tuple[torch.Tensor, ...]:
    """The intra-chunk op's inputs of a case: L padded to the chunk with
    dt = 0 (as the model pads), reshaped to [B, NC, Q, ...]."""
    x, dt, a, bb, cc = case.args
    pad = (-x.shape[1]) % case.chunk
    x, bb, cc = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, bb, cc))
    dt = F.pad(dt, (0, 0, 0, pad))
    nc = x.shape[1] // case.chunk

    def split(t):
        return t.reshape(t.shape[0], nc, case.chunk, *t.shape[2:])

    return split(x), split(dt), a, split(bb), split(cc)


def run_chunked(case: Case, plain: bool = False):
    """(y, final_state) of the model's chunked scan on the case."""
    return ssm.ssd_chunked(*case.args, case.chunk,
                           initial_state=case.initial_state,
                           intra_chunk=reference_intra_chunk if plain
                           else None)
