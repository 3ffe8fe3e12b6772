"""The `noc_run` cases that hold the `noc_step` kernel against its plain
version, built in one place for every caller.

`chip_smoke.py` runs them on the card at its full size, the card tests
(`tests/test_torch_cuda.py`) at a small T, and the CPU tests through the
plain version. Arrivals come from the threefry twin, so a case is the same
on every device.

Cases: Fig. 13's two topologies with static masks; a padded topology with
garbage arrivals and buffers in its dead lanes; a lane dying mid-run; an
all-ones `valid_mask_t`; a ragged `t_mask`; `hex_config(2)`; and a batch of
runs of mixed T, padded with `t_mask` and dead lanes. Past the warp
kernel's 128 nodes (WIDE_NAMES, the node kernel alone): a 12 x 12 and a
16 x 16 mesh with four gateway sinks each (148 and 260 nodes).
`check_case` holds a run's output to what its case promises besides
agreeing with the plain version.
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch import random as trandom
from repro_torch.core import topology
from repro_torch.core.constants import NETWORK
from repro_torch.kernels.noc_step import ops as nops

NAMES = ("fig13-prowaves", "fig13-resipi", "padded-garbage", "lane-dies",
         "all-ones-valid_mask_t", "ragged-t_mask", "hex_config(2)",
         "batch-mixed-T")
WIDE_NAMES = ("mesh-12x12", "mesh-16x16")
PAD = 32                      # node lanes of the padded and batch cases


class Case(NamedTuple):
    name: str
    args: Tuple[torch.Tensor, ...]   # arrivals, next_mat, drain, buf
    kwargs: dict
    parts: Optional[List[Tuple[int, int, int]]]  # (g, W, T) per batch run


def kernel_cases(dev, cycles: int, fig13_cycles: Optional[int] = None,
                 names: Sequence[str] = NAMES) -> List[Case]:
    """The cases named in `names`, with T = `cycles` (Fig. 13's two at
    `fig13_cycles`, default `cycles`, from seed 5 as the figure draws)."""
    dev = torch.device(dev)
    t = cycles
    key = trandom.prng_key(21, device=dev)

    def topo(g, w, cfg=NETWORK):
        nm, drain, buf, _ = nops.build_topology(g, w, cfg)
        return [torch.as_tensor(a, device=dev) for a in (nm, drain, buf)]

    def arrivals(cfg, n, cyc, load=0.10, seed_key=key):
        return nops.residency_arrivals(seed_key[None], [load],
                                       [cfg.routers_per_chiplet], cyc, n)[0]

    def make(name) -> Case:
        if name.startswith("fig13"):
            g, w = (1, 16) if name == "fig13-prowaves" else (2, 4)
            nm, drain, buf = topo(g, w)
            arr = arrivals(NETWORK, nm.shape[0], fig13_cycles or t,
                           seed_key=trandom.prng_key(5, device=dev))
            return Case(name, (arr, nm, drain, buf),
                        {"valid_mask": torch.ones(nm.shape[0], device=dev)},
                        None)
        if name == "padded-garbage":
            nm, drain, buf, mask = (torch.as_tensor(a, device=dev) for a in
                                    nops.build_topology_padded(2, 4,
                                                               pad_to=PAD))
            buf[int(mask.sum()):] = 64.0         # dead lanes offer space
            garbage = (trandom.uniform(key, (t, PAD)) < 0.06).float() * 8
            return Case(name, (garbage, nm, drain, buf),
                        {"valid_mask": mask}, None)
        if name == "hex_config(2)":
            hexc = topology.hex_config(2)
            nm, drain, buf = topo(2, 4, hexc)
            return Case(name, (arrivals(hexc, nm.shape[0], t, 0.3), nm,
                               drain, buf), {}, None)
        if name == "batch-mixed-T":
            return _batch_case(dev, t, topo, arrivals)
        if name in WIDE_NAMES:
            radix = int(name.split("-")[1].split("x")[0])
            cfg = NETWORK.with_topology(mesh_radix=radix)
            nm, drain, buf = topo(4, 4, cfg)
            n = nm.shape[0]
            return Case(name, (arrivals(cfg, n, t, load=0.5), nm, drain,
                               buf),
                        {"valid_mask": torch.ones(n, device=dev)}, None)
        nm, drain, buf = topo(2, 4)
        n = nm.shape[0]
        args = (arrivals(NETWORK, n, t, load=0.3), nm, drain, buf)
        if name == "lane-dies":
            dies = torch.ones((t, n), device=dev)
            dies[t // 3:, 5] = 0.0
            return Case(name, args, {"valid_mask_t": dies}, None)
        if name == "all-ones-valid_mask_t":
            return Case(name, args,
                        {"valid_mask_t": torch.ones((t, n), device=dev)},
                        None)
        if name == "ragged-t_mask":
            ragged = torch.ones(t, device=dev)
            ragged[t // 4: t // 2] = 0.0
            ragged[-13:] = 0.0
            return Case(name, args, {"t_mask": ragged}, None)
        raise ValueError(f"unknown noc_step case {name!r}")

    return [make(name) for name in names]


def _batch_case(dev, t, topo, arrivals) -> Case:
    """Runs of mixed T (and g) in one call, padded to T with t_mask and to
    PAD nodes with dead lanes."""
    parts = [(1, 16, t), (2, 4, 3 * t // 4 - 5), (3, 4, 3 * t // 8 + 9),
             (4, 4, 64)]
    cols = {k: [] for k in ("arr", "nm", "drain", "buf", "mask", "tm")}
    for g, w, tc in parts:
        nm, drain, buf = topo(g, w)
        n = nm.shape[0]
        pad = PAD - n
        cols["arr"].append(F.pad(arrivals(NETWORK, n, tc, load=0.2),
                                 (0, pad, 0, t - tc)))
        cols["nm"].append(F.pad(nm, (0, pad, 0, pad)))
        cols["drain"].append(F.pad(drain, (0, pad)))
        cols["buf"].append(F.pad(buf, (0, pad)))
        cols["mask"].append(F.pad(torch.ones(n, device=dev), (0, pad)))
        cols["tm"].append((torch.arange(t, device=dev) < tc).float())
    st = {k: torch.stack(v) for k, v in cols.items()}
    return Case("batch-mixed-T", (st["arr"], st["nm"], st["drain"],
                                  st["buf"]),
                {"valid_mask": st["mask"], "t_mask": st["tm"]}, parts)


def check_case(case: Case, got, run: Callable, *, exact: bool = True
               ) -> None:
    """Raise AssertionError unless `got` (the output of `run(*case.args,
    **case.kwargs)`) keeps the case's own promise: dead lanes exactly 0; the
    dying lane empty at the end; an all-ones `valid_mask_t` equal to the
    static run; each batch run equal to its run alone. `exact` asks for
    bitwise equality (the kernel); otherwise rtol 1e-6 (the plain version,
    whose batched products may sum in another order)."""
    def same(a, b, what):
        if exact:
            ok = torch.equal(a, b)
        else:
            ok = torch.allclose(a, b, rtol=1e-6, atol=0.0)
        if not ok:
            raise AssertionError(f"noc_step {case.name}: {what}")

    if case.name == "padded-garbage":
        n_real = int(case.kwargs["valid_mask"].sum())
        if any(bool((a[n_real:] != 0).any()) for a in got):
            raise AssertionError("noc_step: a dead lane came out non-zero")
    elif case.name == "lane-dies":
        if float(got[1][5]) != 0.0:
            raise AssertionError("noc_step: the lane that died holds flits "
                                 "at the end")
    elif case.name == "all-ones-valid_mask_t":
        static = run(*case.args)
        for a, b in zip(got, static):
            same(a, b, "all-ones valid_mask_t differs from the static run")
    elif case.parts is not None:
        arr, nm, drain, buf = case.args
        for i, (g, _, tc) in enumerate(case.parts):
            n = NETWORK.routers_per_chiplet + g
            one = run(arr[i, :tc, :n], nm[i, :n, :n], drain[i, :n],
                      buf[i, :n])
            for a, b in zip(got, one):
                same(a[i, :n], b, f"batch run {i} differs from its run "
                                  f"alone")
                if bool((a[i, n:] != 0).any()):
                    raise AssertionError(f"noc_step {case.name}: run {i} "
                                         f"has a non-zero dead lane")
