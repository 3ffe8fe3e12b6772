"""Faults planted under the timed path, to show that the comparison which
decides `correct` catches them. Each takes a set-up driver and patches the
program's modules where the fault would be produced; it returns a function
that takes the patch out again. Used by the tests in `perfbench/tests/`
(at small sizes on the CPU) and by `calibrate.py --fault` (at the cell's
size on the card).

- `state_unchanged`: the interval step leaves the controller's state
  where it started (every lane's gateway bounds pinned to its start),
  the flit step leaves every buffer empty;
- `half_batch`: half of the batch left out and the mean taken over the
  rest (the summaries over the first half of the intervals; the flit
  model's second half of runs never run);
- `altered_answer`: one answer altered where it is produced (an interval's
  latency record of the lanes, one archive objective, one run's
  residency);
- `placement`: two gateways of a reported placement on one router
  (co-design);
- `acceptance`: the co-design's acceptance rejects every proposal: each
  chain proposes from where it started (or from what migration gave it)
  in every generation. The reported result does not hold the
  decisions, so the comparison is not expected to catch it: it is kept
  apart (`UNCOVERED`) to show what the comparison cannot see.
"""
from __future__ import annotations

import torch

EPOCH_FAULTS = ("state_unchanged", "half_batch", "altered_answer")
FAULTS = {"sweep_batch": EPOCH_FAULTS,
          "search_codesign": EPOCH_FAULTS + ("placement",),
          "noc_run": ("state_unchanged", "half_batch", "altered_answer")}
UNCOVERED = {"search_codesign": ("acceptance",)}


def _patch(module, name: str, new):
    old = getattr(module, name)
    setattr(module, name, new)
    return lambda: setattr(module, name, old)


def plant(fault: str, drv) -> callable:
    """Plant `fault` under driver `drv`'s timed path; returns the undo."""
    from repro_torch.core import simulator as S

    kind = type(drv).__module__.rsplit(".", 1)[-1]
    if fault not in FAULTS[kind] + UNCOVERED.get(kind, ()):
        raise ValueError(f"no fault {fault!r} for {kind}")
    if kind == "noc_run":
        return _plant_noc(fault, drv)
    if fault == "acceptance":
        real = drv.P._Chains.generation

        def rejecting(chains, *a, **kw):
            parent = chains.parent
            real(chains, *a, **kw)
            chains.parent = parent
        return _patch(drv.P._Chains, "generation", rejecting)
    if fault == "state_unchanged":
        from repro_torch.kernels.epoch_step import ops

        real = ops.epoch_run

        def frozen(state, xs, sim, tables, **kw):
            knobs = dict(kw["knobs"])
            knobs["min_gateways"] = knobs["max_gateways"]
            return real(state, xs, sim, tables, **dict(kw, knobs=knobs))
        return _patch(ops, "epoch_run", frozen)
    if fault == "half_batch":
        real = S._record_sums

        def half(recs, t_mask):
            t = t_mask.shape[1] // 2
            return real({k: v[:, :t] for k, v in recs.items()},
                        t_mask[:, :t])
        return _patch(S, "_record_sums", half)
    if kind == "sweep_batch":
        real = S.sweep_batch

        def altered(*a, **kw):
            out = real(*a, **kw)
            out["records"]["latency"][:, :, 7] *= 1.5
            return out
        return _patch(drv.S, "sweep_batch", altered)
    real = drv.P.search_codesign

    def reported(*a, **kw):
        res = real(*a, **kw)
        i = int(res["archive"]["valid"].nonzero()[0][0])
        if fault == "altered_answer":
            res["archive"]["objectives"][i, 0] *= 1.01
        else:
            pos = list(res["archive"]["placements"][i])
            res["archive"]["placements"][i] = tuple([pos[0]] + pos[:-1])
        return res
    return _patch(drv.P, "search_codesign", reported)


def _plant_noc(fault: str, drv) -> callable:
    real = drv.nops.noc_run

    def broken(arrivals, *a, **kw):
        if fault == "state_unchanged":
            r = arrivals.shape[-1]
            z = torch.zeros(arrivals.shape[:-2] + (r,),
                            dtype=torch.float32, device=arrivals.device)
            return z, z.clone(), z.clone()
        if fault == "half_batch":
            h = arrivals.shape[0] // 2
            part = real(arrivals[:h], *(x[:h] for x in a),
                        **{k: v[:h] for k, v in kw.items()})
            full = []
            for p in part:
                z = torch.zeros((arrivals.shape[0],) + p.shape[1:],
                                dtype=p.dtype, device=p.device)
                z[:h] = p
                full.append(z)
            return tuple(full)
        out = real(arrivals, *a, **kw)
        out[0][5] *= 1.01
        return out
    return _patch(drv.nops, "noc_run", broken)
