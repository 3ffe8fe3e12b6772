"""Elastic re-meshing (port of `repro.runtime.elastic`): resume a run on a
different device count.

Checkpoints are mesh-agnostic (whole logical arrays per entry), so scaling
after node loss or scale-up is: build the new mesh, rebuild the placements
from the same Rules, restore onto them. The batch schedule is rescaled to
keep the global batch constant (synchronous data parallelism preserved).
The production meshes are logical (`launch.mesh.make_production_mesh`), so
`restore_elastic` onto them raises where a tensor would be placed; the
same restore onto a mesh of this process's devices is
`ckpt.restore_checkpoint(like, dir, shardings=to_shardings(specs, mesh))`.
"""
from __future__ import annotations

from typing import Any, Optional

from repro_torch.checkpoint import ckpt
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.sharding.rules import Rules, to_shardings
from repro_torch.train.train_step import abstract_train_state, state_pspecs


def replan_mesh(multi_pod: bool):
    """(mesh, rules) for the surviving topology."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    return mesh, Rules(mesh)


def restore_elastic(model, directory: str, multi_pod: bool,
                    step: Optional[int] = None) -> Any:
    """Restore the train state onto the current topology's placements:
    (state, mesh, rules)."""
    mesh, rules = replan_mesh(multi_pod)
    like = abstract_train_state(model)
    shardings = to_shardings(state_pspecs(model, rules), mesh)
    return ckpt.restore_checkpoint(like, directory, step=step,
                                   shardings=shardings), mesh, rules


def rescale_batch(global_batch: int, old_dp: int, new_dp: int) -> dict:
    """Keep the global batch fixed across re-meshing: adjust per-replica
    microbatch and gradient accumulation so optimization is
    schedule-compatible after an elastic restart."""
    assert global_batch % new_dp == 0, (global_batch, new_dp)
    per_replica_old = global_batch // old_dp
    per_replica_new = global_batch // new_dp
    accum = max(1, per_replica_new // max(per_replica_old, 1))
    return {"per_replica_batch": per_replica_new,
            "grad_accum": accum,
            "note": "global batch preserved; LR schedule unchanged"}
