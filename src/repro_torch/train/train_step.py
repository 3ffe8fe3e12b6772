"""Train step factory of the port (from `repro.train.train_step`): loss ->
gradients -> optimizer update, with gradient accumulation, bf16 compute /
float32 parameters, the non-finite guard and ReSiPI lane metering.

A train state is {"params", "opt", "step"}: nested dicts of tensors, the
reference's leaves and key paths. `state_pspecs` / `abstract_train_state`
give the matching partition specs and `meta` shapes (no allocation).

The step updates the state's tensors in place, as the reference's jitted
step donates its input buffers: each new leaf is written into the old one
as soon as the optimizer has computed it, so no second copy of the state is
held. The guard's select runs leaf by leaf on the device
(`torch.where(ok, new, old)`), with no read-back to the host.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.reconfig_runtime import collective_bytes_of
from repro_torch.models.params import (ParamSpec, abstract_params,
                                       init_params, partition_specs,
                                       tree_leaves, tree_map, tree_unflatten)
from repro_torch.train import optim


# ---------------------------------------------------------------------------
# State construction
# ---------------------------------------------------------------------------

def make_optimizer_for(cfg: ModelConfig, **overrides):
    return optim.make_optimizer(cfg.optimizer, **overrides)


def init_train_state(model, key: torch.Tensor) -> dict:
    """The reference's `init_train_state(model, key)` for a twin key
    (`random.prng_key`): the same parameters bit for bit, on the key's
    device, with a fresh optimizer state."""
    params = init_params(model.spec(), key)
    opt_init, _, _ = make_optimizer_for(model.cfg)
    return {"params": params, "opt": opt_init(params),
            "step": torch.zeros((), dtype=torch.int32, device=key.device)}


def abstract_train_state(model) -> dict:
    """The train state's shapes and dtypes as `meta` tensors."""
    params = abstract_params(model.spec())
    opt_init, _, _ = make_optimizer_for(model.cfg)
    return {"params": params, "opt": opt_init(params),
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def _opt_stat_specs(spec_tree: Any, rules, optimizer: str) -> Any:
    """Partition specs of the optimizer state, from the ParamSpecs.

    AdamW m/v mirror the parameter sharding. Adafactor row stats drop the
    last parameter axis, col stats drop the second-to-last.
    """
    if optimizer == "adamw":
        pspecs = partition_specs(spec_tree, rules)
        return {"m": pspecs, "v": pspecs, "step": ()}

    def one(s: ParamSpec):
        if optim._factored(s.shape):
            return {"row": rules.spec_for_shape(s.shape[:-1],
                                                *s.axes[:-1]),
                    "col": rules.spec_for_shape(
                        s.shape[:-2] + s.shape[-1:],
                        *(s.axes[:-2] + s.axes[-1:]))}
        return {"v": rules.spec_for_shape(s.shape, *s.axes)}

    return {"stats": tree_map(one, spec_tree), "step": ()}


def state_pspecs(model, rules) -> dict:
    spec_tree = model.spec()
    return {"params": partition_specs(spec_tree, rules),
            "opt": _opt_stat_specs(spec_tree, rules, model.cfg.optimizer),
            "step": ()}


# ---------------------------------------------------------------------------
# Gradients
# ---------------------------------------------------------------------------

def value_and_grad(model, params: Any, batch: dict
                   ) -> Tuple[torch.Tensor, dict, Any]:
    """(loss, stats, grads) of `model.train_loss(params, batch)`: the
    counterpart of `jax.value_and_grad(..., has_aux=True)`. `grads` is a
    tree like `params` with None where a leaf received no gradient (jax
    would give zeros there; `make_train_step` does), so a cut in the graph
    shows. Loss and stats come back detached."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, stats = model.train_loss(tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    stats = tree_map(lambda t: t.detach(), stats)
    return loss.detach(), stats, tree_unflatten(params, list(grads))


def _zeros_for_missing(grads: Any, params: Any) -> Any:
    return tree_map(lambda g, p: torch.zeros_like(p, dtype=torch.float32)
                    if g is None else g, grads, params)


# ---------------------------------------------------------------------------
# Step factory
# ---------------------------------------------------------------------------

def make_train_step(model, accum: int = 1,
                    opt_overrides: Optional[dict] = None,
                    guard: bool = True
                    ) -> Callable[[dict, dict], Tuple[dict, dict]]:
    """Build train_step(state, batch) -> (state, metrics).

    accum > 1 splits the batch into `accum` microbatches run in turn, their
    gradients summed and averaged (the stats are the last microbatch's).

    guard=True keeps the parameters and the optimizer state at their old
    values when the loss or the gradient norm is not finite, and reports
    `skipped` = 1 (0 otherwise), decided on the device. The state's tensors
    are updated in place (see the module's docstring); the returned state
    holds them.
    """
    cfg = model.cfg
    _, opt_update, _ = make_optimizer_for(cfg, **(opt_overrides or {}))

    def single(params, batch):
        loss, stats, grads = value_and_grad(model, params, batch)
        return loss, stats, _zeros_for_missing(grads, params)

    def accumulated(params, batch):
        size = next(iter(batch.values())).shape[0] // accum
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(params)[0].device)
        grads_sum = tree_map(lambda p: torch.zeros_like(
            p, dtype=torch.float32), params)
        for i in range(accum):
            micro = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
            loss, stats, grads = single(params, micro)
            loss_sum = loss_sum + loss
            grads_sum = tree_map(torch.add, grads_sum, grads)
            del grads
        scale = 1.0 / accum
        grads = tree_map(lambda g: g * scale, grads_sum)
        return loss_sum * scale, stats, grads

    def train_step(state, batch):
        if accum > 1:
            loss, stats, grads = accumulated(state["params"], batch)
        else:
            loss, stats, grads = single(state["params"], batch)
        gnorm = optim.global_norm(grads)
        if guard:
            ok = torch.isfinite(loss) & torch.isfinite(gnorm)

            def commit(new, old):
                return old.copy_(torch.where(ok, new, old))
        else:
            def commit(new, old):
                return old.copy_(new)
        new_params, new_opt, opt_stats = opt_update(
            grads, state["opt"], state["params"], commit=commit,
            grad_norm=gnorm)
        if guard:
            opt_stats = dict(opt_stats, skipped=(~ok).to(torch.int32))
        metrics = {"loss": loss, **opt_stats,
                   # Lane-controller metering (Eq. 5 numerator, Level 2):
                   # static DP gradient-sync traffic for this step.
                   "collective_bytes": collective_bytes_of(grads, 2)}
        for k in ("aux_loss", "drop_frac"):
            if k in stats:
                metrics[k] = stats[k]
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        return new_state, metrics

    return train_step


def batch_pspecs(cfg: ModelConfig, rules, kind: str = "train") -> dict:
    """Partition specs of a data batch dict."""
    specs = {"tokens": rules.spec("batch", None),
             "labels": rules.spec("batch", None)}
    if cfg.family == "vlm":
        specs["image_embeds"] = rules.spec("batch", None, None)
    if cfg.family == "encdec":
        specs["frames"] = rules.spec("batch", None, None)
    if kind != "train":
        specs.pop("labels")
    return specs
