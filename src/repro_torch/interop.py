"""numpy in, tensors out: carry the reference's inputs and state across.

This system has no weights. Its "parameters" are traffic traces, the
`SimState` carry and the selection tables. These helpers take numpy arrays
(for example the JAX package's outputs after `np.asarray`) and return the
port's tensors, with the dtypes the reference uses (float32 loads, int32
gateway counts, bool activity), so the parity tests hand both packages the
same inputs. The flit model's inputs (arrivals, routing matrix, drain,
buffers, masks) go across with `noc_inputs_from_numpy`. `records_to_numpy`
goes the other way for comparisons. For streaming and faults,
`session_states_from_numpy` carries a batched carry across (the
reference's `init_session_states`, or any `SimState` with leading lane
axes), `fault_frame_from_numpy` a fault frame or a stacked [K] frame, and
`key_from_jax` a jax PRNG key as a key of the threefry twin.

For the LLMs, `params_from_numpy` carries a reference parameter tree (or
train state) of any family (nested dicts of numpy arrays, with the stacked
layer axes) across as float32 tensors (int32 counters) with the same keys,
and `caches_to_numpy` brings a model's serving caches back as numpy, KV
caches as dicts: the encoder-decoder's `(KVCache, (mem_k, mem_v))` keeps
its nesting, its leaves in the reference's order.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.backend import resolve_device
from repro_torch.core.gateway_controller import ControllerState
from repro_torch.core.simulator import FAULT_KEYS, SimState
from repro_torch.models.layers import KVCache

_FLOAT_KEYS = ("ext_load", "mem_load", "int_load", "ext_frac", "t_mask",
               "dest") + FAULT_KEYS


def _tensor(a, dtype, device) -> torch.Tensor:
    # np.array copies: the tensor never aliases (possibly read-only) input.
    return torch.as_tensor(np.array(a, dtype=dtype), device=device)


def trace_from_numpy(trace: dict, device=None) -> dict:
    """A trace dict of float32 tensors on `device` (default: the card).

    Keys `ext_load`, `mem_load`, `int_load`, `ext_frac` and, when present,
    `t_mask`, `dest` and the fault keys convert; `app` and any other key
    pass through unchanged.
    """
    dev = resolve_device(device)
    out = {}
    for k, v in trace.items():
        if k in _FLOAT_KEYS:
            out[k] = _tensor(v, np.float32, dev)
        else:
            out[k] = v
    return out


def state_from_numpy(g, packets_seen, epoch, wavelengths, prev_active,
                     device=None) -> SimState:
    """A `SimState` from numpy arrays: g/wavelengths int32, packets_seen
    float32, epoch int32, prev_active bool (leading lane axes kept)."""
    dev = resolve_device(device)
    return SimState(
        ctl=ControllerState(g=_tensor(g, np.int32, dev),
                            packets_seen=_tensor(packets_seen, np.float32,
                                                 dev),
                            epoch=_tensor(epoch, np.int32, dev)),
        wavelengths=_tensor(wavelengths, np.int32, dev),
        prev_active=_tensor(prev_active, np.bool_, dev))


def session_states_from_numpy(states, device=None) -> SimState:
    """A batched `SimState` from the reference's (`init_session_states`,
    or any carry with `ctl.g`, `ctl.packets_seen`, `ctl.epoch`,
    `wavelengths` and `prev_active` holding arrays with leading lane
    axes)."""
    return state_from_numpy(np.asarray(states.ctl.g),
                            np.asarray(states.ctl.packets_seen),
                            np.asarray(states.ctl.epoch),
                            np.asarray(states.wavelengths),
                            np.asarray(states.prev_active), device=device)


def fault_frame_from_numpy(frame, device=None) -> dict:
    """A fault frame (gw_ok / stuck_on [T, C, G], drift_db [T]) or a
    stacked one with a leading [K] axis, as float32 tensors."""
    dev = resolve_device(device)
    missing = [k for k in FAULT_KEYS if k not in frame]
    if missing:
        raise ValueError(f"fault frame is missing {missing}")
    return {k: _tensor(frame[k], np.float32, dev) for k in FAULT_KEYS}


def key_from_jax(key, device=None) -> torch.Tensor:
    """A threefry-twin key from a jax PRNG key (raw uint32 [..., 2], as
    `jax.random.PRNGKey` makes it): the same two words, as int64."""
    words = np.asarray(key)
    if words.dtype != np.uint32 or words.shape[-1:] != (2,):
        raise ValueError(f"expected a raw uint32 [..., 2] key, got "
                         f"{words.dtype} {words.shape}")
    return _tensor(words, np.int64, resolve_device(device))


def tables_from_numpy(tables, device=None) -> dict:
    """Selection tables (a `SelectionTables` of either package, or a dict of
    arrays) as tensors: maps int32, hop and loss columns float32."""
    dev = resolve_device(device)
    get = (tables.get if isinstance(tables, dict)
           else lambda k: getattr(tables, k, None))
    out = {}
    for k, dt in (("src_map", np.int32), ("dst_map", np.int32),
                  ("src_hops", np.float32), ("dst_hops", np.float32),
                  ("gw_loss_db", np.float32)):
        v = get(k)
        if v is not None:
            out[k] = _tensor(v, dt, dev)
    return out


def noc_inputs_from_numpy(arrivals, next_mat, drain_rate, buf_cap, *,
                          valid_mask=None, valid_mask_t=None, t_mask=None,
                          device=None) -> dict:
    """The flit model's inputs as float32 tensors on `device` (default: the
    card), keyed as `noc_run` takes them: `noc_run(**inputs)`. Masks left
    None stay out."""
    dev = resolve_device(device)
    named = {"arrivals": arrivals, "next_mat": next_mat,
             "drain_rate": drain_rate, "buf_cap": buf_cap,
             "valid_mask": valid_mask, "valid_mask_t": valid_mask_t,
             "t_mask": t_mask}
    return {k: _tensor(v, np.float32, dev) for k, v in named.items()
            if v is not None}


def records_to_numpy(out):
    """Recursively turn every tensor of a result (dicts, lists, tuples,
    dataclasses such as SimState) into numpy arrays."""
    if isinstance(out, torch.Tensor):
        return out.detach().cpu().numpy()
    if isinstance(out, dict):
        return {k: records_to_numpy(v) for k, v in out.items()}
    if isinstance(out, (list, tuple)):
        return type(out)(records_to_numpy(v) for v in out)
    if isinstance(out, SimState):
        return {"g": records_to_numpy(out.ctl.g),
                "packets_seen": records_to_numpy(out.ctl.packets_seen),
                "epoch": records_to_numpy(out.ctl.epoch),
                "wavelengths": records_to_numpy(out.wavelengths),
                "prev_active": records_to_numpy(out.prev_active)}
    return out


def params_from_numpy(tree, device=None):
    """A reference parameter tree (for example `jax.tree.map(np.asarray,
    params)`: nested dicts of arrays, the stacked [n_groups, group_len, ...]
    and [tail, ...] leading axes as they are) as float32 tensors on `device`
    (default: the card), keys kept. A train state ({"params", "opt",
    "step"}, optimizer statistics included) goes across the same way, its
    integer leaves (the step counters) as int32."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev) for k, v in tree.items()}
    integer = np.issubdtype(np.asarray(tree).dtype, np.integer)
    return _tensor(tree, np.int32 if integer else np.float32, dev)


def caches_to_numpy(caches):
    """A model's serving caches (nested tuples of tensors, KV caches, None)
    as numpy arrays in the same nesting; a KV cache becomes the dict
    {"k", "v", "length"}, in the reference's leaf order. bfloat16 entries
    come back as float32."""
    if isinstance(caches, KVCache):
        return {"k": caches_to_numpy(caches.k),
                "v": caches_to_numpy(caches.v),
                "length": caches_to_numpy(caches.length)}
    if isinstance(caches, torch.Tensor):
        # A copy: decode steps write the KV cache in place.
        t = caches.detach().cpu()
        return np.array((t.float() if t.dtype == torch.bfloat16 else t)
                        .numpy())
    if isinstance(caches, (list, tuple)):
        return type(caches)(caches_to_numpy(c) for c in caches)
    return caches
