"""Sharded checkpointing without external dependencies (port of
`repro.checkpoint.ckpt`), in the reference's layout:

    <dir>/step_<N>/
        manifest.json            tree paths, shapes, dtypes, host count
        shard_<host>.npz         this host's arrays ("a<i>", flatten order)

Leaves are named by jax's `keystr` of their path (`['params']['embed']
['embedding']`), and trees of nested dicts flatten with their keys
sorted, as jax flattens them, so a checkpoint written by either package
restores in the other. Writes are atomic (a temporary directory,
then a rename), and `keep` garbage-collects old steps. Each process writes
its own shard file; on one host every tensor is whole, as in the
reference's single-host runs.
"""
from __future__ import annotations

import json
import shutil
import tempfile
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core.distributed import process_count, process_index
from repro_torch.models.params import tree_unflatten
from repro_torch.sharding.rules import place


def _flatten_with_paths(tree: Any, path: str = "") -> list:
    """[(keystr, leaf)] of a tree of nested dicts, in jax's flatten
    order."""
    if isinstance(tree, dict):
        return [e for k in sorted(tree)
                for e in _flatten_with_paths(tree[k], f"{path}[{k!r}]")]
    return [(path, tree)]


def save_checkpoint(tree: Any, directory: str, step: int,
                    keep: int = 3) -> str:
    """Write the tree's arrays and the manifest atomically."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:08d}"
    host = process_index()

    manifest: Dict[str, Any] = {"step": step, "entries": {},
                                "host_count": process_count()}
    arrays = {}
    for i, (path, leaf) in enumerate(_flatten_with_paths(tree)):
        arr = leaf.detach().cpu().numpy()
        key = f"a{i}"
        manifest["entries"][path] = {
            "key": key, "shape": list(arr.shape), "dtype": str(arr.dtype)}
        arrays[key] = arr

    tmp = Path(tempfile.mkdtemp(dir=directory))
    try:
        np.savez(tmp / f"shard_{host}.npz", **arrays)
        if host == 0:
            (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
    except Exception:
        shutil.rmtree(tmp, ignore_errors=True)
        raise

    # GC old steps
    steps = sorted(p for p in directory.glob("step_*"))
    for old in steps[:-keep]:
        shutil.rmtree(old, ignore_errors=True)
    return str(final)


def latest_step(directory: str) -> Optional[int]:
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = sorted(directory.glob("step_*"))
    if not steps:
        return None
    return int(steps[-1].name.split("_")[1])


def restore_checkpoint(like: Any, directory: str,
                       step: Optional[int] = None,
                       shardings: Any = None) -> Any:
    """Restore into the structure of `like` (a tree of tensors, `meta`
    ones included). Each leaf comes back with the saved dtype, on `like`'s
    device (the CPU for a `meta` leaf), or placed by the matching leaf of
    `shardings`
    (`sharding.rules.Sharding`, as `to_shardings` builds them), which
    raises for a mesh that holds no device of this process."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    d = Path(directory) / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    data = np.load(d / f"shard_{process_index()}.npz")

    flat = _flatten_with_paths(like)
    sh_flat = None if shardings is None else \
        [s for _, s in _flatten_with_paths(shardings)]
    leaves = []
    for i, (path, leaf) in enumerate(flat):
        ent = manifest["entries"][path]
        arr = data[ent["key"]]
        expect = tuple(getattr(leaf, "shape", ()))
        if tuple(arr.shape) != expect:
            raise ValueError(f"shape mismatch for {path}: "
                             f"{arr.shape} vs {expect}")
        val = torch.from_numpy(np.array(arr))
        if sh_flat is not None:
            val = place(val, sh_flat[i])
        elif leaf.device.type != "meta":
            val = val.to(leaf.device)
        leaves.append(val)
    return tree_unflatten(like, leaves)
