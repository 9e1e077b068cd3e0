"""Checkpointing: flatten a tree of tensors to path-keyed .npz shards
plus a JSON manifest, with crash-safe (stage-then-rename) saves.

Port of ``src/repro/checkpoint/store.py``.  A tree is nested dicts,
lists, tuples and NamedTuples whose leaves are tensors, numpy arrays or
Python scalars (``None`` is an empty node).  Leaf paths are the
reference's: dict keys in sorted order, list and tuple entries by
index, a NamedTuple field as ``.name``, joined by ``/``.  Restore
rebuilds the template's structure, NamedTuple classes included, and
puts each leaf in the template leaf's dtype and on its device.

Layout:
    <dir>/step_000000100/
        manifest.json         # step, leaf index, structure, leaf dtypes
        shard_00000.npz       # leaf arrays a0, a1, ... (chunked ≤
                              # ``shard_bytes``)

The manifest is JSON where the reference writes msgpack (the machine
with the card has no msgpack).  ``bfloat16`` has no numpy dtype: such a
leaf is stored as its uint16 bits, and the manifest names its dtype.
"""
from __future__ import annotations

import json
import os
import re
import shutil

import numpy as np
import torch

MANIFEST = "manifest.json"


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node):
    """(path part, child) pairs of an inner node, or None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(node)]
    return None


def _flatten_with_paths(tree, prefix=()):
    """[(path, leaf)] in the reference's order."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [("/".join(prefix), tree)]
    return [pl for part, child in kids
            for pl in _flatten_with_paths(child, prefix + (part,))]


def _structure(tree) -> str:
    """A readable description of the tree's structure (leaves as ``*``)."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if _is_namedtuple(tree):
        return (type(tree).__name__ + "(" + ", ".join(
            f"{f}={_structure(getattr(tree, f))}" for f in tree._fields)
            + ")")
    if isinstance(tree, list):
        return "[" + ", ".join(_structure(c) for c in tree) + "]"
    if isinstance(tree, tuple):
        return "(" + "".join(_structure(c) + ", " for c in tree) + ")"
    return "*"


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(getattr(like, f), leaves)
                            for f in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(c, leaves) for c in like)
    return next(leaves)


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """A leaf as a host array, and the name of its dtype."""
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, arr.dtype.name


def _from_numpy(arr: np.ndarray, dtype_name: str, leaf) -> torch.Tensor:
    """A stored array as a tensor in the template leaf's dtype and on its
    device (a leaf that is not a tensor takes the stored dtype and the
    CPU)."""
    if dtype_name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.as_tensor(arr)
    if torch.is_tensor(leaf):
        return t.to(device=leaf.device, dtype=leaf.dtype)
    return t


def save_checkpoint(directory: str, step: int, tree,
                    shard_bytes: int = 1 << 30) -> str:
    """Save ``tree`` under directory/step_{step:09d}.  Returns the path.

    Crash-safe: shards and manifest are written into a ``step_*.tmp``
    staging directory and renamed into place only once complete, so a
    killed save can never be picked up by :func:`latest_step` (which
    also requires the manifest to exist)."""
    path = os.path.join(directory, f"step_{step:09d}")
    tmp = path + ".tmp"
    if os.path.isdir(tmp):          # stale staging dir from a killed save
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = _flatten_with_paths(tree)

    shards, cur, cur_bytes = [], {}, 0
    index, dtypes = {}, {}
    for p, leaf in flat:
        arr, dtypes[p] = _to_numpy(leaf)
        if cur_bytes + arr.nbytes > shard_bytes and cur:
            shards.append(cur)
            cur, cur_bytes = {}, 0
        key = f"a{len(cur)}"
        cur[key] = arr
        index[p] = (len(shards), key)
        cur_bytes += arr.nbytes
    if cur:
        shards.append(cur)

    for i, shard in enumerate(shards):
        np.savez(os.path.join(tmp, f"shard_{i:05d}.npz"), **shard)
    manifest = {
        "step": step,
        "index": {p: list(v) for p, v in index.items()},
        "structure": _structure(tree),
        "dtypes": dtypes,
    }
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.isdir(path):         # overwrite: retire the old complete dir
        shutil.rmtree(path)
    os.replace(tmp, path)
    return path


def restore_checkpoint(directory: str, step: int, like):
    """Restore into the structure of ``like`` (a template tree with the
    same paths, e.g. freshly initialized tensors): every leaf a tensor
    in the template leaf's dtype, on its device.  Leaves the checkpoint
    holds beyond the template's are ignored."""
    path = os.path.join(directory, f"step_{step:09d}")
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    shards = {}

    def load_shard(i):
        if i not in shards:
            with np.load(os.path.join(path, f"shard_{i:05d}.npz")) as z:
                shards[i] = dict(z)
        return shards[i]

    out = []
    for p, leaf in _flatten_with_paths(like):
        if p not in manifest["index"]:
            raise KeyError(f"checkpoint missing leaf {p!r}")
        si, key = manifest["index"][p]
        out.append(_from_numpy(load_shard(si)[key], manifest["dtypes"][p],
                               leaf))
    return _unflatten(like, iter(out))


def latest_step(directory: str):
    """Highest COMPLETE step number present, or None.

    A directory counts only when its manifest exists — the manifest
    lands atomically with the rename in :func:`save_checkpoint`, so
    in-flight ``step_*.tmp`` staging dirs (excluded by the name pattern
    anyway) and manually truncated dirs are never offered to a
    hot-swapping reader."""
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for d in os.listdir(directory)
             if (m := re.fullmatch(r"step_(\d+)", d))
             and os.path.isfile(os.path.join(directory, d, MANIFEST))]
    return max(steps) if steps else None
