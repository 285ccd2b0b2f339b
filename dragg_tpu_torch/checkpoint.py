"""Checkpoint / resume of the engine's carried state (counterpart of
``dragg_tpu/checkpoint.py``, single process).

A run's ``CommunityState`` (or one per type bucket) is persisted beside
results.json at every chunk boundary, so a killed run resumes
mid-simulation bit for bit: the same chunk loop continues from the saved
state.

Format, as in the JAX package: one ``.npz`` with leaves named
``leaf_0000``, ``leaf_0001``, … in flatten order — tuple order,
NamedTuple field order and sorted dict keys, which is the order
``jax.tree_util.tree_flatten`` gives the JAX package's carry.  Loading needs a template tree of the same
structure (an engine can always rebuild its initial state), so the file
holds no structure and no pickle.  A versioned checkpoint is a
``ckpt_t<timestep>`` directory (state.npz, progress.json and the caller's
extra JSON files) staged under a ``.tmp`` name, renamed into place and
published by an atomically replaced ``LATEST`` pointer.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch


# ------------------------------------------------------------- tree walk
def tree_flatten(tree) -> tuple[list, object]:
    """(leaves, structure) of a tree of nested tuples, NamedTuples and dicts
    (in sorted key order, as JAX flattens a dict) whose leaves are tensors
    or arrays."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        leaves, structure = tree_flatten(tuple(tree[k] for k in keys))
        return leaves, (dict, keys, structure)
    if isinstance(tree, tuple):
        leaves, specs = [], []
        for sub in tree:
            sub_leaves, spec = tree_flatten(sub)
            leaves += sub_leaves
            specs.append((len(sub_leaves), spec))
        return leaves, (type(tree), specs)
    return [tree], None


def tree_unflatten(structure, leaves):
    """The inverse of :func:`tree_flatten`."""
    if structure is None:
        (leaf,) = leaves
        return leaf
    if structure[0] is dict:
        _, keys, sub = structure
        return dict(zip(keys, tree_unflatten(sub, leaves)))
    kind, specs = structure
    parts, i = [], 0
    for count, spec in specs:
        parts.append(tree_unflatten(spec, leaves[i:i + count]))
        i += count
    return kind(*parts) if hasattr(kind, "_fields") else kind(parts)


def tree_leaves(tree) -> list:
    return tree_flatten(tree)[0]


def tree_map(fn, tree):
    leaves, structure = tree_flatten(tree)
    return tree_unflatten(structure, [fn(a) for a in leaves])


# ----------------------------------------------------------- host copies
def to_host(a, copy: bool = False) -> np.ndarray:
    """A tensor (or array) as host numpy.  ``copy=True`` forces an owning
    copy: ``.numpy()`` of a CPU tensor is a view of its storage."""
    out = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.array(out, copy=True) if copy else out


def host_snapshot(tree):
    """Deep host copy of a state tree, independent of the tensors it was
    taken from.  Waits for the device to finish computing them."""
    return tree_map(lambda a: to_host(a, copy=True), tree)


# ------------------------------------------------------------ npz files
def save_pytree(path: str, tree) -> None:
    """Write a tree of tensors or arrays as an npz (leaves in flatten
    order), atomically."""
    arrays = {f"leaf_{i:04d}": to_host(a) for i, a in enumerate(tree_leaves(tree))}
    tmp = path + ".tmp.npz"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load_pytree(path: str, template):
    """Load an npz written by :func:`save_pytree` into ``template``'s
    structure.  Each leaf lands on its template leaf's device with its
    dtype; a leaf count or shape that differs from the template's raises
    ``ValueError``."""
    leaves, structure = tree_flatten(template)
    with np.load(path) as data:
        # Numerically: a lexicographic sort would put leaf_10000 between
        # leaf_1000 and leaf_1001.
        keys = sorted(data.files, key=lambda k: int(k.rsplit("_", 1)[1]))
        if len(keys) != len(leaves):
            raise ValueError(f"Checkpoint {path} has {len(keys)} leaves; template has "
                             f"{len(leaves)}")
        new_leaves = []
        for key, tmpl in zip(keys, leaves):
            arr = data[key]
            if tuple(arr.shape) != tuple(tmpl.shape):
                raise ValueError(f"Checkpoint leaf {key} shape {arr.shape} != template "
                                 f"{tuple(tmpl.shape)}")
            if isinstance(tmpl, torch.Tensor):
                new_leaves.append(torch.as_tensor(arr).to(device=tmpl.device,
                                                          dtype=tmpl.dtype))
            else:
                new_leaves.append(arr.astype(np.asarray(tmpl).dtype))
    return tree_unflatten(structure, new_leaves)


# ------------------------------------------------- versioned checkpoints
def save_checkpoint_dir(root: str, timestep: int, tree, progress: dict,
                        files: dict | None = None) -> str:
    """Write one versioned checkpoint directory and publish it through
    ``LATEST``; superseded checkpoints are pruned.  ``progress`` carries
    every host-side field a resume needs (``timestep`` is added to it and
    names the directory); ``files`` maps further file names in the
    directory to a callable that writes one, given its path.  A kill at
    any instant leaves the previous complete checkpoint or the new one,
    never a mix.  Returns the published directory."""
    os.makedirs(root, exist_ok=True)
    name = f"ckpt_t{timestep:08d}"
    tmp = os.path.join(root, name + ".tmp")
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    save_pytree(os.path.join(tmp, "state.npz"), tree)
    for fname, write in (files or {}).items():
        write(os.path.join(tmp, fname))
    save_progress(os.path.join(tmp, "progress.json"), {**progress, "timestep": int(timestep)})
    final = os.path.join(root, name)
    # A run killed between this rename and the LATEST replace leaves a
    # complete directory here while LATEST names the older one; the resumed
    # run reaches this timestep again, and a rename onto it would raise.
    shutil.rmtree(final, ignore_errors=True)
    os.rename(tmp, final)
    latest_tmp = os.path.join(root, f"LATEST.tmp{os.getpid()}")
    with open(latest_tmp, "w") as f:
        f.write(name)
        f.flush()
        os.fsync(f.fileno())
    os.replace(latest_tmp, os.path.join(root, "LATEST"))
    for entry in os.listdir(root):
        if entry.startswith("ckpt_") and entry != name:
            shutil.rmtree(os.path.join(root, entry), ignore_errors=True)
    return final


def latest_checkpoint_dir(root: str) -> str | None:
    """The directory ``LATEST`` names, or None when it is absent or torn."""
    try:
        with open(os.path.join(root, "LATEST")) as f:
            name = f.read().strip()
    except OSError:
        return None
    d = os.path.join(root, name)
    return d if name and os.path.isdir(d) else None


def save_progress(path: str, progress: dict) -> None:
    """Write a JSON file atomically."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(progress, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load_progress(path: str) -> dict:
    with open(path) as f:
        return json.load(f)
