"""Checkpoint / resume for scene-parameter + optimizer pytrees.

The reference has no training-sense checkpointing (SURVEY.md §5.4); this is
the equivalent owed for the inverse-rendering loop: periodic
snapshots of the ScenePacked pytree and optimizer state as a flat .npz
(no external deps), restartable after failure (§5.3: render jobs are
stateless per tile; the optimization loop is the only stateful part).
"""

from __future__ import annotations

import io
import os

import jax
import numpy as np


def _flatten_with_paths(tree):
    flat, treedef = jax.tree_util.tree_flatten_with_path(tree)
    out = {}
    for path, leaf in flat:
        key = "/".join(str(p) for p in path)
        out[key] = np.asarray(leaf)
    return out, treedef


def save_pytree(path: str, tree, step: int = 0) -> None:
    """Atomically write a pytree of arrays to ``path`` (.npz)."""
    arrays, _ = _flatten_with_paths(tree)
    arrays["__step__"] = np.asarray(step)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(buf.getvalue())
    os.replace(tmp, path)  # atomic on POSIX: no torn checkpoints


def load_pytree(path: str, like):
    """Load a checkpoint written by save_pytree into the structure of
    ``like`` (a pytree with the same topology).  Returns (tree, step)."""
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    step = int(arrays.pop("__step__", 0))
    flat, treedef = jax.tree_util.tree_flatten_with_path(like)
    leaves = []
    for pathk, leaf in flat:
        key = "/".join(str(p) for p in pathk)
        if key not in arrays:
            raise KeyError(f"checkpoint {path} is missing leaf {key!r}")
        saved = arrays[key]
        leaves.append(jax.numpy.asarray(saved, dtype=np.asarray(leaf).dtype))
    return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(like), leaves), step
