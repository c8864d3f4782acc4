"""Step checkpoints of numpy trees, one ``.npz`` a step (the port's own format).

``repro.checkpoint`` flattens its trees with ``jax.tree_util`` and writes
msgpack; the port needs neither.  A tree here is a nested ``dict`` with
``str`` keys and numpy arrays (or numpy / Python scalars) at the leaves,
as :meth:`repro_torch.core.session.CacheSession.snapshot` returns.

Layout under ``directory``::

    step_00000012/state.npz     leaves under their key paths ("engine/E")
    step_00000012/meta.json     the step and the caller's meta
    step_00000012/COMMITTED     written last

A step is written into a temporary directory, renamed into place, and then
marked committed; :func:`latest_step` only sees committed steps, so a
crash part-way leaves no step that loads.  Arrays load with
``allow_pickle=False``: an object array is refused on save.

The format is the port's own: a snapshot crosses between ``repro`` and
the port as the in-memory dict (``snapshot()`` of one, ``restore()`` of
the other), not as files.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil

import numpy as np

_SEP = "/"
_ARRAYS = "state.npz"
_META = "meta.json"
_DONE = "COMMITTED"


def _step_dir(directory, step: int) -> pathlib.Path:
    return pathlib.Path(directory) / f"step_{int(step):08d}"


def _flatten(tree: dict, prefix: str, leaves: dict) -> None:
    if not tree:
        raise ValueError(f"checkpoint subtree {prefix!r} is empty (an .npz "
                         "holds leaves only)")
    for key, value in tree.items():
        if not isinstance(key, str) or _SEP in key or not key:
            raise ValueError(f"checkpoint keys are non-empty strings without "
                             f"{_SEP!r}: {key!r}")
        path = f"{prefix}{_SEP}{key}" if prefix else key
        if isinstance(value, dict):
            _flatten(value, path, leaves)
            continue
        a = np.asarray(value)
        if a.dtype == object:
            raise TypeError(f"checkpoint leaf {path!r} is an object array")
        leaves[path] = a


def _insert(tree: dict, path: str, value) -> None:
    *parents, leaf = path.split(_SEP)
    for key in parents:
        tree = tree.setdefault(key, {})
    tree[leaf] = value


def save_checkpoint(directory, step: int, tree: dict,
                    meta: dict | None = None) -> str:
    """Write ``tree`` as step ``step`` under ``directory``; returns the
    step's directory.  Refuses a step that is already committed."""
    final = _step_dir(directory, step)
    if (final / _DONE).exists():
        raise FileExistsError(f"checkpoint step {step} exists: {final}")
    leaves: dict = {}
    _flatten(tree, "", leaves)
    final.parent.mkdir(parents=True, exist_ok=True)
    tmp = final.parent / f".{final.name}.tmp-{os.getpid()}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    with open(tmp / _ARRAYS, "wb") as f:
        np.savez(f, **leaves)
        f.flush()
        os.fsync(f.fileno())
    with open(tmp / _META, "w") as f:
        json.dump({"step": int(step), "meta": meta or {}}, f)
    if final.exists():              # an uncommitted leftover of a crash
        shutil.rmtree(final)
    os.replace(tmp, final)
    with open(final / _DONE, "w") as f:
        f.flush()
        os.fsync(f.fileno())
    return str(final)


def latest_step(directory) -> int | None:
    """The newest committed step under ``directory``, or None."""
    root = pathlib.Path(directory)
    if not root.is_dir():
        return None
    steps = [int(p.name[5:]) for p in root.glob("step_*")
             if p.name[5:].isdigit() and (p / _DONE).exists()]
    return max(steps) if steps else None


def load_checkpoint_tree(directory, step: int) -> tuple[dict, dict]:
    """``(tree, meta)`` of committed step ``step`` under ``directory``."""
    path = _step_dir(directory, step)
    if not (path / _DONE).exists():
        raise FileNotFoundError(f"no committed checkpoint step {step} under "
                                f"{directory}")
    with open(path / _META) as f:
        info = json.load(f)
    tree: dict = {}
    with np.load(path / _ARRAYS, allow_pickle=False) as z:
        for key in z.files:
            _insert(tree, key, z[key])
    return tree, info["meta"]
