"""Step checkpoints of trees of arrays, one ``.npz`` a step (the port's own
format), and the training loop's :class:`CheckpointManager`.

``repro.checkpoint`` flattens its trees with ``jax.tree_util`` and writes
msgpack; the port needs neither.  A tree here is a nested ``dict`` with
``str`` keys and, at the leaves, numpy arrays, numpy / Python scalars (as
:meth:`repro_torch.core.session.CacheSession.snapshot` returns) or torch
tensors on any device (a trainer's parameters and optimizer state).  A
tensor is read back to the host; bf16 (and f16) leaves are stored as f32,
which is exact, under their dtype's name; every other dtype is stored as
it is.

Layout under ``directory``::

    step_00000012/state.npz     leaves under their key paths ("engine/E")
    step_00000012/meta.json     the step, the caller's meta, the dtype
                                names of the widened tensor leaves
    step_00000012/COMMITTED     written last

A step is written into a temporary directory, renamed into place, and then
marked committed; :func:`latest_step` only sees committed steps, so a
crash part-way leaves no step that loads.  Arrays load with
``allow_pickle=False``: an object array is refused on save.

:func:`load_checkpoint_tree` gives the stored numpy tree (a widened leaf
as f32); :func:`restore_checkpoint` restores into the structure, dtypes
and devices of a ``like`` tree, as the reference's does.

The format is the port's own: a snapshot crosses between ``repro`` and
the port as the in-memory dict (``snapshot()`` of one, ``restore()`` of
the other), not as files.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading

import numpy as np
import torch

_SEP = "/"
_ARRAYS = "state.npz"
_META = "meta.json"
_DONE = "COMMITTED"
#: tensor dtypes numpy cannot hold, stored as f32 (exact)
_WIDENED = {torch.bfloat16: "bfloat16", torch.float16: "float16"}


def _step_dir(directory, step: int) -> pathlib.Path:
    return pathlib.Path(directory) / f"step_{int(step):08d}"


def _items(tree: dict, prefix: str = ""):
    """``(path, leaf)`` of every leaf of ``tree``, checking its keys."""
    if not tree:
        raise ValueError(f"checkpoint subtree {prefix!r} is empty (an .npz "
                         "holds leaves only)")
    for key, value in tree.items():
        if not isinstance(key, str) or _SEP in key or not key:
            raise ValueError(f"checkpoint keys are non-empty strings without "
                             f"{_SEP!r}: {key!r}")
        path = f"{prefix}{_SEP}{key}" if prefix else key
        if isinstance(value, dict):
            yield from _items(value, path)
        else:
            yield path, value


def _host(path: str, value) -> tuple[np.ndarray, str | None]:
    """A leaf as a numpy array, and the dtype name of a widened tensor."""
    name = None
    if isinstance(value, torch.Tensor):
        value = value.detach()
        name = _WIDENED.get(value.dtype)
        if name is not None:
            value = value.float()
        value = value.cpu().numpy()
    a = np.asarray(value)
    if a.dtype == object:
        raise TypeError(f"checkpoint leaf {path!r} is an object array")
    return a, name


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
    leaves, widened = {}, {}
    for path, value in _items(tree):
        leaves[path], name = _host(path, value)
        if name is not None:
            widened[path] = name
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
        json.dump({"step": int(step), "meta": meta or {},
                   "widened": widened}, f)
    if final.exists():              # an uncommitted leftover of a crash
        shutil.rmtree(final)
    os.replace(tmp, final)
    with open(final / _DONE, "w") as f:
        f.flush()
        os.fsync(f.fileno())
    return str(final)


def _steps(directory) -> list[int]:
    """Every step directory's step under ``directory``, committed or not."""
    root = pathlib.Path(directory)
    if not root.is_dir():
        return []
    return sorted(int(p.name[5:]) for p in root.glob("step_*")
                  if p.name[5:].isdigit())


def latest_step(directory) -> int | None:
    """The newest committed step under ``directory``, or None."""
    steps = [s for s in _steps(directory)
             if (_step_dir(directory, s) / _DONE).exists()]
    return steps[-1] if steps else None


def load_checkpoint_tree(directory, step: int) -> tuple[dict, dict]:
    """``(tree, meta)`` of committed step ``step`` under ``directory``, the
    leaves as stored (numpy; a widened bf16 / f16 tensor as f32)."""
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


def restore_checkpoint(directory, step: int, like: dict, device=None):
    """``(tree, meta)`` of committed step ``step``, in the structure of
    ``like``: a tensor leaf comes back as a tensor in its ``like`` leaf's
    dtype, on ``device`` (None: the ``like`` leaf's device); a numpy leaf
    in its ``like`` leaf's dtype; any other leaf as the stored array.
    A checkpoint whose leaves are not ``like``'s is refused, as the
    reference's assertion refuses it."""
    stored, meta = load_checkpoint_tree(directory, step)
    want = dict(_items(like))
    have = dict(_items(stored))
    if set(want) != set(have):
        raise AssertionError(
            f"checkpoint/tree mismatch: only in the checkpoint "
            f"{sorted(set(have) - set(want))}, only in the tree "
            f"{sorted(set(want) - set(have))}")
    out: dict = {}
    for path, l in want.items():
        a = have[path]
        if isinstance(l, torch.Tensor):
            a = torch.from_numpy(np.array(a)).to(
                device=l.device if device is None else device, dtype=l.dtype)
        elif isinstance(l, np.ndarray):
            a = a.astype(l.dtype)
        _insert(out, path, a)
    return out, meta


def _host_copy(tree: dict) -> dict:
    """A copy of ``tree`` on the host (tensors copied to CPU tensors)."""
    def copy(v):
        if isinstance(v, dict):
            return {k: copy(x) for k, x in v.items()}
        if isinstance(v, torch.Tensor):
            return v.detach().to("cpu", copy=True)
        return np.array(v)

    return copy(tree)


class CheckpointManager:
    """Keeps the last ``keep`` checkpoints under ``directory``; saves in the
    caller's thread or, with ``async_save``, on a background thread."""

    def __init__(self, directory, keep: int = 3, async_save: bool = False):
        self.directory = str(directory)
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        os.makedirs(self.directory, exist_ok=True)

    def wait(self) -> None:
        """Join the background save; re-raises its error, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        for s in _steps(self.directory)[: -self.keep]:
            shutil.rmtree(_step_dir(self.directory, s), ignore_errors=True)

    def save(self, step: int, tree: dict, meta: dict | None = None) -> None:
        """Snapshot ``tree`` to the host now (the caller may then update
        its tensors in place), then write it."""
        host_tree = _host_copy(tree)
        if not self.async_save:
            self._save_sync(step, host_tree, meta)
            return
        self.wait()
        self._thread = threading.Thread(
            target=self._save_sync, args=(step, host_tree, meta), daemon=True)
        self._thread.start()

    def _save_sync(self, step: int, tree: dict, meta) -> None:
        try:
            save_checkpoint(self.directory, step, tree, meta)
            self._gc()
        except BaseException as e:       # re-raised by wait()
            if not self.async_save:
                raise
            self._error = e

    def restore_latest(self, like: dict, device=None):
        """``(step, tree, meta)`` of the newest committed step restored
        into ``like``, or ``(None, None, None)``."""
        step = latest_step(self.directory)
        if step is None:
            return None, None, None
        tree, meta = restore_checkpoint(self.directory, step, like, device)
        return step, tree, meta
