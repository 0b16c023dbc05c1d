"""Checkpointing: atomic step directories and an async writer (port of
``repro.checkpoint.manager``).

Format: ``step_<N>/arrays.pt``, one flat ``{leaf name: tensor}`` dict
written by ``torch.save``, and ``step_<N>/manifest.json`` holding the leaf
names, dtypes and shapes, the structure of the saved tree and the caller's
``meta``. The tree is flattened here (dicts, lists, tuples, NamedTuples
such as ``BoundState``, dataclasses such as ``Draws``, ``None``, Python
ints, floats and bools, tensors), so the file holds tensors only: it loads
with ``weights_only=True``, and ``restore`` rebuilds the tree from the
classes of the caller's ``like``, never from pickled ones. Every dtype
round-trips as itself (bf16 as bf16).

Commit protocol (crash-safe): write into ``step_<N>.tmp/``, then
``os.replace`` it to ``step_<N>/``; readers list renamed (complete)
directories only. A save first snapshots every tensor to host memory (a
copy the host waits on), so the caller may go on writing its device
tensors, in place too; with ``async_save`` the file is then written by a
background thread.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Optional

import torch

from repro_torch.core.guards import CheckpointError

__all__ = ["CheckpointManager"]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, prefix: str = ""):
    """(structure, [(name, leaf)]) of ``tree``: the structure is JSON (a
    node's kind, its field names or length, its children), the leaves are
    tensors or Python scalars, named by their path."""
    def child(key):
        return f"{prefix}/{key}" if prefix else str(key)

    if tree is None:
        return None, []
    if isinstance(tree, torch.Tensor):
        return "tensor", [(prefix or "leaf", tree)]
    if isinstance(tree, (bool, int, float)):
        return type(tree).__name__, [(prefix or "leaf", tree)]
    if isinstance(tree, dict):
        keys = sorted(tree)
        kind, items = "dict", [(k, tree[k]) for k in keys]
    elif _is_namedtuple(tree):
        kind, items = type(tree).__name__, list(zip(tree._fields, tree))
    elif dataclasses.is_dataclass(tree):
        kind = type(tree).__name__
        items = [(f.name, getattr(tree, f.name))
                 for f in dataclasses.fields(tree)]
    elif isinstance(tree, (list, tuple)):
        kind, items = type(tree).__name__, list(enumerate(tree))
    else:
        raise CheckpointError(
            f"cannot checkpoint a {type(tree).__name__} at {prefix!r}")
    nodes, leaves = [], []
    for key, value in items:
        node, sub = _flatten(value, child(key))
        nodes.append([str(key), node])
        leaves += sub
    return {"kind": kind, "children": nodes}, leaves


def _unflatten(like, values: dict, prefix: str = ""):
    """``like``'s tree with each leaf taken from ``values`` by name: a
    tensor leaf moved to the device and dtype of ``like``'s, a scalar leaf
    made the Python type of ``like``'s."""
    def child(key):
        return f"{prefix}/{key}" if prefix else str(key)

    if like is None:
        return None
    if isinstance(like, torch.Tensor):
        v = values[prefix or "leaf"]
        if tuple(v.shape) != tuple(like.shape):
            raise CheckpointError(
                f"leaf {prefix!r} has shape {tuple(v.shape)}, the restore "
                f"target {tuple(like.shape)}")
        return v.to(device=like.device, dtype=like.dtype)
    if isinstance(like, (bool, int, float)):
        return type(like)(values[prefix or "leaf"].item())
    if isinstance(like, dict):
        return {k: _unflatten(like[k], values, child(k)) for k in like}
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(v, values, child(f))
                            for f, v in zip(like._fields, like)))
    if dataclasses.is_dataclass(like):
        return dataclasses.replace(like, **{
            f.name: _unflatten(getattr(like, f.name), values, child(f.name))
            for f in dataclasses.fields(like)})
    return type(like)(_unflatten(v, values, child(i))
                      for i, v in enumerate(like))


def _host(leaf) -> torch.Tensor:
    """A leaf as a host tensor of its own: a card tensor is copied by a
    stream-ordered copy the host waits on, a host tensor cloned."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return torch.tensor(leaf, dtype=torch.float64 if isinstance(leaf, float)
                        else None)


class CheckpointManager:
    def __init__(self, directory, *, keep: int = 3,
                 async_save: bool = True):
        """``keep`` newest steps survive each save (0 keeps every step);
        ``async_save`` writes the files in a background thread."""
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._pending: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, state: Any, *, blocking: bool = False,
             meta: Optional[dict] = None) -> None:
        """Snapshot ``state`` (a tree of tensors and scalars) to host memory
        and write it as ``step_<step>``. ``meta`` (a JSON-able dict) goes
        into the manifest, where a resuming caller checks it
        (:meth:`read_manifest`) before trusting the leaves."""
        self.wait()
        named, manifest = self._snapshot(step, state, meta)
        if self.async_save and not blocking:
            self._pending = threading.Thread(
                target=self._commit_logged, args=(step, named, manifest),
                daemon=True)
            self._pending.start()
        else:
            self._commit(step, named, manifest)

    def _snapshot(self, step: int, state: Any, meta: Optional[dict]):
        """The leaves as host tensors, and the manifest."""
        structure, leaves = _flatten(state)
        named = {name: _host(leaf) for name, leaf in leaves}
        manifest = {"step": int(step), "structure": structure,
                    "leaves": list(named),
                    "dtypes": [str(t.dtype).replace("torch.", "")
                               for t in named.values()],
                    "shapes": [list(t.shape) for t in named.values()]}
        if meta is not None:
            manifest["meta"] = meta
        return named, manifest

    def _commit(self, step: int, named: dict, manifest: dict) -> None:
        """Write ``step_<step>.tmp/`` and rename it to ``step_<step>/``."""
        tmp = self.dir / f"step_{step:08d}.tmp"
        final = self.dir / f"step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        torch.save(named, tmp / "arrays.pt")
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)       # atomic commit
        self._gc()

    def _commit_logged(self, step, named, manifest) -> None:
        try:
            self._commit(step, named, manifest)
        except BaseException as e:   # raised by the next wait()
            self._error = e

    def wait(self) -> None:
        """Join the writer thread; a write that failed raises
        ``CheckpointError`` here."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._error is not None:
            err, self._error = self._error, None
            raise CheckpointError(f"checkpoint write under {self.dir} "
                                  f"failed: {err}") from err

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # -- restore ------------------------------------------------------------
    def all_steps(self) -> list[int]:
        return sorted(int(p.name.split("_")[1]) for p in self.dir.iterdir()
                      if p.is_dir() and p.name.startswith("step_")
                      and not p.name.endswith(".tmp"))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _step_dir(self, step: Optional[int]) -> Path:
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.dir}")
        return self.dir / f"step_{step:08d}"

    def read_manifest(self, step: Optional[int] = None) -> dict:
        """The manifest of ``step`` (the latest when None) without loading
        a tensor: the cheap compatibility probe a resuming caller runs
        before :meth:`restore`."""
        return json.loads((self._step_dir(step) / "manifest.json")
                          .read_text())

    def restore(self, like: Any, *, step: Optional[int] = None
                ) -> tuple[int, Any]:
        """(step, tree): the saved tree rebuilt in the structure and
        classes of ``like``, each tensor on the device and in the dtype of
        ``like``'s leaf (loaded with ``map_location`` on ``like``'s
        device). A tree whose structure differs from the saved one raises
        ``CheckpointError``."""
        d = self._step_dir(step)
        manifest = json.loads((d / "manifest.json").read_text())
        structure, leaves = _flatten(like)
        if structure != manifest["structure"]:
            raise CheckpointError(
                f"{d} holds another tree than the restore target: saved "
                f"{manifest['structure']}, target {structure}")
        where = next((leaf.device for _, leaf in leaves
                      if isinstance(leaf, torch.Tensor)),
                     torch.device("cpu"))
        values = torch.load(d / "arrays.pt", map_location=where,
                            weights_only=True)
        return manifest["step"], _unflatten(like, values)
