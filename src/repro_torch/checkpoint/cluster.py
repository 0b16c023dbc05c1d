"""Clustering checkpoint helpers: a ``BoundState`` saved under its geometry
stamp (port of ``repro.checkpoint.cluster``).

The loops' ``BoundState`` is laid out for one (shard count, tile height)
geometry: its per-tile partials and maxima (and a fit's per-super
accumulators) cover the rows of that geometry's tiles. Read under another
geometry they would describe other rows: silently wrong bounds, and a
wrong skip is a wrong answer. So ``restore_bound_state`` returns the saved
state only when the current (shards, tile) is the saved one, and ``None``
otherwise; the caller then rebuilds the state with one ungated round
(exact: the results are bitwise unaffected, only skip counters differ). A
missing checkpoint, or one that holds no bound state, raises the typed
``CheckpointError``, never a silent fresh start.

On one card ``shards`` is 1; the argument stays for a sharded run. The
engine's resumable seeding and fit (``ClusterEngine.seed/fit(...,
checkpoint_dir=)``) save their whole carry through ``CheckpointManager``.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.bounds import BoundState
from repro_torch.core.guards import CheckpointError

__all__ = ["save_bound_state", "restore_bound_state"]


def _mgr(directory) -> CheckpointManager:
    if isinstance(directory, CheckpointManager):
        return directory
    # blocking writes: a bound state is small, and the caller's next action
    # (a resume or a reshard probe) reads it right back
    return CheckpointManager(directory, async_save=False)


def save_bound_state(directory, step: int, state: BoundState, *,
                     shards: int, tile: int) -> CheckpointManager:
    """Save a (shard-local) BoundState under its geometry stamp."""
    mgr = _mgr(directory)
    mgr.save(step, state, blocking=True,
             meta={"kind": "bound_state", "shards": int(shards),
                   "tile": int(tile)})
    return mgr


def restore_bound_state(directory, like: BoundState, *, shards: int,
                        tile: int,
                        step: Optional[int] = None) -> Optional[BoundState]:
    """The saved BoundState when the (shards, tile) geometry matches, else
    ``None``. ``like`` gives the fields, dtypes and device (as
    ``CheckpointManager.restore``)."""
    mgr = _mgr(directory)
    st = mgr.latest_step() if step is None else step
    if st is None:
        raise CheckpointError(f"no bound-state checkpoint under {mgr.dir}")
    meta = mgr.read_manifest(st).get("meta") or {}
    if meta.get("kind") != "bound_state":
        raise CheckpointError(
            f"step {st} under {mgr.dir} is not a bound-state checkpoint "
            f"(meta={meta})")
    if meta.get("shards") != int(shards) or meta.get("tile") != int(tile):
        return None
    _, state = mgr.restore(like, step=st)
    return state
