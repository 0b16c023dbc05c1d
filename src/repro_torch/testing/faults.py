"""Deterministic fault injection for the port's robustness tests (port of
``repro.testing.faults``).

Every fault fires at a named round or step, so a failing robustness test
replays exactly:

* ``FaultSpec`` — corruption of the loops' carried state, passed to
  ``ClusterEngine.seed(..., _fault=)`` / ``fit(..., _fault=)``. Kinds:
    - ``nan_tile``      seeding: NaN the first min(64, n) rows of the
                        carried D² at ``round``
    - ``nan_state``     seeding / gated fit: NaN the first carried tile
                        partial (bound state poisoning) at ``round``
    - ``zero_counts``   gated fit: halve an iteration's cluster sums and
                        counts (a lost contribution) at ``round``
    - ``neg_envelope``  rejection seeding: a negative partial in the stale
                        envelope at ``round``
    - ``stale_super``   rejection seeding: NaN every tile partial of the
                        last super-tile at ``round`` (a torn coarse
                        aggregate)
* ``flaky_read_fn`` / ``kill_prefetch`` — host-side pipeline faults:
  transient reader failures (the retry path) and a dead prefetch thread
  (the typed ``PipelineError`` path).
* ``corrupt_list_offsets`` — an IVF index whose offset table disagrees with
  its layout; ``search`` must raise ``CorruptedStateError``.

The contract the fault matrix asserts: every fault either heals bitwise
(the guarded loops recover and the result equals a never-corrupted run's)
or raises a typed ``ClusteringError`` subclass, never a silent wrong
answer. The reference's ``force_kernel_failure`` is not ported: the port
has no fallback chain, and a failing kernel raises ``KernelFailureError``.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable

SEED_FAULTS = ("nan_tile", "nan_state")
FIT_FAULTS = ("zero_counts", "nan_state")
REJECTION_FAULTS = ("neg_envelope", "stale_super")
ALL_FAULTS = ("nan_tile", "nan_state", "zero_counts", "neg_envelope",
              "stale_super")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One injected fault: ``kind`` names the corruption, ``round`` the loop
    iteration it fires at (seeding round m, fit iteration i counted from 0,
    rejection round m)."""
    kind: str
    round: int = 1

    def __post_init__(self):
        if self.kind not in ALL_FAULTS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; one of {ALL_FAULTS}")


def flaky_read_fn(read_fn: Callable[[int], object], *, fail_steps: dict
                  ) -> Callable[[int], object]:
    """Wrap a pipeline ``read_fn`` so step ``s`` fails its first
    ``fail_steps[s]`` calls (a transient storage flake), then succeeds.
    Thread-safe; counts ``fail_steps`` down to zero in place, so the caller
    can assert how many retries happened."""
    lock = threading.Lock()

    def flaky(s: int):
        with lock:
            left = fail_steps.get(s, 0)
            if left > 0:
                fail_steps[s] = left - 1
                raise IOError(f"injected transient read failure at step {s}")
        return read_fn(s)

    return flaky


def kill_prefetch(pipeline) -> None:
    """Kill a ``DataPipeline``'s prefetch thread mid-stream: the next batch
    the worker reads raises, so the consumer's next ``__next__`` gets a
    typed ``PipelineError`` (with the step) instead of hanging on a dead
    queue."""
    def _dead(s: int):
        raise RuntimeError(f"injected prefetch death at step {s}")

    pipeline.read_fn = _dead
    pipeline.retries = 1  # no point backing off a deliberate kill


IVF_OFFSET_FAULTS = ("shifted_start", "short_count", "negative_count")


def corrupt_list_offsets(index, *, kind: str = "shifted_start"):
    """A copy of a ``serve.ivf.IvfIndex`` with a corrupted offset table,
    the rest untouched (what a half-applied restore leaves):

      - ``shifted_start``   one list's start drifts off the cumsum layout
      - ``short_count``     one list under-reports its size (sum != n)
      - ``negative_count``  one count goes negative

    Each violates an invariant ``IvfIndex.search`` revalidates, so a search
    on the copy raises ``CorruptedStateError``."""
    if kind not in IVF_OFFSET_FAULTS:
        raise ValueError(
            f"unknown offset fault {kind!r}; one of {IVF_OFFSET_FAULTS}")
    if kind == "shifted_start":
        starts = index.starts.clone()
        starts[-1] += 1
        return index._replace(starts=starts)
    counts = index.counts.clone()
    if kind == "short_count":
        counts[0] -= 1
    else:
        counts[0] = -1
    return index._replace(counts=counts)
