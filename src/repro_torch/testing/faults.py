"""Fault injection for the port's robustness tests (the IVF offset faults of
``repro.testing.faults``)."""
from __future__ import annotations

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
