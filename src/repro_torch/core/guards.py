"""Input guards + the typed failure vocabulary of the clustering stack
(port of ``repro.core.guards``).

* a ``validate="raise" | "sanitize" | "off"`` policy applied at every
  ``ClusterEngine`` entry point: NaN/Inf rows and k/n/d shape abuse are
  caught before they enter a round loop;
* the :class:`ClusteringError` hierarchy, so callers can tell a typed
  failure from a silent wrong answer (a batch source that keeps failing
  raises :class:`PipelineError` with the step; a checkpoint that cannot be
  resumed raises :class:`CheckpointError`).

A kernel that fails to build or launch raises :class:`KernelFailureError`.
The port has no fallback chain: nothing catches it.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = [
    "ClusteringError", "CorruptedStateError", "InvalidInputError",
    "KernelFailureError", "PipelineError", "CheckpointError", "POLICIES",
    "check_policy", "check_shape", "guard_points", "guard_weights",
    "guard_centroids",
]


class ClusteringError(Exception):
    """Base of every typed failure the clustering stack raises."""


class InvalidInputError(ClusteringError, ValueError):
    """Malformed caller input: NaN/Inf rows under validate='raise',
    negative/degenerate weights, k/n/d shape abuse."""


class CorruptedStateError(ClusteringError, RuntimeError):
    """Stored or loop-carried state found poisoned where no in-loop
    recovery is available (an IVF index whose list offsets disagree with
    its layout)."""


class KernelFailureError(ClusteringError, RuntimeError):
    """A CUDA kernel failed to build or launch."""


class PipelineError(ClusteringError, RuntimeError):
    """The data pipeline's read path failed past its retry budget. Carries
    the failing step index."""

    def __init__(self, message: str, *, step: Optional[int] = None):
        super().__init__(message)
        self.step = step


class CheckpointError(ClusteringError, RuntimeError):
    """Checkpoint save/restore failed, or the checkpoint was written by an
    incompatible call (another problem shape, sampler, precision, backend,
    device or tile height), or the call cannot be checkpointed."""


POLICIES = ("raise", "sanitize", "off")


def check_policy(validate: str) -> str:
    if validate not in POLICIES:
        raise InvalidInputError(
            f"unknown validate policy {validate!r}; expected one of "
            f"{POLICIES}")
    return validate


def check_shape(k: int, n: int, *, d: Optional[int] = None,
                what: str = "seed") -> None:
    """k/n/d shape abuse is never sanitizable — always typed raise."""
    if not 0 < k <= n:
        raise InvalidInputError(f"need 0 < k <= n, got k={k}, n={n}")
    if d is not None and d < 1:
        raise InvalidInputError(f"{what}: need d >= 1, got d={d}")


def _count_bad(mask: torch.Tensor) -> int:
    # one device reduction + one scalar sync: the whole cost of a guard
    # pass on clean input
    return int(mask.sum())


def guard_points(points: torch.Tensor, policy: str, *,
                 name: str = "points") -> torch.Tensor:
    """NaN/Inf entries: 'raise' -> InvalidInputError, 'sanitize' -> the
    offending ROWS are zeroed, 'off' -> passthrough. Clean input is
    returned unchanged (the same tensor)."""
    if policy == "off" or not points.is_floating_point():
        return points
    finite = torch.isfinite(points)
    n_bad = _count_bad(~finite)
    if n_bad == 0:
        return points
    if policy == "raise":
        raise InvalidInputError(
            f"{name} has {n_bad} non-finite entries; pass "
            f"validate='sanitize' to zero the offending rows or "
            f"validate='off' to skip the check")
    row_ok = finite.all(dim=-1, keepdim=True)
    return torch.where(row_ok, points, torch.zeros((), dtype=points.dtype,
                                                   device=points.device))


def guard_weights(weights: Optional[torch.Tensor], n: int,
                  policy: str) -> Optional[torch.Tensor]:
    """Degenerate weights: NaN/Inf/negative entries raise or clamp to 0;
    an all-zero (or sanitized-to-zero) weight vector always raises. Shape
    mismatch always raises."""
    if weights is None:
        return None
    if tuple(weights.shape) != (n,):
        raise InvalidInputError(
            f"weights shape {tuple(weights.shape)} != ({n},)")
    if policy == "off":
        return weights
    bad = ~torch.isfinite(weights) | (weights < 0)
    n_bad = _count_bad(bad)
    if n_bad:
        if policy == "raise":
            raise InvalidInputError(
                f"weights has {n_bad} negative/non-finite entries")
        weights = torch.where(bad, torch.zeros((), dtype=weights.dtype,
                                               device=weights.device),
                              weights)
    if not bool((weights > 0).any()):
        raise InvalidInputError("weights sum to zero: nothing to sample")
    return weights


def guard_centroids(centroids: torch.Tensor, d: int, policy: str, *,
                    name: str = "init_centroids") -> torch.Tensor:
    """Initial centroids: NaN/Inf always raises (a sanitized-to-zero
    centroid silently moves the optimum); shape abuse always raises."""
    if centroids.shape[-1] != d:
        raise InvalidInputError(
            f"{name} dimension {centroids.shape[-1]} != points dimension {d}")
    if policy == "off":
        return centroids
    n_bad = _count_bad(~torch.isfinite(centroids))
    if n_bad:
        raise InvalidInputError(f"{name} has {n_bad} non-finite entries")
    return centroids
