"""Round cache, carried state and tile geometry (port of ``repro.core.bounds``,
the subset the ungated path uses).

``RoundCache`` is the once-per-call prologue: the fp32 ``||x||^2`` norms
every round streams instead of recomputing. ``BoundState`` is what the
ungated Lloyd round hands to the next iteration. The tile-ball bounds,
per-point Hamerly bounds and the gating that reads them are the next slice
of the port (``bounds=True``).

Tile geometry: ``block_n`` consecutive rows form a tile (zero-padded tail);
``tiles_per_super`` consecutive tiles share one per-cluster accumulator
slot, so the assignment round's accumulators are O(n_super·k·d).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class RoundCache(NamedTuple):
    """Per-dataset state computed ONCE per seed/fit call (the prologue)."""

    norms: torch.Tensor          # (n,) fp32 ||x||²


class BoundState(NamedTuple):
    """What one ungated assignment round leaves for the next iteration:
    per-tile inertia partials, per-tile second-best margin (distance
    units), per-super per-cluster sums/counts and the per-point labels/D²."""

    partials: torch.Tensor                         # (n_tiles,) fp32
    tile_gap: Optional[torch.Tensor] = None        # (n_tiles,) fp32
    tile_sums: Optional[torch.Tensor] = None       # (n_super, k, d) fp32
    tile_counts: Optional[torch.Tensor] = None     # (n_super, k) fp32
    assignment: Optional[torch.Tensor] = None      # (n,) int32
    min_d2: Optional[torch.Tensor] = None          # (n,) fp32


def point_norms(points: torch.Tensor) -> torch.Tensor:
    """fp32 ``||x||²`` per row — THE quantity the prologue caches."""
    x = points.float()
    return (x * x).sum(dim=-1)


def tile_counts(n: int, block_n: int, device=None) -> torch.Tensor:
    """Valid-row count of each tile of a zero-padded (n,) -> (n_tiles, bn)."""
    n_tiles = -(-n // block_n)
    start = torch.arange(n_tiles, dtype=torch.int64, device=device) * block_n
    return (n - start).clamp(0, block_n).float()


def tiles_per_super(n_tiles: int, tps: Optional[int] = None) -> int:
    """Static super-tile width: ~√n_tiles consecutive tiles share one
    accumulator slot (a power of two). Problems of ≤ 8 tiles keep the flat
    layout (tps = 1). ``tps`` overrides the heuristic; it is clamped to
    [1, next_pow2(n_tiles)] and floored to a power of two."""
    if tps is not None and tps > 0:
        cap = 1 << max(int(n_tiles - 1).bit_length(), 0) if n_tiles > 1 else 1
        t = 1 << (int(tps).bit_length() - 1)
        return max(1, min(t, cap))
    if n_tiles <= 8:
        return 1
    return 1 << ((int(n_tiles - 1).bit_length() + 1) // 2)


def n_supers(n_tiles: int, tps: Optional[int] = None) -> int:
    return -(-n_tiles // tiles_per_super(n_tiles, tps))


def super_reduce(tile_arr: torch.Tensor, tps: int) -> torch.Tensor:
    """Reduce a per-tile array over each super-tile's tiles (leading axis
    n_tiles -> n_super); the ragged last super is zero-padded."""
    n_tiles = tile_arr.shape[0]
    pad = (-n_tiles) % tps
    if pad:
        tile_arr = torch.cat([tile_arr, tile_arr.new_zeros(
            (pad,) + tuple(tile_arr.shape[1:]))])
    return tile_arr.reshape((-1, tps) + tuple(tile_arr.shape[1:])).sum(dim=1)
