"""Shared kernel plumbing: the Hopper tile-height budget and the launch
counters.

Tile height. ``block_n`` rows form one tile: one CUDA thread block of the
seeding and assignment kernels, one per-tile partial, and the window the
``tiled`` sampler reads at its second level. Rows stream through registers,
so the height is not bounded by the point tile's bytes; what must fit in a
block's shared memory is the assignment kernel's staging (the (k, d)
centroid block, the (k,) centroid norms, two reduction buffers, one
(k, cols) cluster-sum accumulator per warp with cols >= 1, and the tile's
labels; the gated assignment kernel K6 stages the (k,) centroid movement on
top). The height is budgeted for K6, the larger of the two, so gated and
ungated runs share one tile geometry. The batched kernels (K7, K10a) run
one such block per problem and tile, with the same staging, so a batched
problem is tiled as the single one. The budget is Hopper's 227 KB per
block; TPU VMEM budgets do not apply.

Launch counters. Each wrapper adds one to its kernel's counter where it
launches the kernel on the card, and nowhere else (the CPU path, which runs
the plain twin, does not count), so a run can prove its main path went
through the kernels.
"""
from __future__ import annotations

import torch

THREADS = 256            # threads per block of both kernels (csrc/*.cu)
SMEM_LIMIT = 232_448     # bytes of shared memory one Hopper block can use
MAX_BLOCK = 4096
WARPS = THREADS // 32

LAUNCHES: dict[str, int] = {"seed_prologue": 0,
                            "distance_min_update": 0,
                            "lloyd_assign_tiled": 0,
                            "distance_min_update_gated": 0,
                            "lloyd_assign_gated": 0,
                            "row_min_d2": 0,
                            "tile_cap": 0,
                            "distance_min_update_batched": 0,
                            "lloyd_assign_tiled_batched": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def check_card_tensors(dtype=None, **tensors) -> None:
    """What a kernel takes: contiguous tensors of ``dtype`` (float32 unless
    given); raises ValueError naming the first that is not."""
    want = torch.float32 if dtype is None else dtype
    for name, t in tensors.items():
        if t.dtype != want or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {want}, got "
                             f"{t.dtype} contiguous={t.is_contiguous()}")


def seed_smem_bytes(d: int, m: int, resident: bool,
                    gated: bool = False) -> int:
    """Shared memory of the seeding kernel: the reduction buffer (three for
    the gated K5: sum, max, pruned count), plus the staged (m, d) centroid
    block and its (m,) norms when resident."""
    return 4 * ((3 if gated else 1) * THREADS
                + ((m * d + m) if resident else 0))


def assign_smem_bytes(d: int, k: int, block_n: int, cols: int = 1,
                      gated: bool = False) -> int:
    """Shared memory of the assignment kernel: (k, d) centroids, (k,) norms,
    two (THREADS,) reduction buffers, one (k, cols) cluster-sum accumulator
    per warp and the tile's (block_n,) labels; ``gated`` (K6) adds the
    staged (k,) centroid movement."""
    return 4 * (k * d + k + 2 * THREADS + WARPS * k * cols + block_n
                + (k if gated else 0))


def assign_cols(d: int, k: int, block_n: int, gated: bool = False) -> int:
    """How many of the d + 1 cluster-sum columns (d coordinates and the
    count) the assignment kernel accumulates per pass over a tile: as many
    as fit the shared-memory budget, at most d + 1; 0 when not even one
    fits."""
    fixed = assign_smem_bytes(d, k, block_n, cols=0, gated=gated)
    return max(0, min(d + 1, (SMEM_LIMIT - fixed) // (4 * WARPS * k)))


def choose_block_n(n: int, d: int, k: int) -> int:
    """Point-tile height for an (n, d) x (k, d) problem: the largest power of
    two up to ``MAX_BLOCK`` whose gated assignment-kernel staging (K6, a
    superset of K3's) fits the Hopper shared-memory budget, clamped down to
    the largest power of two <= n and floored at 128 (ragged tails are
    masked in the kernels)."""
    bn = MAX_BLOCK
    while bn > 128 and assign_cols(d, k, bn, gated=True) < 1:
        bn //= 2
    if n >= bn:
        return bn
    return max(128, 1 << (max(n, 1).bit_length() - 1))
