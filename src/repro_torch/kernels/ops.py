"""Shared kernel plumbing: the Hopper tile-height budget, the launch
counters, and ``lloyd_assign``, the untiled assignment round's entry (K4,
or K9 for a batch of problems).

Tile height. ``block_n`` rows form one tile: one CUDA thread block of the
seeding and assignment kernels, one per-tile partial, and the window the
``tiled`` sampler reads at its second level. Rows stream through registers,
so the height is not bounded by the point tile's bytes; what must fit in a
block's shared memory is the assignment kernel's staging (the (k, d)
centroid block, the (k,) centroid norms, two reduction buffers, one
(k, cols) cluster-sum accumulator per warp with cols >= 1, and the tile's
labels; the gated assignment kernel K6 stages the (k,) centroid movement on
top). The height is budgeted for K6, the larger of the two, so gated and
ungated runs share one tile geometry. The batched kernels (K1's batched
form, K7, K8, K10a, K10b) run one such block per problem and tile, with the
same staging, so a batched problem is tiled as the single one; K10a and
K10b at d >= 8 (their screened route) keep these tiles and this ``cols``
for their sums and budget their own staging. The budget is Hopper's 227 KB
per block; TPU VMEM budgets do not apply. Past the point where K6's
template fits at 128 rows, the height is the largest (the chunked routes
fit it; ``choose_block_n``), and each wrapper asks the CUDA source for its
route and that route's largest k (``lloyd_assign._route``).

The rounds run the screened route at d >= 8 within the screened widths
and row passes at every other width (K6 and K10b the split row pass), all
on these tiles for the sums' bits; none stages the whole (k, d) block.

The IVF scan (K13, K14; ``ivf_scan.py``) runs in two parts and budgets its
own shared memory (``ivf_scan.max_k``); its tile height is the index's.
The attention kernels (K15, K16; ``flash_attention.py``,
``pq_decode.py``) take their tiles from their own sources and check their
inputs with :func:`check_inputs`. K16 and the hier round's tile envelope
(K12's ``kmeans_distance.tile_envelope``) count their blocks' arrivals in
counters :func:`arrivals` keeps.

Launch counters. Each wrapper adds one to its kernel's counter where it
launches the kernel on the card, and nowhere else (the CPU path, which runs
the plain twin, does not count), so a run can prove its main path went
through the kernels. The seeding and assignment rounds (K2–K10b) count a
launch on a bf16 point stream under their name with ``_bf16`` appended.

Point streams. The seeding and assignment kernels read points and
centroids as fp32 or as bf16 (the engine's ``precision="bf16"``), both of
one dtype (:func:`stream_is_bf16`); everything else they read or write
(norms, D², partials, gates, sums) is fp32. :func:`check_round_tensors`
is a round wrapper's check of both before a launch.
"""
from __future__ import annotations

import torch

from repro_torch.core.guards import InvalidInputError

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
                            "lloyd_assign_tiled_batched": 0,
                            "seed_prologue_batched": 0,
                            "distance_min_update_gated_batched": 0,
                            "lloyd_assign_gated_batched": 0,
                            "lloyd_assign": 0,
                            "lloyd_assign_batched": 0,
                            "ivf_scan": 0,
                            "ivf_adc_scan": 0,
                            "pq_decode_attention": 0,
                            "flash_attention": 0,
                            "flash_attention_bf16": 0}
# the seeding and assignment rounds' bf16 instances
ROUND_KERNELS = ("distance_min_update", "distance_min_update_gated",
                 "distance_min_update_batched",
                 "distance_min_update_gated_batched", "lloyd_assign_tiled",
                 "lloyd_assign_gated", "lloyd_assign_tiled_batched",
                 "lloyd_assign_gated_batched", "lloyd_assign",
                 "lloyd_assign_batched")
LAUNCHES.update({f"{name}_bf16": 0 for name in ROUND_KERNELS})


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# arrival counters of the kernels whose last block to finish does the
# final step (K16's merge, the tile envelope's count), one set per
# (kernel, device, stream): all 0 between launches, since the last block
# wraps each count back to 0, so no launch resets them
_ARRIVALS: dict = {}


def arrivals(key: tuple, n: int) -> torch.Tensor:
    """At least ``n`` int32 arrival counters for ``key`` = (kernel name,
    device index, stream), made zeroed on first use (or when more are
    needed) and kept."""
    have = _ARRIVALS.get(key)
    if have is None or have.numel() < n:
        have = torch.zeros(max(n, 64), dtype=torch.int32,
                           device=torch.device("cuda", key[1]))
        _ARRIVALS[key] = have
    return have


def drop_arrivals(key: tuple) -> None:
    """After a failed launch, which may leave a count behind: the next
    launch of ``key`` starts from fresh zeroed counters."""
    _ARRIVALS.pop(key, None)


def check_inputs(device, **tensors) -> None:
    """What the attention wrappers (K15, K16) take on either device: every
    tensor on ``device`` and contiguous; raises ``InvalidInputError``
    naming the first that is not."""
    for name, t in tensors.items():
        if t.device != device:
            raise InvalidInputError(f"{name} is on {t.device}, not on "
                                    f"{device} with the query")
        if not t.is_contiguous():
            raise InvalidInputError(f"{name} must be contiguous")


def check_card_tensors(dtype=None, **tensors) -> None:
    """What a kernel takes: contiguous tensors of ``dtype`` (float32 unless
    given: norms, D², weights and every gate array are fp32 whatever the
    point stream); raises ValueError naming the first that is not."""
    want = torch.float32 if dtype is None else dtype
    for name, t in tensors.items():
        if t.dtype != want or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {want}, got "
                             f"{t.dtype} contiguous={t.is_contiguous()}")


def stream_is_bf16(points: torch.Tensor, centroids: torch.Tensor) -> bool:
    """Whether a seeding or assignment round reads a bf16 point stream:
    ``points`` and ``centroids`` must share one dtype, float32 or bfloat16
    on the card (any one dtype on the CPU, where the plain twins widen
    it). Raises ValueError for mixed dtypes or another dtype on the card."""
    if points.dtype != centroids.dtype:
        raise ValueError(f"points ({points.dtype}) and centroids "
                         f"({centroids.dtype}) must share one dtype")
    if points.device.type == "cuda" and points.dtype not in (
            torch.float32, torch.bfloat16):
        raise ValueError(f"the kernels read float32 or bfloat16 points, "
                         f"got {points.dtype}")
    return points.dtype == torch.bfloat16


def check_round_tensors(points: torch.Tensor, centroids: torch.Tensor,
                        **fp32) -> bool:
    """The card's checks of a seeding or assignment round: the stream
    (points and centroids, one dtype, contiguous) and the fp32 arrays
    ``fp32``. Returns whether the stream is bf16."""
    bf16 = stream_is_bf16(points, centroids)
    check_card_tensors(points.dtype, points=points, centroids=centroids)
    check_card_tensors(**fp32)
    return bf16


def count_launch(name: str, bf16: bool) -> None:
    """Adds one to the counter of round kernel ``name``'s fp32 or bf16
    instance."""
    LAUNCHES[f"{name}_bf16" if bf16 else name] += 1


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


def template_max_k(d: int, block_n: int, gated: bool = False) -> int:
    """The most centroids the template (``assign_smem_bytes`` at one
    column) stages at width ``d`` and height ``block_n``: the limit of the
    template entries (``lloyd_assign.*_template``), which raise past it. No
    round takes the template."""
    return max(0, (SMEM_LIMIT // 4 - 2 * THREADS - block_n)
               // (d + 1 + WARPS + int(gated)))


def choose_block_n(n: int, d: int, k: int) -> int:
    """Point-tile height for an (n, d) x (k, d) problem: the largest power of
    two up to ``MAX_BLOCK`` whose gated assignment-kernel staging (K6's
    template, a superset of K3's) fits the Hopper shared-memory budget;
    where not even 128 rows fit, ``MAX_BLOCK`` at d <= 128, where the
    rounds' routes on either stream (the screen, the row passes) stage
    centroids in chunks and fit every height up to it (pass B holds one
    tile's labels beside one k-chunk). Then clamped down to the largest
    power of two <= n and floored at 128 (ragged tails are masked in the
    kernels)."""
    bn = MAX_BLOCK
    while bn > 128 and assign_cols(d, k, bn, gated=True) < 1:
        bn //= 2
    if assign_cols(d, k, bn, gated=True) < 1 and d <= 128:
        bn = MAX_BLOCK
    if n >= bn:
        return bn
    return max(128, 1 << (max(n, 1).bit_length() - 1))


def lloyd_assign(points: torch.Tensor, centroids: torch.Tensor, *,
                 norms: torch.Tensor | None = None,
                 weights: torch.Tensor | None = None):
    """The untiled assignment round: labels, D², and the cluster sums and
    counts over all rows (each row weighted by ``weights`` (n,) when
    given). (n, d) points go to K4, (B, n, d) points with (B, k, d)
    centroids to K9, one launch for all B (the reference's ``custom_vmap``
    rule); batched problems take no weights. ``norms`` are the cached fp32
    ‖x‖², computed here when absent. The tile height is ``choose_block_n``'s
    pick; the wrappers check that their route takes k."""
    from repro_torch.core.bounds import point_norms
    from repro_torch.kernels import lloyd_assign as la

    n, d = points.shape[-2:]
    block_n = choose_block_n(n, d, centroids.shape[-2])
    if norms is None:
        norms = point_norms(points)
    if points.dim() == 3:
        if weights is not None:
            raise ValueError("batched problems take no weights")
        return la.lloyd_assign_batched(points, norms, centroids,
                                       block_n=block_n)
    return la.lloyd_assign(points, norms, centroids, weights,
                           block_n=block_n)
