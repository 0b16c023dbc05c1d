"""K13 and K14 — the gated cluster-local IVF scan, exact and PQ/ADC (port of
``repro.kernels.ivf_scan``'s ``ivf_scan_pallas`` and
``ivf_adc_scan_pallas``), with their plain twins and the brute-force
oracle (``repro.kernels.ref``'s ``ivf_scan_ref``, ``ivf_adc_scan_ref``
and ``ivf_bruteforce_topk``).

A trained k-means model is an inverted-file index (``serve.ivf``). For
each query the scan walks its compacted probed tiles (``ids``, the first
``n_active`` of a row; ``bounds.compact_ids``) in order. Before a tile it
evaluates the kth-distance ball gate (``bounds.ivf_gate_skip`` against
the carried k-th D²) and counts a skip; otherwise it scores the tile's
rows and merges them into the carried top-k by the key (D², row)
(``core.topk``). Rows past n never enter. Two scorings share the walk:

* exact (K13): ``max(‖x‖² − 2 x·q + ‖q‖², 0)`` over the label-sorted rows
  and their cached norms;
* PQ/ADC (K14): ``max(‖q‖² − 2 (q·r̂ + q·c_list) + ‖x̂‖², 0)``, the exact
  distance to the reconstructed row x̂ = c_list + decode(code), from the
  per-query LUT (``q·r̂ = Σ_s lut[s, code_s]``), the routing dots
  (``q·c_list = qdots[label]``) and ``u = ‖x̂‖²``; the gate then reads the
  balls over the reconstructed rows.

One arithmetic for kernel, twin and oracle: ‖q‖², ‖c‖² and the gate's
d(q, c)² add the columns in ascending order (``bounds.point_norms``); x·q
is an ascending chain of fused multiply-adds (``bounds._dots``); the LUT
sum adds in ascending sub-space order. So the scan at ``nprobe == nlist``
is the oracle bitwise, and the twins follow the kernels' bits wherever
the card's ``addcmul`` rounds as ``fmaf``.

Each wrapper launches its CUDA kernels (``csrc/ivf_scan.cu``) for tensors
on the card and runs its twin (``*_torch``) only for tensors on the CPU.
Both run in two parts that together give the walk's bits: (a) every
(query, step) pair's top-k of its tile (K13: the pairs grouped by tile, so
that a block reads a tile's rows once for up to 64 queries, plain
:func:`tile_topk_torch`; K14: a block per query, its LUT staged once and
its warps taking its pairs in turn, plain :func:`adc_tile_topk_torch`),
then (b) each query's walk over its steps, the gate against the carried
k-th key and the merge of the step's top-k (one kernel for both, plain
:func:`replay_torch`). A tile's top-k merged gives the same top-k as all
its rows. Part (a)'s output
takes 8k bytes a pair; when the card has not the memory for every
query's pairs, the scan runs over consecutive groups of queries that fit
(:func:`query_groups`), which gives the same bits, since queries are
independent. Both wrappers take at most the k that part (b)'s block holds
(:func:`max_k`) and raise ``InvalidInputError`` naming that limit above
it.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core import bounds
from repro_torch.core.guards import InvalidInputError, KernelFailureError
from repro_torch.core.topk import (IDX_SENTINEL, init_topk, lex_topk,
                                   merge_topk)
from repro_torch.kernels import _build, ops

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_TOPK_ARGTYPES = (_P,) * 14 + (_I,) * 7 + (_F, _I, _P)
_REPLAY_ARGTYPES = (_P,) * 9 + (_I,) * 3 + (_F, _P)
_ADC_ARGTYPES = (_P,) * 17 + (_I,) * 11 + (_F, _I, _P)
# pairs a block of K13's part (a) takes (csrc/ivf_scan.cu: kPairs)
CHUNK = 64
# device bytes a (query, step) pair takes beside its top-k: its two gate
# terms and the glue's maps (the pair's int64 indices, tile and stable
# sort, its int32 copies)
PAIR_BYTES = 96
# the gate's fp32 constants, as the reference rounds them
_REL1 = float(np.float32(1.0 + bounds._REL))
_ABS = float(np.float32(bounds._ABS))


def replay_smem_bytes(k: int) -> int:
    """Dynamic shared memory of one block of the scans' part (b): the
    carried and the merged top-k, 8 bytes an entry each (the step's top-k
    is read from part (a)'s output in device memory)."""
    return 16 * k


def max_k(d: int, block_n: int, n_sub: int = 0, n_codes: int = 0,
          nlist: int = 0) -> int:
    """The largest k the scan takes: the k whose part-(b) block fits
    Hopper's shared memory (part (a) keeps a tile's top-k in registers up to
    k = 128 and ranks the tile's rows past it, in shared memory that does
    not grow with k; neither part has static shared memory). For K14
    (``n_sub > 0``) 0 when not even its one-query block (the LUT, the
    routing dots, the query and the tile's scores) fits."""
    if n_sub and 4 * (n_sub * n_codes + nlist + d + 2 * block_n) \
            > ops.SMEM_LIMIT:
        return 0
    return max(0, ops.SMEM_LIMIT // replay_smem_bytes(1))


def _check_k(k: int, limit: int) -> None:
    if not 1 <= k <= limit:
        raise InvalidInputError(
            f"the IVF scan takes 1 <= k <= {limit} here (one block's "
            f"{ops.SMEM_LIMIT} bytes of shared memory hold the carried "
            f"top-k and its merge buffer), got k={k}")


# ---------------------------------------------------------------------------
# plain twins and the oracle
# ---------------------------------------------------------------------------


def exact_scores(queries: torch.Tensor, points: torch.Tensor,
                 norms: torch.Tensor) -> torch.Tensor:
    """(Q, n) exact-path D²: ``max(‖x‖² − 2 x·q + ‖q‖², 0)``, ‖q‖²
    :func:`bounds.point_norms`, x·q the ascending FMA chain of
    ``bounds._dots`` over column-major copies of both operands (the same
    elementwise operations; each column a contiguous row, which the card's
    broadcast kernels read 10× faster than a strided column)."""
    q = queries.float()
    qn = bounds.point_norms(q)
    q_t, x_t = q.T.contiguous(), points.float().T.contiguous()
    dots = q_t[0][:, None] * x_t[0][None, :]
    for j in range(1, q_t.shape[0]):
        dots = torch.addcmul(dots, q_t[j][:, None], x_t[j][None, :])
    return torch.clamp_min(norms.float()[None, :] - 2.0 * dots
                           + qn[:, None], 0.0)


def adc_scores(queries: torch.Tensor, lut: torch.Tensor, qdots: torch.Tensor,
               codes: torch.Tensor, labels: torch.Tensor,
               u: torch.Tensor) -> torch.Tensor:
    """(Q, n) ADC D²: ``max(‖q‖² − 2 (q·r̂ + q·c_list) + u, 0)``, q·r̂ the
    gathered LUT values added in ascending sub-space order."""
    qn = bounds.point_norms(queries.float())
    lut = lut.float()
    cd = codes.long()
    qr = lut[:, 0, :][:, cd[:, 0]]
    for s in range(1, cd.shape[1]):
        qr = qr + lut[:, s, :][:, cd[:, s]]
    qc = qdots.float()[:, labels.long()]
    return torch.clamp_min(qn[:, None] - 2.0 * (qr + qc)
                           + u.float()[None, :], 0.0)


def _walk(cands, queries: torch.Tensor, centers: torch.Tensor,
          radii: torch.Tensor, ids: torch.Tensor, n_active: torch.Tensor, *,
          k: int, gate: bool):
    """The scan's walk, all queries a step at a time: the gate against each
    query's carried k-th D², then step i's candidates ``cands(i, t)`` ((Q,
    m) D² and rows of the tiles t = ids[:, i]) merged into its top-k
    (:func:`core.topk.merge_topk`). Returns (dists (Q, k), rows (Q, k),
    gate_skipped (Q,))."""
    nq = queries.shape[0]
    dev = queries.device
    q = queries.float()
    qn = bounds.point_norms(q)
    ctr, rad = centers.float(), radii.float()
    cn = bounds.point_norms(ctr).sqrt()
    if gate:   # d(q, center) of every (query, tile), the kernel's sums
        dc = bounds.point_norms(ctr[None, :, :] - q[:, None, :]).sqrt()
    ids, n_active = ids.long(), n_active.long()
    tv, ti = init_topk(k, (nq,), dev)
    skipped = torch.zeros(nq, dtype=torch.int32, device=dev)
    steps = int(n_active.max()) if nq else 0
    for i in range(steps):
        t = ids[:, i]
        visit = i < n_active
        if gate:
            skip = bounds.ivf_gate_skip(dc.gather(1, t[:, None])[:, 0],
                                        rad[t], cn[t], qn, tv[:, k - 1])
        else:
            skip = torch.zeros_like(visit)
        skipped += (visit & skip).to(torch.int32)
        cv, ci = cands(i, t)
        mv, mi = merge_topk(tv, ti, cv, ci, k)
        keep = (visit & ~skip)[:, None]
        tv, ti = torch.where(keep, mv, tv), torch.where(keep, mi, ti)
    return tv, ti, skipped


def _tile_rows(scores: torch.Tensor, block_n: int):
    """``cands`` for :func:`_walk`: every row of each query's tile, from
    precomputed (Q, n) scores; rows past n are (+inf, INT32_MAX)."""
    n = scores.shape[1]
    iota = torch.arange(block_n, device=scores.device)

    def cands(i, t):
        rows = t[:, None] * block_n + iota[None, :]
        valid = rows < n
        return (torch.where(valid, scores.gather(1, rows.clamp_max(n - 1)),
                            torch.inf),
                torch.where(valid, rows, IDX_SENTINEL))
    return cands


def _pairs(n_active: torch.Tensor, n_tiles: int):
    """The (query, step) pairs of the probe maps, query-major, steps
    ascending: (query (P,), step (P,)) int64."""
    steps = torch.arange(n_tiles, device=n_active.device)
    return (steps[None, :] < n_active.long()[:, None]).nonzero(as_tuple=True)


def tile_topk_torch(queries, points, norms, ids, n_active, *, k: int,
                    block_n: int):
    """Plain version of K13's part (a): for every (query, step) pair with
    step < n_active (query-major, :func:`_pairs`), the lexicographic top-k
    (D², row) of the rows of tile ``ids[query, step]``, skipped tiles
    included, in :func:`exact_scores`' arithmetic; unfilled slots (+inf,
    INT32_MAX). Returns (dists (P, k), rows (P, k) int32)."""
    return _pair_topk(exact_scores(queries, points, norms), ids, n_active,
                      k=k, block_n=block_n)


def _pair_topk(scores, ids, n_active, *, k: int, block_n: int):
    """Every (query, step) pair's lexicographic top-k (D², row) of its
    tile's rows, from (Q, n) ``scores``; unfilled slots (+inf, INT32_MAX)."""
    n = scores.shape[1]
    pq, ps = _pairs(n_active, ids.shape[1])
    t = ids.long()[pq, ps]
    rows = t[:, None] * block_n + torch.arange(block_n, device=t.device)
    valid = rows < n
    cv = torch.where(valid, scores[pq[:, None], rows.clamp_max(n - 1)],
                     torch.inf)
    tv, ti = lex_topk(cv, torch.where(valid, rows, IDX_SENTINEL), k)
    if tv.shape[1] < k:
        pad_v, pad_i = init_topk(k - tv.shape[1], (tv.shape[0],), tv.device)
        tv, ti = torch.cat([tv, pad_v], 1), torch.cat([ti, pad_i], 1)
    return tv, ti


def adc_tile_topk_torch(queries, lut, qdots, codes, labels, u, ids,
                        n_active, *, k: int, block_n: int):
    """Plain version of K14's part (a): :func:`tile_topk_torch` with
    :func:`adc_scores` for the rows' D². Returns (dists (P, k), rows (P, k)
    int32), the pairs query-major (:func:`_pairs`)."""
    return _pair_topk(adc_scores(queries, lut, qdots, codes, labels, u), ids,
                      n_active, k=k, block_n=block_n)


def replay_torch(cand_d, cand_r, queries, centers, radii, ids, n_active, *,
                 k: int, gate: bool = True):
    """Plain version of the scans' part (b), K13's and K14's: the walk of
    :func:`_walk` with each step's candidates the pair's tile top-k
    (``cand_d``/``cand_r`` (P, k), :func:`tile_topk_torch`'s order) and the
    gate over ``centers``/``radii`` (K14: the balls over the reconstructed
    rows). Returns the :func:`ivf_scan` triple."""
    act = n_active.long()
    start = torch.cumsum(act, 0) - act
    last = max(cand_d.shape[0] - 1, 0)

    def cands(i, t):
        p = (start + i).clamp_max(last)
        return cand_d[p], cand_r[p]
    return _walk(cands, queries, centers, radii, ids, n_active, k=k,
                 gate=gate)


def ivf_scan_torch(queries, points, norms, centers, radii, ids, n_active, *,
                   k: int, block_n: int, gate: bool = True):
    """Plain twin of K13 (``repro.kernels.ref.ivf_scan_ref``): same
    arguments and returns as :func:`ivf_scan`."""
    return _walk(_tile_rows(exact_scores(queries, points, norms), block_n),
                 queries, centers, radii, ids, n_active, k=k, gate=gate)


def ivf_adc_scan_torch(queries, lut, qdots, codes, labels, u, centers, radii,
                       ids, n_active, *, k: int, block_n: int,
                       gate: bool = True):
    """Plain twin of K14 (``repro.kernels.ref.ivf_adc_scan_ref``): same
    arguments and returns as :func:`ivf_adc_scan`."""
    return _walk(_tile_rows(adc_scores(queries, lut, qdots, codes, labels, u),
                            block_n),
                 queries, centers, radii, ids, n_active, k=k, gate=gate)


def ivf_bruteforce_topk(queries: torch.Tensor, points: torch.Tensor,
                        norms: torch.Tensor, *, k: int):
    """The oracle: every query against every row, one lexicographic top-k,
    in the scan's arithmetic (``repro.kernels.ref.ivf_bruteforce_topk``).
    Returns (dists (Q, k), rows (Q, k) int32)."""
    d2 = exact_scores(queries, points, norms)
    rows = torch.arange(points.shape[0], dtype=torch.int32, device=d2.device)
    return lex_topk(d2, rows.expand(d2.shape), k)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


def _check_maps(q, centers, radii, ids, n_active, block_n, n):
    nq, d = q.shape
    t = centers.shape[0]
    if centers.shape != (t, d) or radii.shape != (t,):
        raise ValueError(f"tile balls {tuple(centers.shape)} / "
                         f"{tuple(radii.shape)} do not match d={d}")
    if t != -(-n // block_n):
        raise ValueError(f"{t} tile balls for n={n} rows of block_n="
                         f"{block_n}")
    if ids.shape != (nq, t) or n_active.shape != (nq,):
        raise ValueError(f"ids {tuple(ids.shape)} / n_active "
                         f"{tuple(n_active.shape)} must be ({nq}, {t}) / "
                         f"({nq},)")


def _outputs(nq: int, k: int, device):
    return (torch.empty((nq, k), dtype=torch.float32, device=device),
            torch.empty((nq, k), dtype=torch.int32, device=device),
            torch.empty(nq, dtype=torch.int32, device=device))


def _pair_maps(ids: torch.Tensor, n_active: torch.Tensor) -> dict:
    """K13's glue on the device: the probe maps inverted into (query, step)
    pairs (query-major, :func:`_pairs`), their tiles, the pairs sorted by
    tile (a stable sort, so a tile's pairs keep query order) and cut into
    chunks of at most :data:`CHUNK` pairs of one tile, and each query's
    first pair. Integer sums only (exact)."""
    nq, n_tiles = ids.shape
    dev = ids.device
    pq, ps = _pairs(n_active, n_tiles)
    tiles = ids.long()[pq, ps]
    order = torch.sort(tiles, stable=True).indices
    counts = torch.bincount(tiles, minlength=n_tiles)
    n_chunks = -(-counts // CHUNK)
    chunk_tile = torch.repeat_interleave(
        torch.arange(n_tiles, device=dev), n_chunks)
    first = (torch.cumsum(n_chunks, 0) - n_chunks)[chunk_tile]
    within = torch.arange(chunk_tile.shape[0], device=dev) - first
    tile_start = torch.cumsum(counts, 0) - counts
    i32 = torch.int32
    return dict(
        pair_query=pq.to(i32), pair_tile=tiles.to(i32), order=order.to(i32),
        chunk_start=(tile_start[chunk_tile] + CHUNK * within).to(i32),
        chunk_count=torch.clamp_max(counts[chunk_tile] - CHUNK * within,
                                    CHUNK).to(i32),
        pair_start=_pair_start(n_active))


def _pair_start(n_active: torch.Tensor) -> torch.Tensor:
    """Each query's first (query, step) pair, query-major (int32)."""
    act = n_active.long()
    return (torch.cumsum(act, 0) - act).to(torch.int32)


def query_groups(n_active: torch.Tensor, max_pairs: int) -> list:
    """Consecutive query ranges [a, b), each with at most ``max_pairs``
    (query, step) pairs (Σ n_active), the first as long as it can be; one
    range [0, Q) when all fit. Raises ``InvalidInputError`` when one query
    alone has more."""
    cum = torch.cumsum(n_active.long().cpu(), 0)
    groups, a, base = [], 0, 0
    while a < cum.shape[0]:
        b = int(torch.searchsorted(cum, base + max_pairs, right=True))
        if b == a:
            raise InvalidInputError(
                f"query {a} probes {int(cum[a]) - base} tiles, but the card "
                f"has memory for the scan's scratch of {max_pairs} at this "
                f"k; search with a smaller k or nprobe")
        groups.append((a, b))
        a, base = b, int(cum[b - 1])
    return groups or [(0, 0)]


def _free_bytes(device) -> int:
    """Device memory the scans' scratch can take: the card's free memory
    and what the caching allocator holds reserved but unused."""
    return (torch.cuda.mem_get_info(device)[0]
            + torch.cuda.memory_reserved(device)
            - torch.cuda.memory_allocated(device))


def _scratch(n_pairs: int, k: int, device) -> tuple:
    """Part (a)'s outputs: each pair's top-k and its two gate terms."""
    return (torch.empty((n_pairs, k), dtype=torch.float32, device=device),
            torch.empty((n_pairs, k), dtype=torch.int32, device=device),
            torch.empty(n_pairs, dtype=torch.float32, device=device),
            torch.empty(n_pairs, dtype=torch.float32, device=device))


def _launch_topk(queries, points, norms, centers, radii, maps, k, block_n,
                 gate):
    """K13's part (a) on the card: (cand_d, cand_r, gate_lo2,
    gate_margin)."""
    n, d = points.shape
    n_pairs = maps["order"].shape[0]
    out = _scratch(n_pairs, k, queries.device)
    fn = _build.function("ivf_scan", "ivf_tile_topk_launch", _TOPK_ARGTYPES)
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(queries.data_ptr(), points.data_ptr(), norms.data_ptr(),
                 centers.data_ptr(), radii.data_ptr(),
                 *(maps[f].data_ptr() for f in (
                     "pair_query", "pair_tile", "order", "chunk_start",
                     "chunk_count")),
                 *(o.data_ptr() for o in out), n_pairs,
                 maps["chunk_start"].shape[0], n, d, block_n, k, int(gate),
                 _ABS, ops.SMEM_LIMIT, stream)
    if err != 0:
        raise KernelFailureError(
            f"ivf_scan (tile top-k) launch failed: cudaError {err}")
    return out


def _launch_adc_topk(queries, lut, qdots, codes, labels, u, centers, radii,
                     ids, n_active, pair_start, k, block_n, gate):
    """K14's part (a) on the card, one block per query: (cand_d, cand_r,
    gate_lo2, gate_margin), the pairs query-major (``pair_start``)."""
    n, n_sub = codes.shape
    nq, d = queries.shape
    n_pairs = int(n_active.sum())
    out = _scratch(n_pairs, k, queries.device)
    # the rank path (k past the register lists) takes one block per pair
    rank = k > 128 or (n_sub * lut.shape[2]) % 4 != 0
    pq, ps = _pairs(n_active, ids.shape[1]) if rank else (None, None)
    pair_query = None if pq is None else pq.to(torch.int32)
    pair_tile = None if pq is None else ids.long()[pq, ps].to(torch.int32)
    fn = _build.function("ivf_scan", "ivf_adc_tile_topk_launch",
                         _ADC_ARGTYPES)
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(queries.data_ptr(), lut.data_ptr(), qdots.data_ptr(),
                 codes.data_ptr(), labels.data_ptr(), u.data_ptr(),
                 centers.data_ptr(), radii.data_ptr(), ids.data_ptr(),
                 n_active.data_ptr(), pair_start.data_ptr(),
                 None if pair_query is None else pair_query.data_ptr(),
                 None if pair_tile is None else pair_tile.data_ptr(),
                 *(o.data_ptr() for o in out), nq, n_pairs, n, d,
                 ids.shape[1], block_n, k, int(gate), n_sub, lut.shape[2],
                 qdots.shape[1], _ABS, ops.SMEM_LIMIT, stream)
    if err != 0:
        raise KernelFailureError(
            f"ivf_adc_scan (tile top-k) launch failed: cudaError {err}")
    return out


def _two_part(name, glue, part_a, queries, ids, n_active, k, gate):
    """The scans on the card: for each group of queries whose scratch fits
    (:func:`query_groups`), the glue (``glue(ids, n_active)``, a dict with
    each query's ``pair_start``), part (a) (``part_a(a, b, maps)``, the
    group's queries [a, b)) and part (b), counted once under ``name``."""
    out = _outputs(queries.shape[0], k, queries.device)
    fn = _build.function("ivf_scan", "ivf_replay_launch", _REPLAY_ARGTYPES)
    budget = _free_bytes(queries.device) // (8 * k + PAIR_BYTES)
    for a, b in query_groups(n_active, budget):
        act = n_active[a:b]
        maps = glue(ids[a:b], act)
        cand = part_a(a, b, maps)
        with torch.cuda.device(queries.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(*(c.data_ptr() for c in cand),
                     maps["pair_start"].data_ptr(), act.data_ptr(),
                     *(o[a:b].data_ptr() for o in out), b - a, k, int(gate),
                     _REL1, stream)
        if err != 0:
            raise KernelFailureError(
                f"{name} (replay) launch failed: cudaError {err}")
        ops.LAUNCHES[name] += 1
        del maps, cand
    return out


def _check_card(queries, points, norms, centers, radii, ids, n_active):
    ops.check_card_tensors(queries=queries, points=points, norms=norms,
                           centers=centers, radii=radii)
    ops.check_card_tensors(torch.int32, ids=ids, n_active=n_active)


def ivf_scan(queries: torch.Tensor, points: torch.Tensor, norms: torch.Tensor,
             centers: torch.Tensor, radii: torch.Tensor, ids: torch.Tensor,
             n_active: torch.Tensor, *, k: int, block_n: int,
             gate: bool = True):
    """The exact gated scan. queries (Q, d); points (n, d) label-sorted;
    norms (n,) cached fp32 ‖x‖²; centers/radii the (T, d)/(T,) tile balls
    at ``block_n``; ids (Q, T) / n_active (Q,) int32 the probed-tile maps.
    Returns ``(dists (Q, k) fp32, rows (Q, k) int32 into the sorted rows,
    gate_skipped (Q,) int32)``; unfilled slots hold ``(+inf, INT32_MAX)``.
    On the card this launches K13 (its glue, part (a) and part (b), one
    counted launch for each group of queries, :func:`query_groups`); CPU
    tensors take the plain twin."""
    n, d = points.shape
    _check_maps(queries, centers, radii, ids, n_active, block_n, n)
    _check_k(k, max_k(d, block_n))
    if queries.device.type == "cpu":
        return ivf_scan_torch(queries, points, norms, centers, radii, ids,
                              n_active, k=k, block_n=block_n, gate=gate)
    if queries.device.type != "cuda":
        raise ValueError(f"unsupported device {queries.device}")
    _check_card(queries, points, norms, centers, radii, ids, n_active)
    return _two_part(
        "ivf_scan", _pair_maps, lambda a, b, maps: _launch_topk(
            queries[a:b], points, norms, centers, radii, maps, k, block_n,
            gate), queries, ids, n_active, k, gate)


def ivf_adc_scan(queries: torch.Tensor, lut: torch.Tensor,
                 qdots: torch.Tensor, codes: torch.Tensor,
                 labels: torch.Tensor, u: torch.Tensor,
                 centers: torch.Tensor, radii: torch.Tensor, ids: torch.Tensor,
                 n_active: torch.Tensor, *, k: int, block_n: int,
                 gate: bool = True):
    """The PQ/ADC gated scan. lut (Q, n_sub, n_codes) with ``lut[q, s, c] =
    q_s · codebook[s, c]``; qdots (Q, nlist) the routing dots; codes (n,
    n_sub) uint8; labels (n,) int32 list per sorted row; u (n,) fp32
    ‖x̂‖²; centers/radii the balls over the reconstructed rows. Returns the
    :func:`ivf_scan` triple. On the card this launches K14 (its glue, part
    (a) and part (b), one counted launch for each group of queries); CPU
    tensors take the plain twin."""
    n, n_sub = codes.shape
    nq, d = queries.shape
    n_codes, nlist = lut.shape[2], qdots.shape[1]
    _check_maps(queries, centers, radii, ids, n_active, block_n, n)
    if lut.shape != (nq, n_sub, n_codes) or qdots.shape != (nq, nlist) \
            or labels.shape != (n,) or u.shape != (n,):
        raise ValueError(f"lut {tuple(lut.shape)}, qdots "
                         f"{tuple(qdots.shape)}, labels {tuple(labels.shape)}"
                         f" and u {tuple(u.shape)} do not match {nq} queries "
                         f"and codes {tuple(codes.shape)}")
    _check_k(k, max_k(d, block_n, n_sub, n_codes, nlist))
    if queries.device.type == "cpu":
        return ivf_adc_scan_torch(queries, lut, qdots, codes, labels, u,
                                  centers, radii, ids, n_active, k=k,
                                  block_n=block_n, gate=gate)
    if queries.device.type != "cuda":
        raise ValueError(f"unsupported device {queries.device}")
    ops.check_card_tensors(queries=queries, lut=lut, qdots=qdots, u=u,
                           centers=centers, radii=radii)
    ops.check_card_tensors(torch.uint8, codes=codes)
    ops.check_card_tensors(torch.int32, labels=labels, ids=ids,
                           n_active=n_active)
    return _two_part(
        "ivf_adc_scan", lambda i, act: {"pair_start": _pair_start(act)},
        lambda a, b, maps: _launch_adc_topk(
            queries[a:b], lut[a:b], qdots[a:b], codes, labels, u, centers,
            radii, ids[a:b], n_active[a:b], maps["pair_start"], k, block_n,
            gate), queries, ids, n_active, k, gate)
