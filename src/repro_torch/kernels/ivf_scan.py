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

Each wrapper launches its CUDA kernel (``csrc/ivf_scan.cu``) for tensors on
the card and runs its twin (``*_torch``) only for tensors on the CPU. Both
take at most the k that one block's shared memory holds
(:func:`max_k`) and raise ``InvalidInputError`` naming that limit above it.
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
_SCAN_ARGTYPES = (_P,) * 10 + (_I,) * 7 + (_F,) * 2 + (_P,)
_ADC_ARGTYPES = (_P,) * 13 + (_I,) * 10 + (_F,) * 2 + (_P,)
# the gate's fp32 constants, as the reference rounds them
_REL1 = float(np.float32(1.0 + bounds._REL))
_ABS = float(np.float32(bounds._ABS))
# the kernel's static shared memory: its three __shared__ scalars (n_cand,
# skip_flag, qn_s), which ptxas rounds to 16 bytes
STATIC_SMEM = 16


def smem_bytes(d: int, k: int, block_n: int, n_sub: int = 0,
               n_codes: int = 0, nlist: int = 0) -> int:
    """Dynamic shared memory of one scan block: the query (d), the carried
    and the merged top-k (4k), the tile's candidate buffer (2 block_n), and
    for K14 the LUT (n_sub·n_codes) and the routing dots (nlist); 4 bytes
    each. The block also holds :data:`STATIC_SMEM`."""
    return 4 * (d + 4 * k + 2 * block_n + n_sub * n_codes + nlist)


def max_k(d: int, block_n: int, n_sub: int = 0, n_codes: int = 0,
          nlist: int = 0) -> int:
    """The largest k whose scan block, static shared memory included, fits
    Hopper's shared memory."""
    free = (ops.SMEM_LIMIT - STATIC_SMEM
            - smem_bytes(d, 0, block_n, n_sub, n_codes, nlist))
    return max(0, free // 16)


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


def _walk(scores: torch.Tensor, queries: torch.Tensor, centers: torch.Tensor,
          radii: torch.Tensor, ids: torch.Tensor, n_active: torch.Tensor, *,
          k: int, block_n: int, gate: bool):
    """The scan's walk over precomputed (Q, n) scores, all queries a step
    at a time: the gate against each query's carried k-th D², then the
    tile's rows merged into its top-k (:func:`core.topk.merge_topk`).
    Returns (dists (Q, k), rows (Q, k), gate_skipped (Q,))."""
    nq, n = scores.shape
    dev = scores.device
    q = queries.float()
    qn = bounds.point_norms(q)
    ctr, rad = centers.float(), radii.float()
    cn = bounds.point_norms(ctr).sqrt()
    if gate:   # d(q, center) of every (query, tile), the kernel's sums
        dc = bounds.point_norms(ctr[None, :, :] - q[:, None, :]).sqrt()
    ids, n_active = ids.long(), n_active.long()
    tv, ti = init_topk(k, (nq,), dev)
    skipped = torch.zeros(nq, dtype=torch.int32, device=dev)
    iota = torch.arange(block_n, device=dev)
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
        rows = t[:, None] * block_n + iota[None, :]
        valid = rows < n
        cv = torch.where(valid, scores.gather(1, rows.clamp_max(n - 1)),
                         torch.inf)
        mv, mi = merge_topk(tv, ti, cv, torch.where(valid, rows,
                                                    IDX_SENTINEL), k)
        keep = (visit & ~skip)[:, None]
        tv, ti = torch.where(keep, mv, tv), torch.where(keep, mi, ti)
    return tv, ti, skipped


def ivf_scan_torch(queries, points, norms, centers, radii, ids, n_active, *,
                   k: int, block_n: int, gate: bool = True):
    """Plain twin of K13 (``repro.kernels.ref.ivf_scan_ref``): same
    arguments and returns as :func:`ivf_scan`."""
    return _walk(exact_scores(queries, points, norms), queries, centers,
                 radii, ids, n_active, k=k, block_n=block_n, gate=gate)


def ivf_adc_scan_torch(queries, lut, qdots, codes, labels, u, centers, radii,
                       ids, n_active, *, k: int, block_n: int,
                       gate: bool = True):
    """Plain twin of K14 (``repro.kernels.ref.ivf_adc_scan_ref``): same
    arguments and returns as :func:`ivf_adc_scan`."""
    return _walk(adc_scores(queries, lut, qdots, codes, labels, u), queries,
                 centers, radii, ids, n_active, k=k, block_n=block_n,
                 gate=gate)


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


def ivf_scan(queries: torch.Tensor, points: torch.Tensor, norms: torch.Tensor,
             centers: torch.Tensor, radii: torch.Tensor, ids: torch.Tensor,
             n_active: torch.Tensor, *, k: int, block_n: int,
             gate: bool = True):
    """The exact gated scan. queries (Q, d); points (n, d) label-sorted;
    norms (n,) cached fp32 ‖x‖²; centers/radii the (T, d)/(T,) tile balls
    at ``block_n``; ids (Q, T) / n_active (Q,) int32 the probed-tile maps.
    Returns ``(dists (Q, k) fp32, rows (Q, k) int32 into the sorted rows,
    gate_skipped (Q,) int32)``; unfilled slots hold ``(+inf, INT32_MAX)``.
    On the card this launches K13; CPU tensors take the plain twin."""
    n, d = points.shape
    _check_maps(queries, centers, radii, ids, n_active, block_n, n)
    _check_k(k, max_k(d, block_n))
    if queries.device.type == "cpu":
        return ivf_scan_torch(queries, points, norms, centers, radii, ids,
                              n_active, k=k, block_n=block_n, gate=gate)
    if queries.device.type != "cuda":
        raise ValueError(f"unsupported device {queries.device}")
    ops.check_card_tensors(queries=queries, points=points, norms=norms,
                           centers=centers, radii=radii)
    ops.check_card_tensors(torch.int32, ids=ids, n_active=n_active)
    nq = queries.shape[0]
    out = _outputs(nq, k, queries.device)
    fn = _build.function("ivf_scan", "ivf_scan_launch", _SCAN_ARGTYPES)
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(queries.data_ptr(), points.data_ptr(), norms.data_ptr(),
                 centers.data_ptr(), radii.data_ptr(), ids.data_ptr(),
                 n_active.data_ptr(), *(o.data_ptr() for o in out), nq, n, d,
                 centers.shape[0], block_n, k, int(gate), _REL1, _ABS,
                 stream)
    if err != 0:
        raise KernelFailureError(f"ivf_scan launch failed: cudaError {err}")
    ops.LAUNCHES["ivf_scan"] += 1
    return out


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
    :func:`ivf_scan` triple. On the card this launches K14; CPU tensors
    take the plain twin."""
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
    out = _outputs(nq, k, queries.device)
    fn = _build.function("ivf_scan", "ivf_adc_scan_launch", _ADC_ARGTYPES)
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(queries.data_ptr(), lut.data_ptr(), qdots.data_ptr(),
                 codes.data_ptr(), labels.data_ptr(), u.data_ptr(),
                 centers.data_ptr(), radii.data_ptr(), ids.data_ptr(),
                 n_active.data_ptr(), *(o.data_ptr() for o in out), nq, n, d,
                 centers.shape[0], block_n, k, int(gate), n_sub, n_codes,
                 nlist, _REL1, _ABS, stream)
    if err != 0:
        raise KernelFailureError(
            f"ivf_adc_scan launch failed: cudaError {err}")
    ops.LAUNCHES["ivf_adc_scan"] += 1
    return out
