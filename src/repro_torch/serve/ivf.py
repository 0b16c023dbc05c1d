"""Batched IVF vector search over a trained k-means model (port of
``repro.serve.ivf``).

A k-means model is an inverted-file index: the centroids are a coarse
quantizer, each cluster an inverted list.

**Build** (:meth:`IvfIndex.build`) runs ``ClusterEngine.kmeans``, sorts
the rows by label (``data.ordering.label_sort_order``) so each list is one
contiguous run of tiles, and records what the scan reads: the per-list
``starts``/``counts``, the tile balls (``core.bounds.prologue``), the
(nlist, n_tiles) list-to-tile coverage, a routing hierarchy of super
centroids, and optionally PQ residual codes (``serve.kvquant``: a codebook
over ``x - centroid[label]``, with the norms and balls of the
reconstructed rows).

**Search** (:meth:`IvfIndex.search`) is one batched pass: exact
top-``nprobe`` routing (a super-centroid pass bounds the nprobe-th centroid
distance, the rerank masks only supers that provably hold none of the top
nprobe), the per-query probed-tile maps (``bounds.compact_ids``), and the
gated scan (``kernels.ivf_scan``: K13 for ``mode="exact"``, K14 for
``mode="adc"``). At ``nprobe == nlist`` the exact search is
:meth:`IvfIndex.exhaustive` bitwise. Every search first revalidates the
list offsets and raises ``CorruptedStateError`` on a mismatch.

Departures from the reference: ``nprobe=None`` is always the ``nlist // 8``
heuristic (the reference reads its tune cache first; the port has none, and
with an empty cache the two agree); there is no kernel fallback chain, so a
kernel that fails raises; the default tile height keeps the reference's
target (about four tiles per list) under the port's own tile budget; the
routing and LUT dot products are ascending FMA chains (``bounds._dots``),
the rounding of the reference's CPU dot, so the probed sets follow its
bits.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import bounds
from repro_torch.core.engine import ClusterEngine
from repro_torch.core.guards import (CorruptedStateError, InvalidInputError,
                                     check_policy, guard_points)
from repro_torch.core.sampling import Draws
from repro_torch.core.topk import IDX_SENTINEL, lex_topk
from repro_torch.data.ordering import label_sort_order
from repro_torch.kernels import ivf_scan as kscan
from repro_torch.kernels import ops
from repro_torch.serve import kvquant

__all__ = ["IvfIndex", "IvfPq", "SearchResult", "default_nprobe"]

# (queries x rows) scores the brute-force oracle holds at once
_ORACLE_CHUNK = 1 << 26


class IvfPq(NamedTuple):
    """PQ residual storage of an IvfIndex (``mode="adc"``). ``u`` and the
    balls are over the reconstructed rows ``x̂ = centroid[label] +
    decode(code)``, so the gate stays exact for ADC scores."""
    codes: torch.Tensor          # (n, n_sub) uint8, sorted row order
    codebook: kvquant.PQCodebook
    u: torch.Tensor              # (n,) fp32 ‖x̂‖²
    centers: torch.Tensor        # (n_tiles, d) balls over x̂
    radii: torch.Tensor          # (n_tiles,)


class SearchResult(NamedTuple):
    """Batched search output and the per-query counters."""
    indices: torch.Tensor        # (Q, k) int32 caller row ids
    #                              (IDX_SENTINEL pads when k > n)
    dists: torch.Tensor          # (Q, k) fp32 squared distances
    probed_lists: torch.Tensor   # (Q,) int32 non-empty lists routed to
    probed_tiles: torch.Tensor   # (Q,) int32 tiles the scan visited
    gate_skipped: torch.Tensor   # (Q,) int32 visited tiles the gate skipped


class IvfIndex(NamedTuple):
    """A trained k-means model packaged as an inverted-file index. Rows are
    stored label-sorted (``points == caller_points[perm]``); ``layout=
    "none"`` keeps the caller's order (perm the identity) with the same
    offsets, for the corruption check's one invariant."""
    points: torch.Tensor         # (n, d) fp32, sorted rows
    norms: torch.Tensor          # (n,) fp32 cached ‖x‖²
    centers: torch.Tensor        # (n_tiles, d) tile ball centers
    radii: torch.Tensor          # (n_tiles,) tile ball radii
    labels: torch.Tensor         # (n,) int32 list id per sorted row
    perm: torch.Tensor           # (n,) int32 sorted -> caller row map
    starts: torch.Tensor         # (nlist,) int32 list offsets
    counts: torch.Tensor         # (nlist,) int32 list sizes
    centroids: torch.Tensor      # (nlist, d) fp32 coarse quantizer
    centroid_norms: torch.Tensor  # (nlist,) fp32
    super_centers: torch.Tensor  # (n_super, d) routing hierarchy
    super_radii: torch.Tensor    # (n_super,)
    super_sizes: torch.Tensor    # (n_super,) int32 centroids per super
    list_tiles: torch.Tensor     # (nlist, n_tiles) bool coverage
    block_n: int                 # scan tile height
    backend: str                 # scan: 'cuda' (the kernels) or a twin's
    pq: Optional[IvfPq] = None   # ADC storage (build(pq_nsub=...))

    @property
    def n(self) -> int:
        return self.points.shape[0]

    @property
    def nlist(self) -> int:
        return self.centroids.shape[0]

    @property
    def n_tiles(self) -> int:
        return self.centers.shape[0]

    # -- build -------------------------------------------------------------

    @classmethod
    def build(cls, points, nlist: int, *,
              engine: Optional[ClusterEngine] = None,
              generator: Optional[torch.Generator] = None,
              draws: Optional[Draws] = None,
              pq_draws: Optional[Draws] = None,
              block_n: Optional[int] = None, layout: str = "label",
              pq_nsub: Optional[int] = None, max_iters: int = 25,
              validate: str = "raise") -> "IvfIndex":
        """Cluster ``points`` into ``nlist`` inverted lists through
        ``engine`` (default: a ``ClusterEngine()`` on the card) and package
        the scan's inputs. ``layout="label"`` sorts rows so each list is a
        contiguous tile run; ``"none"`` keeps the caller's order.
        ``pq_nsub`` adds PQ residual storage for ``mode="adc"`` (d %
        pq_nsub == 0), its codebook fit by the same engine. ``draws`` are
        the kmeans draws and ``pq_draws`` the codebook sweep's (batched);
        otherwise both come from ``generator``."""
        check_policy(validate)
        if layout not in ("label", "none"):
            raise InvalidInputError(
                f"unknown layout {layout!r}; expected 'label' or 'none'")
        eng = ClusterEngine() if engine is None else engine
        pts = torch.as_tensor(points, dtype=torch.float32, device=eng.device)
        if pts.dim() != 2:
            raise InvalidInputError(
                f"points must be (n, d), got {tuple(pts.shape)}")
        pts = guard_points(pts.contiguous(), validate, name="points")
        n, d = pts.shape
        if not 0 < nlist <= n:
            raise InvalidInputError(
                f"need 0 < nlist <= n, got nlist={nlist}, n={n}")
        res = eng.kmeans(pts, nlist, max_iters=max_iters,
                         generator=generator, draws=draws)
        centroids = res.centroids.float()
        labels = res.assignment.to(torch.int32)

        if layout == "label":
            perm, _, starts, counts = label_sort_order(
                labels, nlist=nlist, return_offsets=True)
        else:
            perm = torch.arange(n, dtype=torch.int32, device=pts.device)
            counts = torch.bincount(labels.long(), minlength=nlist)[:nlist]
            starts = (torch.cumsum(counts, 0) - counts).to(torch.int32)
            counts = counts.to(torch.int32)
        spts = pts[perm.long()].contiguous()
        slab = labels[perm.long()].contiguous()

        if block_n is None:
            # about 4 tiles per inverted list (pow2, >= 128), under the
            # port's tile budget
            cap = ops.choose_block_n(n, d, 1)
            tgt = 1 << max(7, (n // (4 * nlist)).bit_length() - 1)
            block_n = max(128, min(cap, tgt))
        rc = bounds.prologue(spts, block_n)
        n_tiles = rc.centers.shape[0]

        # routing hierarchy: pow2 groups of ~sqrt(nlist) consecutive
        # centroids; ball stats over the real members only
        g = _super_group_size(int(nlist))
        n_sup = -(-nlist // g)
        cpad = torch.cat([centroids,
                          centroids.new_zeros((n_sup * g - nlist, d))])
        member = (torch.arange(n_sup * g, device=pts.device)
                  < nlist).reshape(n_sup, g)
        sizes = member.sum(dim=1).to(torch.int32)
        grp = cpad.reshape(n_sup, g, d)
        sup_c = (torch.where(member[:, :, None], grp, 0.0).sum(dim=1)
                 / sizes.clamp_min(1)[:, None])
        sup_d2 = ((grp - sup_c[:, None, :]) ** 2).sum(dim=-1)
        sup_r = torch.where(member, sup_d2, 0.0).amax(dim=1).sqrt()

        tile_of_row = torch.arange(n, device=pts.device) // block_n
        list_tiles = torch.zeros((nlist, n_tiles), dtype=torch.bool,
                                 device=pts.device)
        list_tiles[slab.long(), tile_of_row] = True

        pq = None
        if pq_nsub is not None:
            resid = spts - centroids[slab.long()]
            cb = kvquant.build_codebook(resid, n_sub=pq_nsub, engine=engine,
                                        validate=validate,
                                        generator=generator, draws=pq_draws)
            codes = kvquant.encode(resid, cb, validate=validate)
            xhat = kvquant.decode(codes, cb) + centroids[slab.long()]
            arc = bounds.prologue(xhat, block_n)
            pq = IvfPq(codes.contiguous(), cb, arc.norms, arc.centers,
                       arc.radii)

        return cls(points=spts, norms=rc.norms, centers=rc.centers,
                   radii=rc.radii, labels=slab, perm=perm, starts=starts,
                   counts=counts, centroids=centroids,
                   centroid_norms=bounds.point_norms(centroids),
                   super_centers=sup_c, super_radii=sup_r,
                   super_sizes=sizes, list_tiles=list_tiles,
                   block_n=int(block_n), backend=eng.backend.name, pq=pq)

    # -- query -------------------------------------------------------------

    def search(self, queries, k: int, nprobe: Optional[int] = None, *,
               mode: str = "exact", gate: bool = True,
               backend: Optional[str] = None,
               validate: str = "raise") -> SearchResult:
        """Batched top-``k``: route each query to its top-``nprobe``
        centroids (``None``: :func:`default_nprobe`) and scan only those
        lists' tiles. ``mode="adc"`` scores against the PQ reconstruction
        (needs ``build(pq_nsub=...)``); ``gate=False`` turns off the
        (value-noop) kth-distance tile gate. ``backend`` 'cuda' (the
        index's default when built on a 'cuda' engine) runs K13/K14, any
        other name their plain twins. Raises ``CorruptedStateError`` if
        the stored list offsets disagree with the layout."""
        check_policy(validate)
        if mode not in ("exact", "adc"):
            raise InvalidInputError(
                f"unknown mode {mode!r}; expected 'exact' or 'adc'")
        if mode == "adc" and self.pq is None:
            raise InvalidInputError(
                "mode='adc' needs PQ storage: build(pq_nsub=...)")
        self._check_offsets()
        q = torch.as_tensor(queries, dtype=torch.float32,
                            device=self.points.device)
        d = self.points.shape[1]
        if q.dim() != 2 or q.shape[1] != d:
            raise InvalidInputError(
                f"queries shape {tuple(q.shape)} does not match index "
                f"dimension {d}")
        q = guard_points(q.contiguous(), validate, name="queries")
        if not 0 < k:
            raise InvalidInputError(f"need k >= 1, got k={k}")
        if nprobe is None:
            nprobe = default_nprobe(self.n, self.nlist, d)
        nprobe = max(1, min(int(nprobe), self.nlist))

        probed, qdots = _route(q, self.centroids, self.centroid_norms,
                               self.super_centers, self.super_radii,
                               self.super_sizes, nprobe=nprobe)
        tiles = (probed.float() @ self.list_tiles.float()) > 0.0
        ids, n_active = bounds.compact_ids(tiles)
        probed_lists = (probed & (self.counts > 0)[None, :]).sum(
            dim=1).to(torch.int32)
        dists, rows, skipped = self._scan(
            q, qdots, ids, n_active, k=int(k), mode=mode, gate=gate,
            backend=self.backend if backend is None else backend)
        return SearchResult(indices=_map_rows(rows, self.perm), dists=dists,
                            probed_lists=probed_lists,
                            probed_tiles=n_active, gate_skipped=skipped)

    def exhaustive(self, queries, k: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """Brute-force batched top-k over every row: the ground truth that
        ``search`` at ``nprobe == nlist`` equals bitwise (the same cached
        norms, dot arithmetic and tie-break over sorted-row ids). Returns
        (indices, dists) in caller ids."""
        q = torch.as_tensor(queries, dtype=torch.float32,
                            device=self.points.device)
        kk = min(int(k), self.n)
        step = max(1, _ORACLE_CHUNK // self.n)
        parts = [kscan.ivf_bruteforce_topk(q[i:i + step], self.points,
                                           self.norms, k=kk)
                 for i in range(0, q.shape[0], step)]
        dists = torch.cat([p[0] for p in parts])
        rows = torch.cat([p[1] for p in parts])
        dists, rows = _pad(dists, rows, int(k))
        return _map_rows(rows, self.perm), dists

    # -- internals ---------------------------------------------------------

    def _scan(self, q, qdots, ids, n_active, *, k: int, mode: str,
              gate: bool, backend: str):
        """The gated scan: K13/K14 for backend 'cuda' (their wrappers run
        the twins on CPU tensors), the plain twins for any other."""
        kk = min(k, self.n)
        kw = dict(k=kk, block_n=self.block_n, gate=gate)
        if mode == "exact":
            fn = kscan.ivf_scan if backend == "cuda" else kscan.ivf_scan_torch
            out = fn(q, self.points, self.norms, self.centers, self.radii,
                     ids, n_active, **kw)
        else:
            fn = (kscan.ivf_adc_scan if backend == "cuda"
                  else kscan.ivf_adc_scan_torch)
            pq = self.pq
            out = fn(q, _adc_lut(q, pq.codebook), qdots, pq.codes,
                     self.labels, pq.u, pq.centers, pq.radii, ids, n_active,
                     **kw)
        dists, rows, skipped = out
        dists, rows = _pad(dists, rows, k)
        return dists, rows, skipped

    def _check_offsets(self) -> None:
        """Host-side offset revalidation, always on: a poisoned offset
        table would return wrong neighbours silently. One (nlist,) numpy
        pass per search."""
        starts = self.starts.cpu().numpy()
        counts = self.counts.cpu().numpy()
        nlist = self.nlist
        if starts.shape != (nlist,) or counts.shape != (nlist,):
            raise CorruptedStateError(
                f"ivf index offsets have shapes {starts.shape}/"
                f"{counts.shape}, expected ({nlist},): rebuild the index")
        if (counts < 0).any() or (starts < 0).any():
            raise CorruptedStateError(
                "ivf index offsets contain negative entries: rebuild the "
                "index")
        if int(counts.astype(np.int64).sum()) != self.n:
            raise CorruptedStateError(
                f"ivf list sizes sum to {int(counts.sum())} != n={self.n}: "
                "rebuild the index")
        expect = np.cumsum(counts) - counts
        if not np.array_equal(starts, expect):
            raise CorruptedStateError(
                "ivf list starts disagree with exclusive-cumsum(counts): "
                "rebuild the index")


def default_nprobe(n: int, nlist: int, d: int) -> int:
    """``nprobe=None``: the ``nlist // 8`` heuristic (the reference's
    choice without a tune-cache record; the port has no tune cache)."""
    return max(1, int(nlist) // 8)


def _super_group_size(nlist: int) -> int:
    """Centroids per super group: the power of two nearest ~sqrt(nlist).
    Build and routing must agree on it."""
    return 1 << ((int(nlist - 1).bit_length() + 1) // 2) if nlist > 1 else 1


def _route(q, centroids, centroid_norms, sup_c, sup_r, sup_sizes, *,
           nprobe: int):
    """Exact top-``nprobe`` centroid routing. Per (query, super) bounds
    ``lb = max(d - R, 0)²`` and ``ub = (d + R)²``; ``tau_ub`` is the largest
    ub of the smallest ub-sorted prefix covering >= nprobe centroids, so
    every top-nprobe centroid's super has ``lb <= tau_ub`` (with the gates'
    fp32 slack), and masking the other supers' centroids never drops one.
    The rerank takes the first nprobe by (D², list id). Returns (probed
    (Q, nlist) bool, qdots (Q, nlist) fp32, the routing dots ADC reuses)."""
    nlist = centroids.shape[0]
    g = _super_group_size(nlist)
    qn = bounds.point_norms(q)
    sc2 = bounds.point_norms(sup_c)
    sd2 = torch.clamp_min(qn[:, None] - 2.0 * bounds._dots(q, sup_c)
                          + sc2[None, :], 0.0)
    sd = sd2.sqrt()
    lo = torch.clamp_min(sd - sup_r[None, :], 0.0)
    hi = sd + sup_r[None, :]
    lb, ub = lo * lo, hi * hi
    order = torch.argsort(ub, dim=1, stable=True)
    csum = torch.cumsum(sup_sizes.long()[order], dim=1)
    pos = (csum >= nprobe).to(torch.int32).argmax(dim=1)
    tau_ub = ub.gather(1, order).gather(1, pos[:, None].long())[:, 0]
    mag = sc2.sqrt()[None, :] + sup_r[None, :] + qn.sqrt()[:, None]
    margin = bounds._ABS * (mag * mag)
    survive = lb <= tau_ub[:, None] * (1.0 + bounds._REL) + margin

    qdots = bounds._dots(q, centroids)
    cd2 = torch.clamp_min(qn[:, None] - 2.0 * qdots
                          + centroid_norms[None, :], 0.0)
    sup_of_list = torch.arange(nlist, device=q.device) // g
    cd2m = torch.where(survive[:, sup_of_list], cd2, torch.inf)
    lid = torch.arange(nlist, dtype=torch.int32,
                       device=q.device).expand(cd2m.shape)
    _, sel = lex_topk(cd2m, lid, nprobe)
    probed = torch.zeros((q.shape[0], nlist), dtype=torch.bool,
                         device=q.device)
    probed.scatter_(1, sel.long(), True)
    return probed, qdots


def _adc_lut(q, cb: kvquant.PQCodebook):
    """Per-query inner-product LUT over the residual codebook, ``lut[q, s,
    c] = q_s · codebook[s, c]`` (Q, n_sub, n_codes), each an ascending FMA
    chain."""
    n_sub, _, dsub = cb.centroids.shape
    qsub = q.reshape(q.shape[0], n_sub, 1, dsub)
    return bounds._dots(qsub, cb.centroids.float())[:, :, 0, :]


def _pad(dists, rows, k: int):
    """Sentinel-pad the slots past n when k > n."""
    pad = k - dists.shape[1]
    if pad > 0:
        dists = torch.nn.functional.pad(dists, (0, pad), value=torch.inf)
        rows = torch.nn.functional.pad(rows, (0, pad), value=IDX_SENTINEL)
    return dists, rows


def _map_rows(rows, perm):
    """Sorted-layout row ids -> caller row ids, sentinels kept."""
    safe = rows.long().clamp(0, perm.shape[0] - 1)
    return torch.where(rows == IDX_SENTINEL, IDX_SENTINEL,
                       perm[safe]).to(torch.int32)
