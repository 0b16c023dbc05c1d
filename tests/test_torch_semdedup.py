"""SemDeDup in the port against ``repro.data.semdedup``.

``semdedup`` normalizes the embeddings, clusters them with
``ClusterEngine.kmeans(init=...)`` and drops every doc whose cosine
similarity to an earlier doc of its own cluster exceeds the threshold.
Data: 600 embeddings of width 32 from 8 Gaussian blobs, with 40 planted
near-duplicates (an earlier row plus 1e-3 noise) and 4 exact copies at
later rows. The reference runs on the CPU on its ``fused`` backend from
``jax.random.PRNGKey(seed)``; the port gets the same draws for each init
(``draws_for``, ``parallel_draws_for``, ``choice_indices``) at the
reference's fit geometry. Held exactly: the keep mask, the assignment and
``n_kept``; inside the port, the blocked check is the one-block check
bitwise and every planted duplicate is dropped. A ``cuda`` test holds the
card's mask to a plain per-cluster pass on the card.
"""
from __future__ import annotations

import functools
import importlib

import numpy as np
import pytest
import torch

from test_torch_jaxref import (choice_indices, draws_for, load_reference,
                               parallel_draws_for, ref,  # noqa: F401
                               ref_geometry)
from repro_torch import convert
from repro_torch.core import make_backend
from repro_torch.data import DedupResult, semdedup

# the package exports the function under the module's name
semdedup_module = importlib.import_module("repro_torch.data.semdedup")

N, D, K, SEED = 600, 32, 8, 2
INITS = ["kmeans++", "kmeans||", "random"]


@functools.cache
def _embeds() -> tuple[np.ndarray, np.ndarray]:
    """(embeddings, the planted duplicates' rows): blobs, then 40 rows
    overwritten by an earlier row plus 1e-3 noise and 4 by exact copies."""
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(K, D))
    x = centers[rng.integers(0, K, N)] + 0.6 * rng.normal(size=(N, D))
    dups = rng.choice(np.arange(300, N), 44, replace=False)
    src = rng.integers(0, 300, 44)
    x[dups] = x[src] + 1e-3 * rng.normal(size=(44, D)) * (
        np.arange(44) < 40)[:, None]
    return x.astype(np.float32), np.sort(dups)


def _draws(init: str):
    return {"kmeans++": lambda: draws_for(SEED, N, K),
            "kmeans||": lambda: parallel_draws_for(SEED, N, K),
            "random": lambda: choice_indices(SEED, N, K)}[init]()


@functools.cache
def _ref_dedup(init: str):
    r = load_reference()
    res = r.semdedup.semdedup(r.jax.random.PRNGKey(SEED),
                              r.jnp.asarray(_embeds()[0]), k=K, init=init,
                              backend="fused")
    return tuple(np.asarray(f) for f in res)


def _backend(port: str):
    bn, tps = ref_geometry(load_reference(), N, D, K, backend="fused")
    return convert.with_geometry(make_backend(port), bn, tps)


@pytest.mark.parametrize("init", INITS)
@pytest.mark.parametrize("port", ["cuda", "fused"])
def test_semdedup_matches_reference(port, init):
    """The reference's keep mask, assignment and ``n_kept`` exactly, for
    each init; every planted duplicate dropped."""
    got = semdedup(_embeds()[0], k=K, init=init, backend=_backend(port),
                   draws=_draws(init), device="cpu")
    keep, assignment, n_kept = _ref_dedup(init)
    assert isinstance(got, DedupResult)
    np.testing.assert_array_equal(got.keep_mask.numpy(), keep)
    np.testing.assert_array_equal(got.assignment.numpy(), assignment)
    assert int(got.n_kept) == int(n_kept) == int(keep.sum())
    assert not got.keep_mask[torch.from_numpy(_embeds()[1])].any()


def test_blocked_check_is_one_block(monkeypatch):
    """Blocks of 7 rows give the one-block mask bitwise (a block's rows
    compare against all n), and the TF32 flag is left as it was."""
    x = _embeds()[0]
    draws = draws_for(SEED, N, K)
    flag = torch.backends.cuda.matmul.allow_tf32
    one = semdedup(x, k=K, draws=draws, device="cpu")
    monkeypatch.setattr(semdedup_module, "BLOCK", 7)
    small = semdedup(x, k=K, draws=draws, device="cpu")
    assert torch.equal(one.keep_mask, small.keep_mask)
    assert torch.equal(one.assignment, small.assignment)
    assert torch.backends.cuda.matmul.allow_tf32 == flag


def test_threshold_and_clusters_bound_the_drops():
    """A threshold past 1 keeps everything (an exact copy's similarity
    rounds to about 1); with one cluster every planted
    duplicate is dropped and each drop has an earlier row above the
    threshold (the plain O(n²) check)."""
    x = _embeds()[0]
    gen = torch.Generator().manual_seed(0)
    assert bool(semdedup(x, k=K, threshold=1.01, generator=gen,
                         device="cpu").keep_mask.all())
    one = semdedup(x, k=1, generator=gen, device="cpu")
    xn = x / (np.linalg.norm(x, axis=1, keepdims=True) + 1e-8)
    sim = np.tril(xn @ xn.T, -1)
    want = ~(sim > 0.95).any(1)
    near = np.abs(sim - 0.95).min(1) > 1e-5
    np.testing.assert_array_equal(one.keep_mask.numpy()[near], want[near])
    assert not one.keep_mask[torch.from_numpy(_embeds()[1])].any()


@pytest.mark.cuda
def test_semdedup_on_the_card_is_the_per_cluster_pass():
    """The card's keep mask equals a plain pass on the card that sorts by
    cluster and compares within each cluster only; every planted duplicate
    is dropped."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    x = torch.from_numpy(_embeds()[0]).cuda()
    got = semdedup(x, k=K, generator=torch.Generator().manual_seed(0))
    xn = x / (torch.sqrt((x * x).sum(1, keepdim=True)) + 1e-8)
    keep = torch.ones(N, dtype=torch.bool, device=x.device)
    for c in got.assignment.unique():
        rows = (got.assignment == c).nonzero().reshape(-1)
        sim = torch.tril(xn[rows] @ xn[rows].T, -1)
        keep[rows] = ~(sim > 0.95).any(1)
    assert torch.equal(got.keep_mask, keep)
    assert not got.keep_mask[torch.from_numpy(_embeds()[1]).cuda()].any()
