"""The loops' round-counter contract, stated and checked in one place (the
port's copy of ``repro.core.telemetry``).

Every counter on :class:`~repro_torch.core.engine.KmeansppResult`
(``skipped``, ``pruned``, ``proposals``, ``accepts``, ``recovered``,
``tightened``, ``supers``) is:

* **fixed length** — ``(k,)``, one slot per seed round (a fit's
  ``skipped``/``pruned``/``recovered``: ``(max_iters,)``, one per
  iteration);
* **zero-filled** — slots of rounds that did not run the counted event hold
  exact 0 (a fit's slots past ``n_iters``: :func:`check_converged_zeros`);
* **int32**, non-negative.

Rejection counters: ``proposals[0] == accepts[0] == 0`` (the first seed is
uniform, not proposed); for later rounds ``accepts[m]`` is 0/1,
``accepts[m] <= proposals[m] <= max_attempts``, and a healthy round
proposes at least once (a round that exhausts its attempts takes the exact
fallback draw and reports ``accepts[m] == 0``).

Coarse-to-fine counters: under ``proposal='hier'`` every attempt refines
one super-tile window and the exact fallback, when taken, one more, so
``proposals[m] <= supers[m] <= proposals[m] + 1``, and ``tightened[m]``
(tiles whose cap shrank the stale partial) is at most the tile count;
under ``proposal='flat'`` both are identically zero.

IVF search counters (one slot per query): see :func:`check_ivf_counters`.

The checks take torch tensors or arrays and raise ``AssertionError``.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["check_counter", "check_converged_zeros",
           "check_rejection_counters", "check_hier_counters",
           "check_ivf_counters", "check_recovered"]


def _host(arr) -> np.ndarray:
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().numpy()
    return np.asarray(arr)


def check_counter(arr, length: int, name: str = "counter") -> np.ndarray:
    """Assert the fixed-length / int32 / non-negative half of the contract;
    returns the counter as a numpy array."""
    assert arr is not None, f"{name} missing (expected a ({length},) array)"
    a = _host(arr)
    assert a.shape == (length,), \
        f"{name} shape {a.shape} != ({length},): counters are fixed-length"
    assert a.dtype == np.int32, \
        f"{name} dtype {a.dtype} != int32: counters are exact integers"
    assert np.all(a >= 0), f"{name} has negative entries: {a}"
    return a


def check_converged_zeros(arr, n_ran, length: int,
                          name: str = "counter") -> np.ndarray:
    """Assert the zero-filled-past-convergence half of the contract (a
    fit's ``(max_iters,)`` counters): the slots of the ``length - n_ran``
    rounds that never ran are exact zeros."""
    a = check_counter(arr, length, name)
    n_ran = int(n_ran)
    assert np.array_equal(a[n_ran:], np.zeros(length - n_ran, np.int32)), \
        f"{name} slots past round {n_ran} are not zero-filled: {a[n_ran:]}"
    return a


def check_recovered(arr, length: int, *, expect=None) -> np.ndarray:
    """0/1 recovery flags, one per round; ``expect`` pins which rounds."""
    a = check_counter(arr, length, "recovered")
    assert np.all(a <= 1), f"recovered is a 0/1 flag per round: {a}"
    if expect is not None:
        want = np.asarray(expect, np.int32)
        assert np.array_equal(a, want), \
            f"recovered rounds {np.nonzero(a)[0]} != expected " \
            f"{np.nonzero(want)[0]}"
    return a


def check_rejection_counters(proposals, accepts, k: int, max_attempts: int,
                             recovered=None) -> None:
    """The ``sampler='rejection'`` relations on a seeding result.
    ``recovered`` masks rounds whose envelope the guard rebuilt."""
    p = check_counter(proposals, k, "proposals")
    a = check_counter(accepts, k, "accepts")
    rec = (np.zeros(k, np.int32) if recovered is None
           else check_recovered(recovered, k))
    assert p[0] == 0 and a[0] == 0, \
        "round 0 is the uniform first seed: proposals[0]==accepts[0]==0"
    assert np.all(a <= 1), f"accepts is 0/1 per round: {a}"
    assert np.all(a <= p), f"an accept implies at least one proposal: {p} {a}"
    assert np.all((p[1:] >= 1) | (rec[1:] == 1)), \
        f"every later healthy round proposes at least once: {p} (rec={rec})"
    assert np.all(p <= max_attempts), \
        f"proposals exceed the truncation depth {max_attempts}: {p}"


def check_hier_counters(tightened, supers, proposals, k: int, *,
                        n_tiles=None, hier: bool = True) -> None:
    """The coarse-to-fine relations: ``proposals <= supers <= proposals +
    1`` and ``tightened <= n_tiles`` under ``hier``; both identically zero
    under ``proposal='flat'``."""
    t = check_counter(tightened, k, "tightened")
    s = check_counter(supers, k, "supers")
    p = check_counter(proposals, k, "proposals")
    if not hier:
        assert np.all(t == 0), f"flat proposal never tightens: {t}"
        assert np.all(s == 0), f"flat proposal visits no supers: {s}"
        return
    assert t[0] == 0 and s[0] == 0, \
        "round 0 is the uniform first seed: tightened[0]==supers[0]==0"
    assert np.all(p <= s), f"each attempt visits one super window: {p} {s}"
    assert np.all(s <= p + 1), \
        f"only the exact fallback adds a window past the attempts: {p} {s}"
    if n_tiles is not None:
        assert np.all(t <= int(n_tiles)), \
            f"tightened exceeds the tile count {n_tiles}: {t}"


def check_ivf_counters(probed_lists, probed_tiles, gate_skipped, *,
                       n_queries: int, nlist: int, n_tiles: int) -> None:
    """The IVF search counters of a ``serve.ivf.SearchResult``, one slot
    per query: ``probed_lists <= nlist``; ``1 <= probed_tiles <= n_tiles``
    (the probe map's floor of one tile); ``0 <= gate_skipped <=
    probed_tiles``."""
    pl_ = check_counter(probed_lists, n_queries, "probed_lists")
    pt = check_counter(probed_tiles, n_queries, "probed_tiles")
    gs = check_counter(gate_skipped, n_queries, "gate_skipped")
    assert np.all(pl_ <= nlist), \
        f"probed_lists exceeds nlist={nlist}: {pl_}"
    assert np.all(pt >= 1), f"probed_tiles below the probe map's floor: {pt}"
    assert np.all(pt <= n_tiles), \
        f"probed_tiles exceeds n_tiles={n_tiles}: {pt}"
    assert np.all(gs <= pt), \
        f"gate skipped more tiles than were probed: {gs} vs {pt}"
