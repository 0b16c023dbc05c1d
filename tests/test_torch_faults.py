"""The port's fault matrix against the reference's (``tests/test_faults.py``).

Every injected fault either heals bitwise or raises a typed
``ClusteringError``. Both engines run the ``fused`` backend on label-sorted
blobs, the port with the reference's draws (``draws_for``) and tile
geometry: the port's ``seed``/``fit`` with ``_fault=FaultSpec(...)`` give
the reference's seeds, labels, ``n_iters`` and ``recovered`` flags exactly,
its D² within ``d2_tol``, and each faulted run is bitwise the port's own
clean run. Then the host-side pipeline faults (``flaky_read_fn``,
``kill_prefetch``), ``check_converged_zeros`` on a gated fit's counters,
and (on a card) the same matrix on the ``cuda`` backend, each case bitwise
its clean run and flagged where the fused twin flags it.
"""
from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from test_torch_jaxref import (d2_tol, draws_for, load_reference,
                               ref)  # noqa: F401  (ref is a fixture)
from repro_torch.core import (ClusterEngine, ClusteringError, Draws,
                              PipelineError, telemetry)
from repro_torch.data import DataPipeline, blobs
from repro_torch.testing import (ALL_FAULTS, FIT_FAULTS, REJECTION_FAULTS,
                                 SEED_FAULTS, FaultSpec, flaky_read_fn,
                                 kill_prefetch)

K = 8
A = 8                                  # max_attempts (the default)


def _coherent(n=16384, d=2, k=K, seed=0):
    pts, labels = blobs(n, d, k, seed=seed, spread=0.05)
    return pts[np.argsort(labels, kind="stable")]


# the reference fused backend's tile height and super fan-in at n = 4096,
# 8192 and 16384, d = 2 (``test_geometry_is_the_reference_s`` holds it)
GEOMETRY = dict(block_n=4096, tps=1)


def _engine(backend="fused", device="cpu", **kw):
    return ClusterEngine(backend, device=device, **GEOMETRY, **kw)


def _ref_fault(kind, rd):
    from repro.testing import FaultSpec as RefFaultSpec
    return None if kind is None else RefFaultSpec(kind, round=rd)


@functools.cache
def _ref_seed(kind=None, rd=1, n=16384, seed=1, sampler="cdf", **kw):
    """The reference fused engine's seeding of ``_coherent(n)`` from
    ``PRNGKey(seed)``, with the fault (kind, rd) or none."""
    ref = load_reference()
    eng = ref.engine.ClusterEngine("fused", validate="raise")
    return eng.seed(ref.jax.random.PRNGKey(seed),
                    ref.jnp.asarray(_coherent(n)), K, sampler=sampler,
                    _fault=_ref_fault(kind, rd), **kw)


@functools.cache
def _ref_fit(kind=None, rd=0):
    ref = load_reference()
    eng = ref.engine.ClusterEngine("fused", validate="raise")
    return eng.fit(ref.jnp.asarray(_coherent()), _ref_seed().centroids,
                   max_iters=8, tol=-1.0, _fault=_ref_fault(kind, rd))


def _same(a, b, fields):
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        assert (x == y) if isinstance(x, int) else torch.equal(x, y), f


SEED_FIELDS = ("indices", "centroids", "min_d2")
FIT_FIELDS = ("centroids", "assignment", "inertia", "n_iters")
REJECTION_FIELDS = SEED_FIELDS + ("proposals", "accepts", "tightened",
                                  "supers")


def test_geometry_is_the_reference_s(ref):
    be = ref.engine.make_backend("fused")
    for n in (4096, 8192, 16384):
        for m in (1, 4, K):
            bn = be.seed_tile(n, 2, m)
            assert dict(block_n=bn,
                        tps=be.tiles_per_super(-(-n // bn))) == GEOMETRY


def test_fault_kinds_are_the_reference_s(ref):
    from repro.testing import faults
    assert (SEED_FAULTS, FIT_FAULTS, REJECTION_FAULTS, ALL_FAULTS) == (
        faults.SEED_FAULTS, faults.FIT_FAULTS, faults.REJECTION_FAULTS,
        faults.ALL_FAULTS)
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultSpec("bit_flip")
    assert FaultSpec("nan_tile").round == 1
    assert hash(FaultSpec("nan_state", 3)) == hash(FaultSpec("nan_state", 3))


# ---------------------------------------------------------------------------
# in-flight corruption: the guarded loops detect, heal, and recover bitwise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,rd,flagged", [
    ("nan_tile", 2, True),      # NaN'd D² rows reach the round's total
    ("nan_state", 6, True),     # skipped tile 0's NaN'd carry reaches it
    ("nan_state", 7, False),    # skips a tile, but recomputes tile 0
    ("nan_state", 1, False),    # round 1 recomputes every tile
])
@pytest.mark.parametrize("sampler", ["cdf", "tiled"])
def test_seed_faults_match_reference(ref, sampler, kind, rd, flagged):
    """Seeds, ``recovered`` and ``skipped`` exactly the reference's, D²
    within ``d2_tol``; the faulted run bitwise the port's clean run, the
    heal flagged at round ``rd``'s slot (``rd - 1``) where the reference
    flags it. A poisoned partial the round recomputes is overwritten before
    anything reads it: not flagged, and still bitwise. (The reference's
    own test expects round 7 to flag; under jax 0.9's random bits its run
    flags round 6 and not 7, and the port's does the same.)"""
    pts = _coherent()
    want_clean = _ref_seed(sampler=sampler)
    want = _ref_seed(kind, rd, sampler=sampler)
    eng = _engine()
    draws = draws_for(1, pts.shape[0], K)
    clean = eng.seed(pts, K, draws=draws, sampler=sampler)
    got = eng.seed(pts, K, draws=draws, sampler=sampler,
                   _fault=FaultSpec(kind, rd))
    _same(got, clean, SEED_FIELDS)
    telemetry.check_recovered(clean.recovered, K, expect=np.zeros(K))
    expect = np.zeros(K, np.int32)
    expect[rd - 1] = flagged
    telemetry.check_recovered(got.recovered, K, expect=expect)
    np.testing.assert_array_equal(got.recovered.numpy(),
                                  np.asarray(want.recovered))
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    np.testing.assert_array_equal(clean.skipped.numpy(),
                                  np.asarray(want_clean.skipped))
    if kind == "nan_state" and rd > 1:
        assert int(clean.skipped[rd - 1]) > 0   # the round skips tiles
    np.testing.assert_allclose(got.min_d2.numpy(), np.asarray(want.min_d2),
                               rtol=0, atol=d2_tol(pts, pts))


@pytest.mark.parametrize("sampler", ["cdf", "tiled"])
def test_nan_tile_in_a_skipped_tile_is_the_reference_s_late_heal(ref,
                                                                 sampler):
    """The reference's blind spot, reproduced: NaN'd D² rows of a tile the
    gate skips (tile 0 at round 6) keep the round's total finite, so the
    guard does not see them before the sampler reads them; they are seen,
    and healed, a round later, after a seed was drawn from NaN weights.
    The port draws the reference's seeds and flags the reference's slot;
    neither is the clean run."""
    pts = _coherent()
    want = _ref_seed("nan_tile", 6, sampler=sampler)
    eng = _engine()
    draws = draws_for(1, pts.shape[0], K)
    clean = eng.seed(pts, K, draws=draws, sampler=sampler)
    got = eng.seed(pts, K, draws=draws, sampler=sampler,
                   _fault=FaultSpec("nan_tile", 6))
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    np.testing.assert_array_equal(got.recovered.numpy(),
                                  np.asarray(want.recovered))
    assert got.recovered.tolist() == [0] * 6 + [1, 0]
    assert torch.equal(got.indices[:6], clean.indices[:6])
    assert not torch.equal(got.indices, clean.indices)


@pytest.mark.parametrize("kind", FIT_FAULTS)
@pytest.mark.parametrize("rd", (2, 4))
def test_fit_faults_match_reference(ref, kind, rd):
    """A halved contribution or a NaN'd bound state trips the iteration's
    health check; the heal runs one ungated round, rebuilds the bound
    state, and the fit ends bitwise the port's clean fit, with the
    reference's labels, ``n_iters`` and ``recovered``."""
    pts = _coherent()
    want = _ref_fit(kind, rd)
    init = torch.from_numpy(np.array(_ref_seed().centroids))
    eng = _engine()
    clean = eng.fit(pts, init, max_iters=8, tol=-1.0)
    got = eng.fit(pts, init, max_iters=8, tol=-1.0,
                  _fault=FaultSpec(kind, rd))
    _same(got, clean, FIT_FIELDS)
    telemetry.check_recovered(clean.recovered, 8, expect=np.zeros(8))
    np.testing.assert_array_equal(got.recovered.numpy(),
                                  np.asarray(want.recovered))
    assert int(got.recovered[rd]) == 1
    assert got.n_iters == int(want.n_iters) == 8
    np.testing.assert_array_equal(got.assignment.numpy(),
                                  np.asarray(want.assignment))
    np.testing.assert_allclose(
        got.centroids.numpy(), np.asarray(want.centroids), rtol=0,
        atol=pts.shape[0] * np.finfo(np.float32).eps * np.abs(pts).max())


def test_fit_guard_off_returns_no_recovery_telemetry():
    pts = _coherent(n=4096)
    eng = ClusterEngine("fused", device="cpu", validate="off")
    seeds = eng.seed(pts, 4, draws=draws_for(2, 4096, 4))
    res = eng.fit(pts, seeds.centroids, max_iters=4)
    assert res.recovered is None and seeds.recovered is None


@pytest.mark.parametrize("kind,proposal", [("neg_envelope", "hier"),
                                           ("neg_envelope", "flat"),
                                           ("stale_super", "hier")])
def test_rejection_faults_match_reference(ref, kind, proposal):
    """A broken stale envelope (a negative partial, or a torn last super)
    is rebuilt before proposing, so the seeds and every counter replay
    bitwise the clean run's and equal the reference's; the heal is flagged
    in round 3's slot only."""
    n = 8192
    pts = _coherent(n=n)
    want = _ref_seed(kind, 3, n=n, seed=2, sampler="rejection",
                     proposal=proposal)
    eng = _engine()
    draws = draws_for(2, n, K, A)
    kw = dict(draws=draws, sampler="rejection", proposal=proposal)
    clean = eng.seed(pts, K, **kw)
    got = eng.seed(pts, K, _fault=FaultSpec(kind, 3), **kw)
    _same(got, clean, REJECTION_FIELDS)
    rec = got.recovered.numpy()
    assert rec[3] == 1 and rec.sum() == 1
    np.testing.assert_array_equal(rec, np.asarray(want.recovered))
    for name in ("indices", "proposals", "accepts", "tightened", "supers"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
    telemetry.check_rejection_counters(got.proposals, got.accepts, K,
                                       max_attempts=A,
                                       recovered=got.recovered)
    telemetry.check_hier_counters(got.tightened, got.supers, got.proposals,
                                  K, hier=proposal == "hier")


@pytest.mark.parametrize("kind", ALL_FAULTS)
def test_fault_of_another_loop_is_a_no_op(kind):
    """A kind the loop does not carry (a fit fault on seeding, a seeding
    fault on a fit, an envelope fault off the rejection sampler) leaves
    the run bitwise clean and unflagged, as in the reference."""
    pts = _coherent(n=4096)
    eng = _engine()
    draws = draws_for(3, 4096, K)
    if kind not in SEED_FAULTS:
        clean = eng.seed(pts, K, draws=draws)
        got = eng.seed(pts, K, draws=draws, _fault=FaultSpec(kind, 2))
        _same(got, clean, SEED_FIELDS)
        assert int(got.recovered.sum()) == 0
    if kind not in FIT_FAULTS:
        init = pts[[0, 600, 1200, 1800, 2400, 3000, 3600, 4000]]
        clean = eng.fit(pts, init, max_iters=4, tol=-1.0)
        got = eng.fit(pts, init, max_iters=4, tol=-1.0,
                      _fault=FaultSpec(kind, 2))
        _same(got, clean, FIT_FIELDS)
        assert int(got.recovered.sum()) == 0


def test_unguarded_fault_is_not_healed():
    """With validate='off' nothing checks: the poisoned carry survives to
    the result (the guard is what heals)."""
    pts = _coherent(n=4096)
    eng = _engine(validate="off")
    got = eng.seed(pts, K, draws=draws_for(3, 4096, K),
                   _fault=FaultSpec("nan_tile", K))
    assert got.recovered is None
    assert bool(torch.isnan(got.min_d2[:64]).all())


# ---------------------------------------------------------------------------
# host-side pipeline faults
# ---------------------------------------------------------------------------


def test_transient_read_failures_are_retried():
    fails = {1: 2, 3: 1}      # step 1 flakes twice, step 3 once
    pipe = DataPipeline(
        flaky_read_fn(lambda s: {"x": np.full((4,), s)}, fail_steps=fails),
        prefetch=1, backoff=0.01)
    got = [next(iter(pipe))[0] for _ in range(5)]
    pipe.stop()
    assert got == [0, 1, 2, 3, 4]
    assert fails == {1: 0, 3: 0}             # every flake was consumed


def test_dead_prefetch_thread_raises_typed_pipeline_error():
    pipe = DataPipeline(lambda s: {"x": np.zeros(2)}, prefetch=1)
    it = iter(pipe)
    next(it)
    kill_prefetch(pipe)
    with pytest.raises(PipelineError) as ei:
        for _ in range(8):
            next(it)
    pipe.stop()
    assert ei.value.step is not None
    assert isinstance(ei.value, ClusteringError)


def _batch(step):
    return np.random.default_rng(step).normal(size=(128, 2)).astype(
        np.float32)


def test_minibatch_over_a_flaky_source_is_the_clean_run():
    """Retried reads hand over the same batches: ``fit_minibatch`` over a
    flaky ``read_fn`` is bitwise the clean run."""
    eng = ClusterEngine("fused", device="cpu")
    init = _batch(99)[:4]
    clean = eng.fit_minibatch(init, _batch, n_batches=8)
    fails = {0: 1, 2: 2, 5: 1}
    got = eng.fit_minibatch(init, flaky_read_fn(_batch, fail_steps=fails),
                            n_batches=8)
    _same(got, clean, FIT_FIELDS)
    assert set(fails.values()) == {0}


def test_minibatch_surfaces_pipeline_error_with_step():
    eng = ClusterEngine("fused", device="cpu")
    boom = 5

    def read_fn(step):
        if step == boom:
            raise IOError("storage gone")
        return _batch(step)

    pipe = DataPipeline(read_fn, prefetch=1, retries=2, backoff=0.01)
    with pytest.raises(PipelineError, match="read_fn failed") as ei:
        eng.fit_minibatch(np.zeros((4, 2), np.float32), pipe, n_batches=16)
    assert ei.value.step == boom


# ---------------------------------------------------------------------------
# the counters' zero-filled-past-convergence contract
# ---------------------------------------------------------------------------


def test_check_converged_zeros_rejects_violations(ref):
    from repro.core import telemetry as ref_telemetry
    good = np.array([2, 1, 0, 0], np.int32)
    bad = np.array([2, 1, 1, 0], np.int32)
    for check in (telemetry.check_converged_zeros,
                  ref_telemetry.check_converged_zeros):
        check(good, 2, 4)
        with pytest.raises(AssertionError):   # non-zero past convergence
            check(bad, 2, 4)
        with pytest.raises(AssertionError):   # wrong length
            check(good, 2, 5)
    telemetry.check_converged_zeros(torch.from_numpy(good), 2, 4)


def test_fit_counters_zero_filled_past_convergence():
    """A gated fit that converges early leaves its ``skipped``, ``pruned``
    and ``recovered`` slots past ``n_iters`` at zero."""
    pts = _coherent(n=8192)
    eng = _engine()
    seeds = eng.seed(pts, 4, draws=draws_for(1, 8192, 4)).centroids
    res = eng.fit(pts, seeds, max_iters=25)
    it = int(res.n_iters)
    assert it < 25
    for name in ("skipped", "pruned", "recovered"):
        telemetry.check_converged_zeros(getattr(res, name), it, 25, name)
    assert int(res.skipped.sum()) + int(res.pruned.sum()) > 0


# ---------------------------------------------------------------------------
# the card: the same matrix through the kernels
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


CARD_CASES = [("seed", "nan_tile", 2), ("seed", "nan_state", 6),
              ("seed", "nan_state", 1), ("fit", "zero_counts", 2),
              ("fit", "zero_counts", 4), ("fit", "nan_state", 2),
              ("fit", "nan_state", 4), ("rejection", "neg_envelope", 3),
              ("rejection", "stale_super", 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("loop,kind,rd", CARD_CASES)
def test_fault_matrix_on_the_card(card, loop, kind, rd):
    """On the ``cuda`` backend (K1, K5/K2, K6/K3, K11/K12): every case
    bitwise its clean run, and ``recovered`` the fused twin's on the same
    card (a seeding ``nan_state`` flags only where the gate skips tile 0,
    which these draws decide)."""
    n = 8192 if loop == "rejection" else 16384
    pts = torch.from_numpy(_coherent(n=n)).to(card)
    draws = Draws.sample(n, K, generator=torch.Generator().manual_seed(1),
                         max_attempts=A)
    runs = {}
    for backend in ("cuda", "fused"):
        eng = _engine(backend, device=card)
        if loop == "fit":
            init = pts[torch.arange(K, device=card) * (n // K)]

            def call(**kw):
                return eng.fit(pts, init, max_iters=8, tol=-1.0, **kw)
        else:
            kw0 = (dict(sampler="rejection", proposal="hier")
                   if loop == "rejection" else {})

            def call(**kw):
                return eng.seed(pts, K, draws=draws, **kw0, **kw)
        runs[backend] = (call(), call(_fault=FaultSpec(kind, rd)))
    clean, got = runs["cuda"]
    fields = {"seed": SEED_FIELDS, "fit": FIT_FIELDS,
              "rejection": REJECTION_FIELDS}[loop]
    _same(got, clean, fields)
    assert int(clean.recovered.sum()) == 0
    assert torch.equal(got.recovered, runs["fused"][1].recovered)
    if not (loop == "seed" and kind == "nan_state"):
        assert int(got.recovered.sum()) == 1
