"""The port's checkpoints against the reference's (``tests/test_checkpoint.py``).

``CheckpointManager`` (atomic commit, async save, garbage collection,
dtypes, meta), the bound state under its geometry stamp, and the engine's
checkpointed ``seed``/``fit``: bitwise the plain call, resumed bitwise
after the newest steps are deleted (a fit also from a converged carry),
and every incompatible resume or unsupported mode a typed
``CheckpointError``. The checkpointed seeding picks the reference's
checkpointed seeds from the reference's draws. On a card the same runs go
through the kernels, and a card checkpoint refuses to resume on the CPU.
"""
from __future__ import annotations

import shutil

import numpy as np
import pytest
import torch

from test_torch_jaxref import draws_for, ref  # noqa: F401  (a fixture)
from repro_torch.checkpoint import (CheckpointManager, restore_bound_state,
                                    save_bound_state)
from repro_torch.core import (CheckpointError, ClusterEngine,
                              ClusteringError, Draws)
from repro_torch.core.bounds import BoundState
from repro_torch.data import blobs


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn((8, 4), generator=g),
                   "b16": torch.randn((4,), generator=g).bfloat16()},
        "opt": {"m": torch.zeros((8, 4)),
                "step": torch.tensor(7, dtype=torch.int32)},
        "rng": torch.randint(0, 2 ** 31, (2,), generator=g,
                             dtype=torch.int64).to(torch.uint32),
        "host": [3, 0.25, True],
    }


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [type(v)() for v in tree]
    return torch.zeros_like(tree)


def _leaves_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _leaves_equal(a[k], b[k])
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.uint8) if a.dim() else a,
                           b.view(torch.uint8) if b.dim() else b)
    else:
        assert a == b and type(a) is type(b)


def test_roundtrip_keeps_every_dtype(tmp_path):
    """Every leaf comes back bitwise in its own dtype (bf16 as bf16, uint32
    as uint32), Python scalars as their type; the file holds tensors only,
    so it loads with ``weights_only=True``."""
    mgr = CheckpointManager(tmp_path, async_save=False)
    state = _state()
    mgr.save(5, state)
    step, got = mgr.restore(_zeros_like(state))
    assert step == 5
    _leaves_equal(state, got)
    assert got["params"]["b16"].dtype == torch.bfloat16
    flat = torch.load(tmp_path / "step_00000005" / "arrays.pt",
                      weights_only=True)
    assert all(isinstance(v, torch.Tensor) for v in flat.values())
    man = mgr.read_manifest()
    assert man["dtypes"][man["leaves"].index("params/b16")] == "bfloat16"


def test_async_save_and_latest(tmp_path):
    mgr = CheckpointManager(tmp_path, async_save=True)
    s = _state()
    mgr.save(1, s)
    mgr.save(2, s)
    mgr.wait()
    assert mgr.latest_step() == 2


def test_async_save_snapshots_before_returning(tmp_path):
    """The caller may write its tensors in place right after ``save``
    returns: the saved step holds the values at the call."""
    mgr = CheckpointManager(tmp_path, async_save=True)
    x = {"x": torch.arange(1 << 16, dtype=torch.float32)}
    want = x["x"].clone()
    mgr.save(1, x)
    x["x"].fill_(-1.0)
    mgr.wait()
    _, got = mgr.restore({"x": torch.zeros(1 << 16)})
    assert torch.equal(got["x"], want)


def test_gc_keeps_newest(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2, async_save=False)
    s = _state()
    for step in (1, 2, 3, 4):
        mgr.save(step, s)
    assert mgr.all_steps() == [3, 4]


def test_no_partial_checkpoint_visible(tmp_path):
    """tmp dirs are never listed as restorable steps."""
    mgr = CheckpointManager(tmp_path, async_save=False)
    (tmp_path / "step_00000009.tmp").mkdir()
    mgr.save(1, _state())
    assert mgr.all_steps() == [1]


def test_restore_specific_step(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=0, async_save=False)
    s1, s2 = _state(1), _state(2)
    mgr.save(1, s1)
    mgr.save(2, s2)
    _, got = mgr.restore(_zeros_like(s1), step=1)
    assert torch.equal(got["params"]["w"], s1["params"]["w"])


def test_missing_checkpoint_raises(tmp_path):
    mgr = CheckpointManager(tmp_path)
    with pytest.raises(FileNotFoundError):
        mgr.restore({"x": torch.zeros(())})


def test_foreign_trees_raise_typed(tmp_path):
    """A leaf that is no tensor or scalar cannot be saved, and a restore
    target of another structure or shape is refused, never misread."""
    mgr = CheckpointManager(tmp_path, async_save=False)
    with pytest.raises(CheckpointError, match="cannot checkpoint"):
        mgr.save(1, {"f": object()})
    mgr.save(1, {"x": torch.zeros(3)})
    with pytest.raises(CheckpointError, match="another tree"):
        mgr.restore({"y": torch.zeros(3)})
    with pytest.raises(CheckpointError, match="shape"):
        mgr.restore({"x": torch.zeros(4)})


def test_manifest_meta_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path, async_save=False)
    mgr.save(3, _state(), meta={"kind": "seed", "k": 7})
    man = mgr.read_manifest(3)
    assert man["meta"] == {"kind": "seed", "k": 7}
    assert man["step"] == 3 and "shapes" in man
    mgr.save(4, _state())
    assert mgr.read_manifest(4).get("meta") is None
    assert mgr.read_manifest()["step"] == 4          # default: latest


# ---------------------------------------------------------------------------
# bound-state geometry stamps
# ---------------------------------------------------------------------------


def _bound_state(n_tiles, seed=0):
    g = torch.Generator().manual_seed(seed)
    return BoundState(torch.rand(n_tiles, generator=g),
                      torch.rand(n_tiles, generator=g) + 1.0)


def _like(st):
    return BoundState(*(None if f is None else torch.zeros_like(f)
                        for f in st))


@pytest.mark.parametrize("shards", [8, 4, 1])
def test_bound_state_same_geometry_roundtrips_bitwise(tmp_path, shards):
    st = _bound_state(128 // shards)
    save_bound_state(tmp_path, 1, st, shards=shards, tile=128)
    got = restore_bound_state(tmp_path, _like(st), shards=shards, tile=128)
    assert got is not None and got.tile_gap is None
    assert torch.equal(got.partials, st.partials)
    assert torch.equal(got.tile_max, st.tile_max)


def test_bound_state_reshard_invalidates(tmp_path):
    """Another shard count or tile height: restore gives None (the caller
    rebuilds the state with one ungated round), never a state that
    describes other rows."""
    st = _bound_state(16)
    save_bound_state(tmp_path, 1, st, shards=8, tile=128)
    for shards in (4, 1):
        assert restore_bound_state(tmp_path, _like(st), shards=shards,
                                   tile=128) is None
    assert restore_bound_state(tmp_path, _like(st), shards=8,
                               tile=256) is None


def test_bound_state_restore_errors_are_typed(tmp_path):
    like = _like(_bound_state(8))
    with pytest.raises(CheckpointError, match="no bound-state checkpoint"):
        restore_bound_state(tmp_path / "empty", like, shards=1, tile=128)
    CheckpointManager(tmp_path, async_save=False).save(
        1, _state(), meta={"kind": "train"})
    with pytest.raises(CheckpointError, match="not a bound-state"):
        restore_bound_state(tmp_path, like, shards=1, tile=128)
    assert issubclass(CheckpointError, ClusteringError)


# ---------------------------------------------------------------------------
# the engine's checkpointed seeding and fit
# ---------------------------------------------------------------------------


def _problem(n=4096, d=2, k=6, seed=3):
    pts, labels = blobs(n, d, k, seed=seed, spread=0.05)
    return pts[np.argsort(labels, kind="stable")]


def _same(a, b, fields):
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        assert (x == y) if isinstance(x, int) else torch.equal(x, y), f


SEED_FIELDS = ("indices", "centroids", "min_d2", "skipped", "pruned",
               "recovered")
FIT_FIELDS = ("centroids", "assignment", "inertia", "n_iters", "skipped",
              "pruned", "recovered")


def _drop_newest(path, count=2):
    mgr = CheckpointManager(path)
    for step in mgr.all_steps()[-count:]:
        shutil.rmtree(path / f"step_{step:08d}")


@pytest.mark.parametrize("sampler", ["cdf", "tiled"])
@pytest.mark.parametrize("bounds", [True, False])
def test_checkpointed_seed_matches_plain_and_resumes(tmp_path, sampler,
                                                     bounds):
    """Chunks of 2 rounds: every field bitwise the plain seeding; with the
    newest two steps deleted the run resumes from the oldest, with the
    saved draws (not the caller's new ones), bitwise again."""
    pts = _problem()
    eng = ClusterEngine("fused", device="cpu", block_n=512, bounds=bounds)
    draws = Draws.sample(pts.shape[0], 6,
                         generator=torch.Generator().manual_seed(4))
    plain = eng.seed(pts, 6, draws=draws, sampler=sampler)
    ck = eng.seed(pts, 6, draws=draws, sampler=sampler,
                  checkpoint_dir=tmp_path, checkpoint_every=2)
    _same(ck, plain, SEED_FIELDS if bounds else SEED_FIELDS[:3])
    mgr = CheckpointManager(tmp_path)
    assert mgr.all_steps() == [3, 5, 6]
    meta = mgr.read_manifest()["meta"]
    assert meta["kind"] == "seed" and meta["sampler"] == sampler
    assert (meta["backend"], meta["device"], meta["block_n"]) == (
        "fused", "cpu", 512)
    _drop_newest(tmp_path)
    other = Draws.sample(pts.shape[0], 6,
                         generator=torch.Generator().manual_seed(99))
    res = eng.seed(pts, 6, draws=other, sampler=sampler,
                   checkpoint_dir=tmp_path, checkpoint_every=2)
    _same(res, plain, SEED_FIELDS if bounds else SEED_FIELDS[:3])


def test_checkpointed_seed_picks_the_reference_s_seeds(ref, tmp_path):
    """The reference's checkpointed seeding and the port's, from the same
    draws and tile height, resumed after the newest two steps are lost:
    the same seeds."""
    pts = _problem()
    bn = ref.engine.make_backend("fused").seed_tile(pts.shape[0], 2)
    want = ref.engine.ClusterEngine("fused").seed(
        ref.jax.random.PRNGKey(4), ref.jnp.asarray(pts), 6,
        checkpoint_dir=tmp_path / "ref", checkpoint_every=2)
    eng = ClusterEngine("fused", device="cpu", block_n=bn)
    eng.seed(pts, 6, draws=draws_for(4, pts.shape[0], 6),
             checkpoint_dir=tmp_path / "port", checkpoint_every=2)
    _drop_newest(tmp_path / "port")
    got = eng.seed(pts, 6, draws=draws_for(4, pts.shape[0], 6),
                   checkpoint_dir=tmp_path / "port", checkpoint_every=2)
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))


@pytest.mark.parametrize("change", ["k", "precision", "backend", "tile",
                                    "sampler", "weighted"])
def test_checkpointed_seed_refuses_mismatched_run(tmp_path, change):
    pts = _problem()
    draws = Draws.sample(pts.shape[0], 6,
                         generator=torch.Generator().manual_seed(4))
    ClusterEngine("fused", device="cpu", block_n=512).seed(
        pts, 6, draws=draws, checkpoint_dir=tmp_path, checkpoint_every=2)
    opts = {"precision": dict(precision="bf16"),
            "backend": dict(backend="reference"),
            "tile": dict(block_n=1024)}.get(change, {})
    eng = ClusterEngine(**{"device": "cpu", "block_n": 512, **opts})
    kw = dict(k=5 if change == "k" else 6, draws=draws,
              sampler="tiled" if change == "sampler" else "cdf",
              weights=(np.ones(pts.shape[0], np.float32)
                       if change == "weighted" else None))
    if change == "weighted":
        kw["draws"] = Draws.sample(pts.shape[0], 6, weighted=True,
                                   generator=torch.Generator().manual_seed(4))
    with pytest.raises(CheckpointError, match="meta"):
        eng.seed(pts, checkpoint_dir=tmp_path, checkpoint_every=2, **kw)


def test_checkpointed_runs_refuse_unsupported_modes(tmp_path):
    pts = _problem()
    eng = ClusterEngine("fused", device="cpu")
    with pytest.raises(CheckpointError, match="rejection"):
        eng.seed(pts, 6, sampler="rejection", checkpoint_dir=tmp_path,
                 generator=torch.Generator().manual_seed(0))
    with pytest.raises(CheckpointError, match="unweighted"):
        eng.fit(pts, pts[:4], weights=np.ones(pts.shape[0], np.float32),
                checkpoint_dir=tmp_path)
    with pytest.raises(CheckpointError, match="bounds=True"):
        ClusterEngine("fused", device="cpu", bounds=False).fit(
            pts, pts[:4], checkpoint_dir=tmp_path)
    with pytest.raises(ValueError, match="empty-cluster"):
        eng.fit(pts, pts[:4], empty="drop", checkpoint_dir=tmp_path)
    assert not CheckpointManager(tmp_path).all_steps()


@pytest.mark.parametrize("empty", ["keep", "reseed"])
def test_checkpointed_fit_matches_plain_and_resumes(tmp_path, empty):
    """Chunks of 3 iterations to convergence: bitwise the plain fit; the
    newest two steps deleted, the resumed fit bitwise again; resumed from
    the converged carry it runs no iteration and saves no step."""
    pts = _problem(n=8192, k=6, seed=5)
    init = pts[[0, 1400, 2800, 4200, 5600, 7000]].copy()
    if empty == "reseed":
        init[5] = pts.max(0) + 50.0
    eng = ClusterEngine("fused", device="cpu", block_n=512, tps=4)
    kw = dict(max_iters=25, empty=empty, checkpoint_every=3)
    plain = eng.fit(pts, init, max_iters=25, empty=empty)
    assert 3 < plain.n_iters < 25
    ck = eng.fit(pts, init, checkpoint_dir=tmp_path, **kw)
    _same(ck, plain, FIT_FIELDS)
    mgr = CheckpointManager(tmp_path)
    assert mgr.latest_step() == plain.n_iters
    # the assignment is saved once, as the bound state's
    assert "assignment" not in mgr.read_manifest()["leaves"]
    stamp = (tmp_path / f"step_{plain.n_iters:08d}").stat().st_mtime_ns
    again = eng.fit(pts, init, checkpoint_dir=tmp_path, **kw)
    _same(again, plain, FIT_FIELDS)
    assert (tmp_path / f"step_{plain.n_iters:08d}").stat().st_mtime_ns \
        == stamp
    _drop_newest(tmp_path)
    res = eng.fit(pts, init, checkpoint_dir=tmp_path, **kw)
    _same(res, plain, FIT_FIELDS)


def test_checkpointed_fit_refuses_mismatched_run(tmp_path):
    pts = _problem()
    ClusterEngine("fused", device="cpu").fit(
        pts, pts[:4], max_iters=6, tol=-1.0, checkpoint_dir=tmp_path,
        checkpoint_every=2)
    for eng, init, kw in (
            (ClusterEngine("fused", device="cpu"), pts[:5], {}),
            (ClusterEngine("fused", device="cpu", precision="bf16"),
             pts[:4], {}),
            (ClusterEngine("fused", device="cpu"), pts[:4],
             {"max_iters": 7})):
        with pytest.raises(CheckpointError, match="meta"):
            eng.fit(pts, init, **{"max_iters": 6, "tol": -1.0, **kw},
                    checkpoint_dir=tmp_path, checkpoint_every=2)


def test_checkpointed_fit_with_order_and_faults(tmp_path):
    """``order=`` still applies around a checkpointed fit (the assignment
    in the caller's rows), and a fault healed inside a chunk is healed in
    the result: both bitwise their plain calls."""
    from repro_torch.testing import FaultSpec
    pts = _problem(n=8192, seed=6)
    rng = np.random.default_rng(0)
    shuffled = pts[rng.permutation(pts.shape[0])]
    eng = ClusterEngine("fused", device="cpu", block_n=512)
    init = shuffled[:6]
    kw = dict(max_iters=10, tol=-1.0, order="morton")
    plain = eng.fit(shuffled, init, **kw)
    ck = eng.fit(shuffled, init, checkpoint_dir=tmp_path / "o",
                 checkpoint_every=4, **kw)
    _same(ck, plain, FIT_FIELDS + ("reorder",))
    hurt = eng.fit(shuffled, init, checkpoint_dir=tmp_path / "f",
                   checkpoint_every=4, _fault=FaultSpec("zero_counts", 5),
                   **kw)
    _same(hurt, plain, FIT_FIELDS[:4])
    assert hurt.recovered.tolist() == [0] * 5 + [1] + [0] * 4


def test_bf16_runs_checkpoint_bitwise(tmp_path):
    """Under ``precision='bf16'`` (a bf16 stream, fp32 carries) the
    checkpointed seeding and fit are bitwise their plain calls."""
    pts = _problem()
    eng = ClusterEngine("fused", device="cpu", precision="bf16", block_n=512)
    draws = Draws.sample(pts.shape[0], 6,
                         generator=torch.Generator().manual_seed(4))
    seeds = eng.seed(pts, 6, draws=draws)
    ck = eng.seed(pts, 6, draws=draws, checkpoint_dir=tmp_path / "s",
                  checkpoint_every=4)
    _same(ck, seeds, SEED_FIELDS)
    plain = eng.fit(pts, seeds.centroids, max_iters=8, tol=-1.0)
    ck = eng.fit(pts, seeds.centroids, max_iters=8, tol=-1.0,
                 checkpoint_dir=tmp_path / "f", checkpoint_every=3)
    _same(ck, plain, FIT_FIELDS)
    assert CheckpointManager(tmp_path / "f").read_manifest()["meta"][
        "precision"] == "bf16"


def test_checkpoint_dir_takes_a_manager(tmp_path):
    """``checkpoint_dir`` may be a ``CheckpointManager`` (its ``keep`` and
    writer are the caller's); the engine's saves block either way."""
    pts = _problem()
    mgr = CheckpointManager(tmp_path, keep=0, async_save=True)
    draws = Draws.sample(pts.shape[0], 6,
                         generator=torch.Generator().manual_seed(4))
    eng = ClusterEngine("fused", device="cpu", block_n=512)
    ck = eng.seed(pts, 6, draws=draws, checkpoint_dir=mgr)
    _same(ck, eng.seed(pts, 6, draws=draws), SEED_FIELDS)
    assert mgr.all_steps() == [2, 3, 4, 5, 6]


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("sampler", ["cdf", "tiled"])
def test_checkpointed_runs_resume_bitwise_on_the_card(card, tmp_path,
                                                      sampler):
    """Through K1, K5 (in place) and K6: the checkpointed seeding and fit
    bitwise the plain calls, and again after the newest two steps are
    deleted; the restored carry lives on the card."""
    pts = torch.from_numpy(_problem(n=50_000, k=8, seed=7)).to(card)
    eng = ClusterEngine(device=card)
    draws = Draws.sample(pts.shape[0], 16,
                         generator=torch.Generator().manual_seed(4))
    plain = eng.seed(pts, 16, draws=draws, sampler=sampler)
    for _ in range(2):
        ck = eng.seed(pts, 16, draws=draws, sampler=sampler,
                      checkpoint_dir=tmp_path / "s", checkpoint_every=4)
        _same(ck, plain, SEED_FIELDS)
        assert ck.min_d2.device.type == "cuda"
        _drop_newest(tmp_path / "s")
    fit = eng.fit(pts, plain.centroids, max_iters=12, tol=-1.0)
    for _ in range(2):
        ck = eng.fit(pts, plain.centroids, max_iters=12, tol=-1.0,
                     checkpoint_dir=tmp_path / "f", checkpoint_every=5)
        _same(ck, fit, FIT_FIELDS)
        _drop_newest(tmp_path / "f")


@pytest.mark.cuda
def test_card_checkpoint_refuses_the_cpu(card, tmp_path):
    """The kernels are not bitwise their plain twins: a card checkpoint
    resumed with ``device='cpu'`` raises instead of drifting."""
    pts = _problem()
    draws = Draws.sample(pts.shape[0], 6,
                         generator=torch.Generator().manual_seed(4))
    ClusterEngine(device=card).seed(pts, 6, draws=draws,
                                    checkpoint_dir=tmp_path / "s",
                                    checkpoint_every=2)
    ClusterEngine(device=card).fit(pts, pts[:4], max_iters=4, tol=-1.0,
                                   checkpoint_dir=tmp_path / "f")
    cpu = ClusterEngine(device="cpu")
    with pytest.raises(CheckpointError, match="meta"):
        cpu.seed(pts, 6, draws=draws, checkpoint_dir=tmp_path / "s",
                 checkpoint_every=2)
    with pytest.raises(CheckpointError, match="meta"):
        cpu.fit(pts, pts[:4], max_iters=4, tol=-1.0,
                checkpoint_dir=tmp_path / "f")
