"""The JAX reference, as the PyTorch port's parity tests use it.

``load_reference()`` imports the JAX package ``repro`` on the CPU. Under
jax 0.9 two things it was written against are gone, and the harness
patches them from outside the package before the import:

* ``repro/compat.py`` asks ``p in batching.primitive_batchers``; the
  proxy jax 0.9 puts there cannot answer ``in``;
* ``repro/kernels/lloyd_assign.py`` names ``pltpu.TPUMemorySpace.ANY``,
  which jax 0.9 renamed to ``pl.ANY``.

The patches are applied lazily, by the module-scoped ``ref`` fixture, never
when a test module is imported: the JAX package's own test modules are then
collected exactly as they would be without the port's tests, whatever the
file order.

``key_schedule`` replays the reference seeding loop's ``jax.random`` key
schedule as the plain numbers the port's ``Draws`` takes: the first index,
one uniform per round, and one fallback index per round (the ``_guarded``
draw for degenerate weights); ``rejection_schedule`` adds the rejection
loop's per-attempt and exact-draw numbers, ``weighted_first`` the uniform
and fallback index a weighted run draws its first seed with. Torch cannot reproduce threefry,
so parity tests hand the reference's draws to the port. ``batch=(b, B)``
replays problem b of ``seed_batched``, which seeds problem b from
``jax.random.split(PRNGKey(seed), B)[b]``; ``batched_draws_for`` stacks all
B as the port's batched ``Draws``, and ``key_draws`` does so for any
(B,) keys. ``gumbel_draws_for`` adds each round's Gumbel noise
(``jax.random.gumbel`` of the round key), ``parallel_draws_for`` replays
``kmeans_parallel_init``'s schedule as the port's ``ParallelDraws``, and
``choice_indices`` gives ``jax.random.choice``'s rows (``random_init``).

JAX is imported only inside these functions, so a run of the card-only
tests (``-m cuda``) needs no JAX on the machine with the card.
"""
from __future__ import annotations

import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.core import Draws

ROOT = Path(__file__).resolve().parents[1]
GUARD_SALT = 0x0DD   # repro.core.sampling._guarded's fold_in salt
ACCEPT_SALT = 0xACC  # repro.core.sampling._ACCEPT_SALT (accept uniforms)
EXACT_SALT = 0xFB    # the rejection loop's exact-draw fold_in salt


@functools.cache
def load_reference() -> SimpleNamespace:
    """Patch jax 0.9 for the JAX package and import it on the CPU."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    import jax.numpy as jnp
    from jax._src.interpreters import batching
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    type(batching.primitive_batchers).__contains__ = (
        lambda self, p: p in batching.fancy_primitive_batchers)
    if not hasattr(pltpu, "TPUMemorySpace"):
        pltpu.TPUMemorySpace = SimpleNamespace(ANY=pl.ANY)

    import importlib

    from repro.core import bounds, engine, quality, sampling
    from repro.kernels import ops, ref

    # repro.core re-exports functions under these modules' names
    kmeans_parallel, kmeanspp, lloyd, semdedup = (
        importlib.import_module(f"repro.{m}") for m in (
            "core.kmeans_parallel", "core.kmeanspp", "core.lloyd",
            "data.semdedup"))
    return SimpleNamespace(jax=jax, jnp=jnp, bounds=bounds, engine=engine,
                           sampling=sampling, ops=ops, ref=ref,
                           kmeans_parallel=kmeans_parallel,
                           kmeanspp=kmeanspp, lloyd=lloyd, quality=quality,
                           semdedup=semdedup)


@pytest.fixture(scope="module")
def ref() -> SimpleNamespace:
    return load_reference()


def _root_key(seed: int, batch=None):
    """``PRNGKey(seed)``, or problem b's key of ``split(PRNGKey(seed), B)``
    for ``batch=(b, B)``."""
    import jax
    key = jax.random.PRNGKey(seed)
    if batch is not None:
        b, n_problems = batch
        key = jax.random.split(key, n_problems)[b]
    return key


def key_schedule(seed: int, n: int, k: int, batch=None):
    """(first, u (k-1,) f32, fallback (k-1,) i64) as the reference's seeding
    loop draws them from ``jax.random.PRNGKey(seed)`` (or, with
    ``batch=(b, B)``, from problem b's key of ``seed_batched``): ``split``
    then ``randint`` for the first seed; per round ``split``, a ``uniform``
    from the round key, and ``randint(fold_in(round key, 0x0DD))`` for the
    degenerate-weight fallback."""
    return _schedule(_root_key(seed, batch), n, k)


def _schedule(key, n: int, k: int):
    """:func:`key_schedule` from one jax key."""
    import jax
    import jax.numpy as jnp
    key, k0 = jax.random.split(key)
    first = int(jax.random.randint(k0, (), 0, n, dtype=jnp.int32))
    us, fbs = [], []
    for _ in range(1, k):
        key, ks = jax.random.split(key)
        us.append(float(jax.random.uniform(ks, (), jnp.float32)))
        fbs.append(int(jax.random.randint(jax.random.fold_in(ks, GUARD_SALT),
                                          (), 0, n, dtype=jnp.int32)))
    return first, np.asarray(us, np.float32), np.asarray(fbs, np.int64)


def rejection_schedule(seed: int, n: int, k: int, max_attempts: int,
                       batch=None):
    """The rejection loop's numbers for rounds 1..k-1 under
    ``PRNGKey(seed)`` (with ``batch=(b, B)``, problem b's key of
    ``seed_batched``): (propose_u (k-1, A-1), accept_u (k-1, A), exact_u
    (k-1,), exact_fallback (k-1,)). Round key ``ks`` as in
    :func:`key_schedule`; attempt j's key is ``ks`` itself for j = 0 (so
    its proposal uniform is the round's ``u``) and ``fold_in(ks, j)`` after;
    it accepts with ``uniform(fold_in(kj, 0xACC))``; the exact draw takes
    ``kf = fold_in(ks, 0xFB)``: ``uniform(kf)`` and ``_guarded``'s
    ``randint(fold_in(kf, 0x0DD))``."""
    import jax
    import jax.numpy as jnp

    def uni(key):
        return float(jax.random.uniform(key, (), jnp.float32))

    def guard_idx(key):
        return int(jax.random.randint(jax.random.fold_in(key, GUARD_SALT),
                                      (), 0, n, dtype=jnp.int32))

    key, _ = jax.random.split(_root_key(seed, batch))
    pu, au, eu, eg = [], [], [], []
    for _ in range(1, k):
        key, ks = jax.random.split(key)
        kjs = [ks] + [jax.random.fold_in(ks, j)
                      for j in range(1, max_attempts)]
        pu.append([uni(kj) for kj in kjs[1:]])
        au.append([uni(jax.random.fold_in(kj, ACCEPT_SALT)) for kj in kjs])
        kf = jax.random.fold_in(ks, EXACT_SALT)
        eu.append(uni(kf))
        eg.append(guard_idx(kf))
    return (np.asarray(pu, np.float32).reshape(k - 1, max_attempts - 1),
            np.asarray(au, np.float32).reshape(k - 1, max_attempts),
            np.asarray(eu, np.float32), np.asarray(eg, np.int64))


def weighted_first(seed: int, n: int):
    """(first_u, first_fallback) of a weighted run under
    ``PRNGKey(seed)``: the reference draws its first seed by weight from
    the same ``k0`` as the unweighted first index, with ``uniform(k0)`` and
    ``_guarded``'s ``randint(fold_in(k0, 0x0DD))``."""
    import jax
    return _weighted_first(jax.random.PRNGKey(seed), n)


def _weighted_first(key, n: int):
    """:func:`weighted_first` from one jax key."""
    import jax
    import jax.numpy as jnp
    _, k0 = jax.random.split(key)
    return (float(jax.random.uniform(k0, (), jnp.float32)),
            int(jax.random.randint(jax.random.fold_in(k0, GUARD_SALT), (), 0,
                                   n, dtype=jnp.int32)))


def _gumbel_rounds(key, n: int, k: int) -> np.ndarray:
    """(k-1, n) fp32: ``jax.random.gumbel`` of each round key of the
    seeding loop run from ``key`` (the noise its Gumbel draw adds)."""
    import jax
    import jax.numpy as jnp
    key, _ = jax.random.split(key)
    rows = []
    for _ in range(1, k):
        key, ks = jax.random.split(key)
        rows.append(np.asarray(jax.random.gumbel(ks, (n,), jnp.float32)))
    return np.stack(rows).reshape(k - 1, n).astype(np.float32)


def gumbel_draws_for(seed: int, n: int, k: int, batch=None,
                     weighted: bool = False) -> Draws:
    """:func:`draws_for` plus the reference's Gumbel noise: round m's
    ``jax.random.gumbel(ks, (n,))`` from its round key ``ks``, which also
    gives the round's fallback index (``_guarded``'s)."""
    draws = draws_for(seed, n, k, batch=batch, weighted=weighted)
    noise = _gumbel_rounds(_root_key(seed, batch), n, k)
    return dataclasses.replace(draws, gumbel=torch.from_numpy(noise))


def parallel_draws_for(seed: int, n: int, k: int, rounds: int = 5,
                       oversample: int = 0):
    """``kmeans_parallel_init(PRNGKey(seed), ...)``'s schedule as the
    port's ``ParallelDraws``: ``split`` → k0 for the first index
    (``randint(k0, (), 0, n)``); per round ``split`` → ks and
    ``gumbel(ks, (n,))``; then ``split`` → kr, the key of the weighted
    tiled reduce over the rounds·l + 1 candidates (its weighted first seed
    and per-round draws, as :func:`draws_for` replays them)."""
    import jax
    import jax.numpy as jnp
    from repro_torch.core import ParallelDraws
    l = oversample or 2 * k
    n_cand = rounds * l + 1
    key, k0 = jax.random.split(jax.random.PRNGKey(seed))
    first = int(jax.random.randint(k0, (), 0, n, dtype=jnp.int32))
    noise = []
    for _ in range(rounds):
        key, ks = jax.random.split(key)
        noise.append(np.asarray(jax.random.gumbel(ks, (n,), jnp.float32)))
    key, kr = jax.random.split(key)
    rfirst, u, fb = _schedule(kr, n_cand, k)
    fu, ffb = _weighted_first(kr, n_cand)
    reduce = Draws(torch.tensor([rfirst]), torch.from_numpy(u),
                   torch.from_numpy(fb),
                   first_u=torch.tensor([fu], dtype=torch.float32),
                   first_fallback=torch.tensor([ffb]))
    return ParallelDraws(torch.tensor([first]),
                         torch.from_numpy(np.stack(noise).reshape(rounds, n)),
                         reduce)


def choice_indices(seed: int, n: int, k: int) -> torch.Tensor:
    """The rows ``random_init(PRNGKey(seed), ...)`` seeds with:
    ``jax.random.choice(key, n, (k,), replace=False)``."""
    import jax
    idx = jax.random.choice(jax.random.PRNGKey(seed), n, (k,),
                            replace=False)
    return torch.from_numpy(np.asarray(idx, np.int64))


def draws_for(seed: int, n: int, k: int, max_attempts: int = 0,
              batch=None, weighted: bool = False) -> Draws:
    """The reference's key schedule as the port's ``Draws``; with
    ``max_attempts`` > 0 also the rejection loop's; with ``weighted`` the
    weighted first seed's; with ``batch=(b, B)`` problem b's of
    ``seed_batched``."""
    first, u, fb = key_schedule(seed, n, k, batch)
    extra = {}
    if max_attempts > 0:
        extra = dict(zip(("propose_u", "accept_u", "exact_u",
                          "exact_fallback"),
                         map(torch.from_numpy,
                             rejection_schedule(seed, n, k, max_attempts,
                                                batch))))
    if weighted:
        fu, ffb = weighted_first(seed, n)
        extra.update(first_u=torch.tensor([fu], dtype=torch.float32),
                     first_fallback=torch.tensor([ffb]))
    return Draws(torch.tensor([first]), torch.from_numpy(u),
                 torch.from_numpy(fb), **extra)


def batched_draws_for(seed: int, n_problems: int, n: int, k: int,
                      max_attempts: int = 0, gumbel: bool = False) -> Draws:
    """``seed_batched(PRNGKey(seed), ...)``'s draws for all problems, as
    the port's batched ``Draws`` (leading axis B); with ``max_attempts``
    > 0 also each problem's rejection schedule, with ``gumbel`` each
    problem's Gumbel noise (:func:`gumbel_draws_for`)."""
    runs = [gumbel_draws_for(seed, n, k, batch=(b, n_problems)) if gumbel
            else draws_for(seed, n, k, max_attempts, batch=(b, n_problems))
            for b in range(n_problems)]
    return Draws(*(None if ts[0] is None else torch.stack(ts)
                   for ts in zip(*(dataclasses.astuple(r) for r in runs))))


def key_draws(keys, n: int, k: int) -> Draws:
    """Batched ``Draws`` for problems the reference seeds from the given
    (B,) jax keys (``seed_batched`` with batched keys, as
    ``serve.kvquant`` calls it), problem b's from ``keys[b]``."""
    runs = [_schedule(key, n, k) for key in keys]
    return Draws(torch.tensor([[r[0]] for r in runs]),
                 torch.from_numpy(np.stack([r[1] for r in runs])),
                 torch.from_numpy(np.stack([r[2] for r in runs])))


def ref_geometry(ref, n: int, d: int, k: int, backend: str = "pallas"):
    """(block_n, tps) the reference's kmeans uses for an (n, d) problem with
    k clusters: its backend's tile pick with ``tile_m = k``."""
    import dataclasses
    be = dataclasses.replace(ref.engine.make_backend(backend), tile_m=k)
    bn = be.seed_tile(n, d)
    return bn, be.tiles_per_super(-(-n // bn))


def np32(x) -> np.ndarray:
    return np.asarray(x, np.float32)


EPS32 = float(np.finfo(np.float32).eps)


def d2_tol(x: np.ndarray, c: np.ndarray) -> float:
    """Largest |port − reference| allowed on one matmul-form D²
    ``max(‖x‖² − 2x·c + ‖c‖², 0)`` in fp32: each side rounds d products
    and sums in the dot, and three more adds, each off by at most
    eps·(‖x‖² + ‖c‖²); the two sides may err in opposite directions."""
    d = x.shape[1]
    scale = float((x.astype(np.float64) ** 2).sum(1).max()
                  + (c.astype(np.float64) ** 2).sum(1).max())
    return 2 * (d + 4) * EPS32 * scale


def assert_labels_match(a_port, a_ref, d2: np.ndarray, tol: float) -> None:
    """Labels are equal, except on rows where the two picks' D² lie within
    ``tol`` of each other: there either is a correct argmin."""
    a_port, a_ref = np.asarray(a_port), np.asarray(a_ref)
    diff = np.nonzero(a_port != a_ref)[0]
    gap = np.abs(d2[diff, a_port[diff]] - d2[diff, a_ref[diff]])
    assert (gap <= tol).all(), (diff[gap > tol], gap[gap > tol])


def exact_d2(x: np.ndarray, c: np.ndarray) -> np.ndarray:
    """(n, k) squared distances in float64 — the yardstick for ties."""
    x, c = x.astype(np.float64), c.astype(np.float64)
    return ((x[:, None, :] - c[None, :, :]) ** 2).sum(-1)


def cdf_tol(w: np.ndarray) -> float:
    """Largest difference between two fp32 prefix sums of the same weights
    taken in different orders: n roundings of at most eps·total each."""
    return w.shape[0] * EPS32 * float(np.abs(w.astype(np.float64)).sum())


def assert_same_draw(i_port: int, i_ref: int, u: float, w: np.ndarray,
                     tol: float) -> None:
    """Two inverse-CDF draws with one uniform agree, or ``u·total`` lies
    within ``tol`` of the cdf boundary between the two picks (every row
    between them carries at most ``tol`` of mass), where the two sides'
    rounding may legitimately send it either way."""
    if i_port == i_ref:
        return
    cdf = np.cumsum(w.astype(np.float64))
    lo, hi = min(i_port, i_ref), max(i_port, i_ref)
    r = float(np.float32(u)) * cdf[-1]
    assert abs(cdf[lo] - r) <= tol and cdf[hi - 1] - cdf[lo] <= tol, (
        f"draw {i_port} != reference {i_ref}, and u*total={r} is not within "
        f"{tol} of the cdf boundary {cdf[lo]}")


# ---------------------------------------------------------------------------
# self-test of the harness
# ---------------------------------------------------------------------------


def test_module_import_leaves_reference_unpatched():
    """Importing this module patches nothing and imports no ``repro``: the
    patches wait for the fixture."""
    code = ("import sys; sys.path.insert(0, 'tests'); "
            "import test_torch_jaxref; "
            "from jax._src.interpreters import batching; "
            "assert 'repro' not in sys.modules, 'repro imported'; "
            "assert '__contains__' not in "
            "type(batching.primitive_batchers).__dict__, 'patched'")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_reference_imports_and_runs_interpreted(ref):
    """The patched reference runs its Pallas assignment kernel in interpret
    mode and agrees with its own pure-jnp oracle (labels exactly, D² and
    partials to 1e-5 relative: one fp32 reduction order against another)."""
    jnp = ref.jnp
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(300, 3)), jnp.float32)
    c = x[:4]
    got = ref.ops.lloyd_assign_tiled(x, c, block_n=128, tps=2,
                                     interpret=True)
    want = ref.ref.lloyd_assign_tiled_ref(x, c, 128, 2)
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(np32(g), np32(w), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sampler", ["cdf", "tiled"])
@pytest.mark.parametrize("degenerate", [False, True])
def test_key_schedule_replays_reference_draws(ref, sampler, degenerate):
    """The replayed (u, fallback) of a round key reproduce the reference's
    own draw from that key exactly: the inverse-CDF index from u for
    healthy weights, the ``_guarded`` fallback index for all-zero ones."""
    jax, jnp = ref.jax, ref.jnp
    n, bn = 200, 64
    rng = np.random.default_rng(1)
    w = np.zeros(n, np.float32) if degenerate else \
        rng.exponential(size=n).astype(np.float32)
    wj = jnp.asarray(w)
    parts = ref.sampling.tile_partials(wj, bn)
    key = jax.random.PRNGKey(7)
    for _ in range(20):
        key, ks = jax.random.split(key)
        if sampler == "cdf":
            want = ref.sampling.categorical_cdf(ks, wj)
        else:
            want = ref.sampling.categorical_tiled(ks, wj, parts, block_n=bn)
        u = jax.random.uniform(ks, (), jnp.float32)
        fb = jax.random.randint(jax.random.fold_in(ks, GUARD_SALT), (), 0,
                                n, dtype=jnp.int32)
        if degenerate:
            assert int(want) == int(fb)
        elif sampler == "cdf":
            assert int(want) == int(ref.sampling.index_from_uniform(u, wj))
        else:
            assert int(want) == int(ref.sampling.tiled_index_from_uniform(
                u, wj, parts, block_n=bn))


def test_key_schedule_first_seed_matches_reference(ref):
    """The schedule's first index is the reference seeding's first seed."""
    jax, jnp = ref.jax, ref.jnp
    n, k = 500, 4
    x = jnp.asarray(np.random.default_rng(2).normal(size=(n, 2)),
                    jnp.float32)
    for seed in (0, 3):
        res = ref.engine.ClusterEngine("fused", bounds=False).seed(
            jax.random.PRNGKey(seed), x, k)
        assert key_schedule(seed, n, k)[0] == int(res.indices[0])
