"""The port's inverse-CDF samplers against ``repro.core.sampling``.

Every function of the port takes its uniform (and its fallback index) as an
argument; the tests sweep a dense grid of uniforms through both sides and
compare the picks. fp32 prefix sums taken in two orders may send a uniform
that lies on a cdf boundary either way: such a pick may differ, and only
such a pick (``assert_same_draw`` checks that it is the cause).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_jaxref import (EPS32, GUARD_SALT, assert_same_draw, cdf_tol,
                               ref)  # noqa: F401  (ref is a fixture)
from repro_torch.core import sampling

GRID = (np.arange(1024, dtype=np.float64) + 0.5) / 1024


def _weights(n, seed, zeros=True):
    w = np.abs(np.random.default_rng(seed).normal(size=n)).astype(np.float32)
    if zeros:
        w[::7] = 0.0
    return w


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("n", [1, 13, 100, 777])
def test_index_from_uniform_matches_reference(ref, n):
    w = _weights(n, seed=n, zeros=n > 1)
    f = jax.jit(jax.vmap(lambda u: ref.sampling.index_from_uniform(
        u, jnp.asarray(w))))
    want = np.asarray(f(jnp.asarray(GRID, jnp.float32)))
    tol = cdf_tol(w)
    for u, iw in zip(GRID, want):
        got = sampling.index_from_uniform(torch.tensor(u, dtype=torch.float32),
                                          _t(w))
        assert got.shape == (1,) and got.dtype == torch.int64
        assert_same_draw(int(got), int(iw), u, w, tol)


@pytest.mark.parametrize("n,block_n", [(37, 8), (100, 128), (256, 32),
                                       (1000, 64), (13, 4)])
def test_tiled_index_from_uniform_matches_reference(ref, n, block_n):
    """Ragged last tile, a single tile wider than n, zero-weight rows."""
    w = _weights(n, seed=block_n)
    parts = sampling.tile_partials(_t(w), block_n)
    rparts = ref.sampling.tile_partials(jnp.asarray(w), block_n)
    f = jax.jit(jax.vmap(lambda u: ref.sampling.tiled_index_from_uniform(
        u, jnp.asarray(w), rparts, block_n=block_n)))
    want = np.asarray(f(jnp.asarray(GRID, jnp.float32)))
    tol = cdf_tol(w)
    for u, iw in zip(GRID, want):
        got = sampling.tiled_index_from_uniform(
            torch.tensor(u, dtype=torch.float32), _t(w), parts,
            block_n=block_n)
        assert_same_draw(int(got), int(iw), u, w, tol)


def test_tiled_underflow_window_falls_back_to_uniform_offset(ref):
    """A tile whose partial is positive while its window re-sums to zero
    (the partial came from another reduction): both sides take the uniform
    offset ``floor(r_local / partials[t] · block_n)`` inside the tile, pick
    for pick."""
    n, block_n = 64, 16
    w = _weights(n, seed=3, zeros=False)
    w[16:32] = 0.0
    parts = np.add.reduceat(w, np.arange(0, n, block_n)).astype(np.float32)
    parts[1] = w.sum()                 # tile 1 claims mass it does not hold
    f = jax.jit(jax.vmap(lambda u: ref.sampling.tiled_index_from_uniform(
        u, jnp.asarray(w), jnp.asarray(parts), block_n=block_n)))
    want = np.asarray(f(jnp.asarray(GRID, jnp.float32)))
    got = np.array([int(sampling.tiled_index_from_uniform(
        torch.tensor(u, dtype=torch.float32), _t(w), _t(parts),
        block_n=block_n)) for u in GRID])
    in_tile1 = (want >= 16) & (want < 32)
    assert in_tile1.sum() > 100        # the fallback really fired
    np.testing.assert_array_equal(got[in_tile1], want[in_tile1])
    assert (got == want).mean() >= 1 - 3 * n / GRID.size


@pytest.mark.parametrize("n,block_n", [(1, 128), (100, 8), (1000, 128),
                                       (4097, 4096)])
def test_tile_partials_match_reference(ref, n, block_n):
    """Zero-padded tail; sums of block_n values in two orders agree within
    block_n roundings of eps·|sum| each."""
    x = np.random.default_rng(n).normal(size=n).astype(np.float32)
    want = np.asarray(ref.sampling.tile_partials(jnp.asarray(x), block_n))
    got = sampling.tile_partials(_t(x), block_n).numpy()
    assert got.shape == want.shape == (-(-n // block_n),)
    pad = np.concatenate([np.abs(x), np.zeros((-n) % block_n, np.float32)])
    scale = pad.reshape(-1, block_n).sum(1)
    assert (np.abs(got - want) <= 2 * block_n * EPS32 * scale).all()


def test_tile_window_zero_pads_the_last_tile(ref):
    w = _weights(50, seed=1, zeros=False)
    for t in range(4):
        want = np.asarray(ref.sampling.tile_window(jnp.asarray(w), t, 16))
        got = sampling.tile_window(_t(w), torch.tensor([t]), 16).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("total", [0.0, np.nan, np.inf, -1.0, 3.5])
def test_guarded_takes_the_fallback_exactly_when_mass_is_degenerate(
        ref, total):
    """The reference draws its fallback from ``fold_in(key, 0x0DD)``; the
    port takes that index as an argument and must pick the same side."""
    n = 40
    key = jax.random.PRNGKey(11)
    fb = int(jax.random.randint(jax.random.fold_in(key, GUARD_SALT), (), 0,
                                n, dtype=jnp.int32))
    want = int(ref.sampling._guarded(key, jnp.asarray(7, jnp.int32),
                                     jnp.asarray(total, jnp.float32), n))
    got = sampling._guarded(torch.tensor([7]), torch.tensor([fb]),
                            torch.tensor(total, dtype=torch.float32))
    assert int(got) == want


@pytest.mark.parametrize("sampler", ["cdf", "tiled"])
@pytest.mark.parametrize("degenerate", [False, True])
def test_categorical_matches_reference_draw_for_draw(ref, sampler,
                                                     degenerate):
    """The guarded draws fed the replayed (u, fallback) of a key pick what
    the reference picks from the key itself."""
    n, block_n = 300, 64
    w = np.zeros(n, np.float32) if degenerate else _weights(n, seed=9)
    wj, wt = jnp.asarray(w), _t(w)
    rparts = ref.sampling.tile_partials(wj, block_n)
    parts = sampling.tile_partials(wt, block_n)
    tol = cdf_tol(w)
    key = jax.random.PRNGKey(5)
    for _ in range(64):
        key, ks = jax.random.split(key)
        u = float(jax.random.uniform(ks, (), jnp.float32))
        fb = torch.tensor([int(jax.random.randint(
            jax.random.fold_in(ks, GUARD_SALT), (), 0, n,
            dtype=jnp.int32))])
        ut = torch.tensor(u, dtype=torch.float32)
        if sampler == "cdf":
            want = int(ref.sampling.categorical_cdf(ks, wj))
            got = int(sampling.categorical_cdf(ut, fb, wt))
        else:
            want = int(ref.sampling.categorical_tiled(ks, wj, rparts,
                                                      block_n=block_n))
            got = int(sampling.categorical_tiled(ut, fb, wt, parts,
                                                 block_n=block_n))
        if degenerate:
            assert got == want == int(fb)
        else:
            assert_same_draw(got, want, u, w, tol)


def test_draws_sample_is_reproducible_and_in_range():
    g = torch.Generator().manual_seed(3)
    a = sampling.Draws.sample(1000, 8, generator=g)
    b = sampling.Draws.sample(1000, 8,
                              generator=torch.Generator().manual_seed(3))
    assert all(torch.equal(x, y) for x, y in ((a.first, b.first),
                                              (a.u, b.u),
                                              (a.fallback, b.fallback)))
    assert a.u.shape == a.fallback.shape == (7,)
    assert ((a.u >= 0) & (a.u < 1)).all()
    assert ((a.fallback >= 0) & (a.fallback < 1000)).all()
    assert 0 <= int(a.first) < 1000
