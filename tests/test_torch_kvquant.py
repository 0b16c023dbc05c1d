"""KV-cache product quantization in the port against ``repro.serve.kvquant``.

``build_codebook`` fits one k-means problem per sub-space in one
``ClusterEngine.kmeans_batched`` sweep; ``encode`` codes each sub-vector
to its nearest code; ``compress_transformer_cache`` does both for every
(layer, kv head) of a cache. The reference runs on the CPU (its gated
batch-grid Pallas kernels interpreted, and its fused backend) on keys
whose draws the port replays (``test_torch_jaxref.key_draws``: the
reference splits its key per sub-space problem), at its tile geometry.

Held against the reference: the codebooks (each problem's seeds exactly,
its fit as the batched tests hold it), with ``order="morton"`` too; the
codes of one codebook outside near-ties (``assert_labels_match`` per
sub-space); ``decode`` bitwise; the cache layout, its codebooks and codes;
the metrics. Inside the port: the default engine is built at call time,
and the entry guards raise typed. The test marked ``cuda`` compresses on
the card with that default engine, two runs bitwise.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from test_torch_batched import _assert_rows_fit, _prev_centroids
from test_torch_batched_gated import _engines
from test_torch_jaxref import (EPS32, assert_labels_match, d2_tol,
                               exact_d2, key_draws,
                               ref)  # noqa: F401  (ref: fixture)
from repro_torch import convert
from repro_torch.core import ClusterEngine, InvalidInputError
from repro_torch.data import blobs, ordering
from repro_torch.serve import kvquant

N_SUB, TAKE, SEED = 4, 1500, 3
PAIRS = [("cuda", "pallas"), ("fused", "fused")]   # (port, reference)


def _vectors(n=TAKE, d=16, seed=0):
    return blobs(n, d, 12, seed=seed)[0]


def _sweep(ref, key, vectors, n_sub, take):
    """The reference's sub-space problems of ``build_codebook`` and its
    per-problem keys, as the port replays them."""
    dsub = vectors.shape[1] // n_sub
    stride = max(vectors.shape[0] // take, 1)
    sub = vectors[::stride][:take].reshape(take, n_sub, dsub)
    keys = ref.jax.random.split(key, n_sub)
    return np.ascontiguousarray(np.moveaxis(sub, 1, 0)), keys


@pytest.mark.parametrize("order", [None, "morton"])
@pytest.mark.parametrize("pair", PAIRS)
def test_build_codebook_matches_reference(ref, pair, order):
    """One codebook per sub-space from the same draws: each problem's fit
    (k = 64 codes, 4 iterations) as the batched tests hold it, the seeds
    of the (reordered) problems exactly."""
    from repro.serve import kvquant as rkv
    jax, jnp = ref.jax, ref.jnp
    x = _vectors()
    key = jax.random.PRNGKey(SEED)
    reng, eng = _engines(ref, pair[0], pair[1], TAKE, 16 // N_SUB, 128, 64)
    kw = dict(n_sub=N_SUB, n_codes=64, lloyd_iters=4, sample=TAKE,
              order=order)
    want = rkv.build_codebook(key, jnp.asarray(x), engine=reng, **kw)
    probs, keys = _sweep(ref, key, x, N_SUB, TAKE)
    draws = key_draws(keys, TAKE, 64)
    got = kvquant.build_codebook(x, engine=eng, draws=draws, **kw)
    assert got.centroids.shape == (N_SUB, 64, 16 // N_SUB)
    if order is not None:   # the port's Morton perms are the reference's
        perm = ordering.morton_order(torch.from_numpy(probs))[0]
        probs = np.take_along_axis(probs, perm.numpy()[..., None], 1)
    full = reng.kmeans_batched(keys, jnp.asarray(probs), 64, max_iters=4)
    np.testing.assert_array_equal(np.asarray(full.centroids),
                                  np.asarray(want.centroids))
    seeds = reng.seed_batched(keys, jnp.asarray(probs), 64)
    mine = eng.seed_batched(probs, 64, draws=draws)
    np.testing.assert_array_equal(mine.indices.numpy(),
                                  np.asarray(seeds.indices))
    prev = _prev_centroids(reng, ref, probs, np.asarray(seeds.centroids),
                           full.n_iters)
    res = eng.kmeans_batched(probs, 64, draws=draws, max_iters=4)
    assert torch.equal(res.centroids, got.centroids)
    _assert_rows_fit(res, convert.lloyd_result(*full[:4]), probs, prev)


def test_encode_decode_and_metrics_match_reference(ref):
    """On one codebook: codes equal outside near-ties per sub-space,
    ``decode`` bitwise, the relative error within fp32 rounding and the
    compression ratio exactly; the leading axes kept."""
    from repro.serve import kvquant as rkv
    jnp = ref.jnp
    x = _vectors(n=600, seed=2)
    rng = np.random.default_rng(0)
    cents = rng.normal(size=(N_SUB, 256, 4)).astype(np.float32)
    rcb = rkv.PQCodebook(jnp.asarray(cents))
    cb = convert.pq_codebook(cents)
    want = np.asarray(rkv.encode(jnp.asarray(x), rcb))
    got = kvquant.encode(x, cb)
    assert got.dtype == torch.uint8 and got.shape == (600, N_SUB)
    for s in range(N_SUB):
        xs = x[:, 4 * s:4 * s + 4]
        assert_labels_match(got[:, s].numpy(), want[:, s],
                            exact_d2(xs, cents[s]), d2_tol(xs, cents[s]))
    want = np.array(want)
    np.testing.assert_array_equal(
        kvquant.decode(torch.from_numpy(want), cb).numpy(),
        np.asarray(rkv.decode(jnp.asarray(want), rcb)))
    lead = kvquant.encode(x.reshape(20, 30, 16), cb)
    assert torch.equal(lead.reshape(600, N_SUB), got)
    pq, rpq = (kvquant.PQCache(got, cb),
               rkv.PQCache(jnp.asarray(got.numpy()), rcb))
    np.testing.assert_allclose(
        float(kvquant.reconstruction_error(x, pq)),
        float(rkv.reconstruction_error(jnp.asarray(x), rpq)), rtol=1e-5)
    assert kvquant.compression_ratio(x, pq) == rkv.compression_ratio(
        jnp.asarray(x), rpq)


def test_compress_transformer_cache_matches_reference(ref):
    """A small cache (2 layers, 2 kv heads, 1024 tokens sampled to 512,
    head_dim 16, ``n_sub`` 4) against the reference's fused backend: the
    layout and dtypes, every codebook within the batched fits' tolerance
    and every code outside near-ties, from the same draws (the k and v
    sweeps each replayed from ``fold_in(key, i)``)."""
    from repro.serve import kvquant as rkv
    jax, jnp = ref.jax, ref.jnp
    rng = np.random.default_rng(1)
    shape, take = (2, 1, 1024, 2, 16), 512
    cache = {"k": rng.normal(size=shape).astype(np.float32),
             "v": rng.normal(size=shape).astype(np.float32),
             "pos": np.int32(1024)}
    key = jax.random.PRNGKey(SEED)
    reng, eng = _engines(ref, "fused", "fused", take, 4, 128, 256)
    kw = dict(n_sub=N_SUB, lloyd_iters=3, sample=take)
    want = rkv.compress_transformer_cache(
        key, {k: jnp.asarray(v) for k, v in cache.items()}, engine=reng,
        **kw)
    draws = [key_draws(jax.random.split(jax.random.fold_in(key, i), 16),
                       take, 256) for i in range(2)]
    got = kvquant.compress_transformer_cache(cache, engine=eng, draws=draws,
                                             **kw)
    assert set(got) == set(want)
    for name in ("k", "v"):
        cb, codes = got[f"{name}_cb"], got[f"{name}_codes"]
        assert cb.shape == (2, 2, N_SUB, 256, 4) and cb.dtype == torch.float32
        assert codes.shape == (2, 1, 1024, 2, N_SUB)
        assert codes.dtype == torch.uint8
        x = cache[name]
        wcb = np.asarray(want[f"{name}_cb"])
        np.testing.assert_allclose(cb.numpy(), wcb, rtol=0,
                                   atol=take * EPS32 * float(np.abs(x).max()))
        wcodes = np.asarray(want[f"{name}_codes"])
        for li in range(2):
            for h in range(2):
                for s in range(N_SUB):
                    xs = x[li, 0, :, h, 4 * s:4 * s + 4]
                    c = wcb[li, h, s]
                    assert_labels_match(codes[li, 0, :, h, s].numpy(),
                                        wcodes[li, 0, :, h, s],
                                        exact_d2(xs, c), d2_tol(xs, c))
    assert kvquant.cache_bytes(got) == rkv.cache_bytes(want)


def test_entry_guards_and_default_engine():
    """Typed raises for a bad ``n_sub``, an empty or mismatched codebook,
    non-finite vectors (zeroed under 'sanitize'); without ``engine=`` the
    default engine is built at call time, on the card (here: raises)."""
    x = _vectors(n=300)
    eng = ClusterEngine(device="cpu")
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(InvalidInputError, match="n_sub"):
        kvquant.build_codebook(x, n_sub=5, engine=eng)
    cb = kvquant.build_codebook(x, n_sub=N_SUB, n_codes=16, lloyd_iters=2,
                                engine=eng, generator=gen)
    with pytest.raises(InvalidInputError, match="codebook"):
        kvquant.encode(x, kvquant.PQCodebook(torch.zeros((0, 4, 4))))
    with pytest.raises(InvalidInputError, match="dimension"):
        kvquant.encode(x[:, :8], cb)
    with pytest.raises(InvalidInputError, match="width"):
        kvquant.decode(torch.zeros((3, 2), dtype=torch.uint8), cb)
    bad = x.copy()
    bad[3, 1] = np.inf
    with pytest.raises(InvalidInputError, match="non-finite"):
        kvquant.encode(bad, cb)
    clean = kvquant.encode(bad, cb, validate="sanitize")
    assert torch.equal(clean[3], kvquant.encode(np.zeros((1, 16),
                                                         np.float32), cb)[0])
    small = kvquant.build_codebook(x[:10], n_sub=N_SUB, engine=eng,
                                   generator=gen)
    assert small.centroids.shape == (N_SUB, 256, 4)
    assert not small.centroids[:, 10:].any()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            kvquant.build_codebook(x, n_sub=N_SUB)


@pytest.mark.cuda
def test_compress_kv_on_the_card():
    """On the card, with the default engine built at call time: two runs
    of ``compress_kv`` give the same bits, codes each sub-vector's nearest
    code, the error below the data's own energy."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    kv = torch.randn((4, 2048, 64), generator=g, device="cuda")
    one = kvquant.compress_kv(kv, n_sub=8, lloyd_iters=4,
                              generator=torch.Generator().manual_seed(1))
    two = kvquant.compress_kv(kv, n_sub=8, lloyd_iters=4,
                              generator=torch.Generator().manual_seed(1))
    assert torch.equal(one.codes, two.codes)
    assert torch.equal(one.codebook.centroids, two.codebook.centroids)
    assert one.codes.shape == (4, 2048, 8) and one.codes.is_cuda
    assert float(kvquant.reconstruction_error(kv, one)) < 1.0
