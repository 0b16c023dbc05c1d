"""The batched workload: the PQ codebook sweep of KV-cache compression.

``repro.serve.kvquant.compress_transformer_cache`` (``serve/kvquant.py:190``;
defaults ``n_sub=16``, ``sample=16384``, ``lloyd_iters=6``, 256 codes) fits
one k-means problem per (layer, kv head, sub-space) of a K (or V) cache
tensor, all of them in one ``ClusterEngine.kmeans_batched`` call.
``KVQUANT_GEMMA2_2B`` is that sweep on one tensor of the repo's
``gemma2_2b`` configuration (26 layers, 4 kv heads, head_dim 256, so
sub-spaces of 256 / 16 = 16 dims): 1664 problems of 16384 sampled rows
each, uncut. ``KVQUANT_SMOKE`` is the CPU-sized version."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class BatchedKmeansConfig:
    name: str
    batch: int       # problems: layers x kv heads x sub-spaces
    n_points: int    # rows per problem (the cache sample)
    dim: int         # sub-space width: head_dim / n_sub
    k: int           # codes per sub-space
    max_iters: int   # Lloyd iterations (kvquant's lloyd_iters)


KVQUANT_GEMMA2_2B = BatchedKmeansConfig(
    name="kvquant-gemma2-2b", batch=26 * 4 * 16, n_points=16384, dim=16,
    k=256, max_iters=6)
KVQUANT_SMOKE = BatchedKmeansConfig(
    name="kvquant-smoke", batch=3, n_points=2048, dim=16, k=8, max_iters=6)
