"""The IVF serving workload: build an inverted-file index over a trained
k-means model and answer batched top-k queries (``serve.ivf``).

``IVF_SIFT1M`` has the shape of ANN-benchmarks' ``sift-128-euclidean``
(SIFT1M: 1,000,000 base rows of d = 128, 10,000 queries, recall@10). The
data are synthetic blobs of that shape made on the card from a seed (the
SIFT vectors are not in the repository); their structure is an assumption
with no published source (``chip_smoke.py`` phase 8 names its two cases). ``IVF_SMOKE`` is the JAX test
fixture's shape (``tests/test_ivf.py``), CPU-sized."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class IvfConfig:
    name: str
    n_points: int     # base rows
    dim: int
    n_queries: int
    k: int            # neighbours per query (recall@k)
    nlist: int        # inverted lists = k-means clusters
    nprobe: int       # lists probed per query
    pq_nsub: int      # PQ sub-spaces of the ADC path
    block_n: int = 0  # scan tile height; 0: the build's default
    max_iters: int = 25   # the build's Lloyd iterations
    source: str = ""
    reduced: tuple = ()


IVF_SIFT1M = IvfConfig(
    name="ivf-sift1m", n_points=1_000_000, dim=128, n_queries=10_000, k=10,
    nlist=1024, nprobe=1024 // 8, pq_nsub=16, max_iters=25,
    source="ANN-benchmarks sift-128-euclidean (SIFT1M, Jegou et al. 2011): "
           "1M base vectors, d=128, 10k queries, recall@10",
    reduced=(
        "nlist 1,024, where faiss's guideline (4*sqrt(n) to 16*sqrt(n)) "
        "gives 4,000-16,000 for 1M rows: the build seeds the lists one "
        "host-bound round each, so nlist is cut for the run's time; 4,096 "
        "waits on a faster seeding loop",
    ))
IVF_SMOKE = IvfConfig(
    name="ivf-smoke", n_points=4000, dim=16, n_queries=48, k=10, nlist=32,
    nprobe=8, pq_nsub=4, block_n=128,
    source="tests/test_ivf.py fixture: blobs(4000, 16, 32), 48 queries")
