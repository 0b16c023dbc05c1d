"""The paper's own workload: k-means++ seeding over N points in d dims
(the port's own copy of ``repro.configs.kmeans_paper``). The paper
evaluates d=2, N = 1M..10M, k = 10..100; ``FULL`` mirrors that and
``SMOKE`` is the CPU-sized version."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class KmeansConfig:
    name: str
    n_points: int
    dim: int
    k: int
    max_iters: int = 25


FULL = KmeansConfig(name="kmeans-paper", n_points=4_000_000, dim=2, k=50)
SMOKE = KmeansConfig(name="kmeans-smoke", n_points=8_192, dim=2, k=16)
