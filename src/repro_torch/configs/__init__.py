"""repro_torch.configs — the paper's k-means workload (FULL + SMOKE)."""
from repro_torch.configs.kmeans_paper import FULL, SMOKE, KmeansConfig

__all__ = ["FULL", "SMOKE", "KmeansConfig"]
