"""repro_torch.configs — the paper's k-means workload (FULL + SMOKE) and the
batched PQ codebook sweep (KVQUANT_GEMMA2_2B + KVQUANT_SMOKE)."""
from repro_torch.configs.kmeans_paper import FULL, SMOKE, KmeansConfig
from repro_torch.configs.kvquant import (KVQUANT_GEMMA2_2B, KVQUANT_SMOKE,
                                         BatchedKmeansConfig)

__all__ = ["FULL", "SMOKE", "KmeansConfig", "KVQUANT_GEMMA2_2B",
           "KVQUANT_SMOKE", "BatchedKmeansConfig"]
