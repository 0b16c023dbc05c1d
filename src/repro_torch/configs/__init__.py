"""repro_torch.configs — the paper's k-means workload (FULL + SMOKE), the
batched PQ codebook sweep (KVQUANT_GEMMA2_2B + KVQUANT_SMOKE) and IVF
serving (IVF_SIFT1M + IVF_SMOKE)."""
from repro_torch.configs.ivf import IVF_SIFT1M, IVF_SMOKE, IvfConfig
from repro_torch.configs.kmeans_paper import FULL, SMOKE, KmeansConfig
from repro_torch.configs.kvquant import (KVQUANT_GEMMA2_2B, KVQUANT_SMOKE,
                                         BatchedKmeansConfig)

__all__ = ["FULL", "SMOKE", "KmeansConfig", "KVQUANT_GEMMA2_2B",
           "KVQUANT_SMOKE", "BatchedKmeansConfig", "IVF_SIFT1M", "IVF_SMOKE",
           "IvfConfig"]
