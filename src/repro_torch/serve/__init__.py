"""repro_torch.serve — k-means++ KV-cache product quantization and IVF
vector search over trained models."""
from repro_torch.serve import kvquant
from repro_torch.serve.ivf import (IvfIndex, IvfPq, SearchResult,
                                   default_nprobe)

__all__ = ["kvquant", "IvfIndex", "IvfPq", "SearchResult", "default_nprobe"]
