"""repro_torch.data — synthetic sources, the prefetching pipeline and
SemDeDup."""
from repro_torch.data.pipeline import DataPipeline
from repro_torch.data.semdedup import DedupResult, semdedup
from repro_torch.data.synthetic import blobs, blobs_batched

__all__ = ["DataPipeline", "DedupResult", "semdedup", "blobs",
           "blobs_batched"]
