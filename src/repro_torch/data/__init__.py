"""repro_torch.data — synthetic sources and the prefetching pipeline."""
from repro_torch.data.pipeline import DataPipeline
from repro_torch.data.synthetic import blobs, blobs_batched

__all__ = ["DataPipeline", "blobs", "blobs_batched"]
