"""repro_torch.data — synthetic sources."""
from repro_torch.data.synthetic import blobs, blobs_batched

__all__ = ["blobs", "blobs_batched"]
