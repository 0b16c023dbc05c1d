"""repro_torch.data — synthetic sources."""
from repro_torch.data.synthetic import blobs

__all__ = ["blobs"]
