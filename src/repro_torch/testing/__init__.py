"""repro_torch.testing — deterministic fault injection for robustness
tests. Production code never imports it."""
from repro_torch.testing.faults import IVF_OFFSET_FAULTS, corrupt_list_offsets

__all__ = ["IVF_OFFSET_FAULTS", "corrupt_list_offsets"]
