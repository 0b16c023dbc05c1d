"""repro_torch.testing — deterministic fault injection for robustness
tests. Production code never imports it."""
from repro_torch.testing.faults import (ALL_FAULTS, FIT_FAULTS,
                                        IVF_OFFSET_FAULTS, REJECTION_FAULTS,
                                        SEED_FAULTS, FaultSpec,
                                        corrupt_list_offsets, flaky_read_fn,
                                        kill_prefetch)

__all__ = ["ALL_FAULTS", "FIT_FAULTS", "IVF_OFFSET_FAULTS",
           "REJECTION_FAULTS", "SEED_FAULTS", "FaultSpec",
           "corrupt_list_offsets", "flaky_read_fn", "kill_prefetch"]
