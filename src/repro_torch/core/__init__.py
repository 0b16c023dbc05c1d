"""repro_torch.core — k-means++ seeding and Lloyd clustering behind the
backend-dispatched ClusterEngine in ``repro_torch.core.engine``."""
from repro_torch.core.engine import (Backend, ClusterEngine, CudaBackend,
                                     FusedBackend, KmeansppResult,
                                     LloydResult, ReferenceBackend,
                                     make_backend, pairwise_d2, point_d2)
from repro_torch.core.guards import (CheckpointError, ClusteringError,
                                     InvalidInputError, KernelFailureError,
                                     PipelineError)
from repro_torch.core.kmeans_parallel import (ParallelDraws,
                                              kmeans_parallel_init)
from repro_torch.core.kmeanspp import kmeanspp, random_init
from repro_torch.core.lloyd import assign, kmeans, lloyd, update
from repro_torch.core.sampling import Draws

__all__ = [
    "Backend", "ClusterEngine", "CudaBackend", "FusedBackend",
    "KmeansppResult", "LloydResult", "ReferenceBackend", "make_backend",
    "pairwise_d2", "point_d2", "CheckpointError", "ClusteringError",
    "InvalidInputError", "KernelFailureError", "PipelineError", "kmeanspp",
    "random_init", "kmeans_parallel_init", "ParallelDraws", "assign",
    "kmeans", "lloyd", "update", "Draws",
]
