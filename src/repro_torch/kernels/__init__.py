"""Hand-written Hopper kernels (CUDA C++ in ``csrc/``, built by nvcc at first
use and bound with ctypes — see ``_build``), each beside its plain torch
twin:

  kmeans_distance.py — K2, the seeding round: D² min-update + per-tile
                       partial sums; centroids staged in shared memory
                       (constant-memory analogue) or re-read from global
  lloyd_assign.py    — K3, the tiled assignment round: labels, D², per-tile
                       partials and gaps, per-super-tile cluster sums/counts

ops.py — the tile-height budget and the launch counters.
"""
