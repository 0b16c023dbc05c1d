"""Hand-written Hopper kernels (CUDA C++ in ``csrc/``, built by nvcc at first
use and bound with ctypes — see ``_build``), each beside its plain torch
twin:

  kmeans_distance.py — K1, the prologue (norms and tile balls); K2/K5, the
                       seeding round ungated and bound-gated: D² min-update
                       + per-tile partial sums; K11/K12, the rejection
                       sampler's drawn-row D² and per-tile envelope cap;
                       K1, K7 and K8 over a batch of problems
  lloyd_assign.py    — K3/K6, the tiled assignment round ungated and
                       bound-gated: labels, D², per-tile partials and gaps,
                       per-super-tile cluster sums/counts; K10a and K10b
                       over a batch of problems; K4, the untiled round
                       (labels, D², (weighted) sums/counts over all rows),
                       and K9, K4 over a batch of problems
  ivf_scan.py        — K13/K14, the IVF scan, exact and PQ/ADC: per query,
                       its probed tiles in order behind the kth-distance
                       ball gate, merged into a lexicographic top-k
  pq_decode.py       — K16, single-token decode attention over a PQ-coded
                       KV cache: K scored through a per-query LUT, the
                       sequence split over blocks and merged in order
  flash_attention.py — K15, online-softmax attention (GQA, causal, sliding
                       window, softcap, q_offset; fp32 on the CUDA cores,
                       bf16 on the tensor cores), and its exact oracle

ops.py — the tile-height budget, the launch counters, the attention
wrappers' input check, and ``lloyd_assign`` (K4 or K9 by the points'
shape).
"""
