#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--json PATH] [--profile] [--ivf-data CASE]

Phases, each of which exits non-zero on failure:

0. The samplers' prefix sums: ``torch.cumsum`` and ``sampling.prefix_sum``
   (the fixed-order scan the samplers use), each run repeatedly on one
   tensor of the cdf sampler's length (n) and of the tiled sampler's two
   (n_tiles and block_n at the paper's shape); ``prefix_sum`` must give one
   bit pattern at each. The host time of one call of each is printed. For
   batched problems, one row scanned by the samplers' row scan must keep
   its bits whatever the number of rows beside it (``torch.cumsum`` along
   dim 1 is shown beside it, which does not), and rows 0, 1 and B−1 of a
   (B, n) ``prefix_sum`` at the codebook sweep's shape must be the 1-D
   calls.
1. Build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one nvcc per
   source, all at once) and print the build time and ptxas report. K15's
   kernels, bf16 (``flash_bf16_kernel<1|2|4>``) and fp32
   (``flash_tf32_kernel<1|2|4>``), must report no spill, at least 168
   registers at entry (what ``setmaxnreg`` hands to the two consumer
   warpgroups at 232, taken from the producer's 40), and hold HGMMA
   (``wgmma``) and UTMALDG (TMA load) instructions in their SASS
   (``cuobjdump -sass``); their registers, spills, dynamic shared memory
   and instruction counts are printed, before any of them is launched.
   The screened route's 44 kernels (K3, K6, K10a, K10b, K4, K9: pass A
   ``screen_kernel<stream, D, [gated], [chunked]>``, D 0, 8, 16 or 128,
   chunked past 256 centroids, pass B
   ``reduce_kernel<stream, [gated | untiled], 8 or 4 columns>``) must
   report no spill and pass A HGMMA in its SASS (K6's d = 128 instances
   among them), and pass A's ungated D = 16 instances for k <= 256 (the
   codebook sweep's) at most 128 registers (four CTAs an SM); K6's and
   K10b's split row pass (``row_kernel<stream, D>``), the row pass of K3,
   K4, K9 and K10a (``untiled_row_kernel<stream, D, R[, second]>``: at
   d = 2 with 4 or 8 rows a thread, below d = 8 with 4, the instances
   keeping the second best K3's and K10a's; past the screened widths
   ``wide_row_kernel<stream[, second]>``), K5 and K8
   (``gated_round_kernel<stream, resident | global, regs2 | regs | vec4 |
   vec8>``, and at wider rows ``wide_rows_kernel<stream, resident |
   global, staged | unstaged>`` then ``wide_tile_kernel``; K2 and K7 at
   d >= 8 their ungated vec4, vec8 and wide instances), the super reduces
   (``super_reduce_kernel``, ``chain_reduce_kernel``) and K14's part (a)
   (``adc_pair_topk_kernel<kR>``, ``adc_tile_sort_kernel``), 68 kernels,
   no spill; their registers are printed. So are K1's 14 (the lone route
   ``lone_kernel<V, G, all | part>`` and the template's kernel
   ``seed_prologue_kernel<wide>``, the wide route at ``wide`` and the
   template entry's kernel otherwise) and K11's and K12's (``tile_cap_kernel``
   and ``tile_envelope_kernel``), no spill; and K16's 11
   (``decode_kernel<q, V>`` for fp32 and bf16 queries at 1, 2 and 4 floats a
   load, ``pq_lut_kernel<q>``, and the template entry's ``pq_split_kernel``
   and ``pq_combine_kernel<q>``), no spill.
2. Hold every kernel against its plain PyTorch twin on the card, at the
   paper's shape (n = 4,000,000, d = 2; label-sorted for the gated seeding
   round, so its gate skips) and a ragged wide one (n = 100,003, d = 128):
   K1 (prologue; every output bitwise its template entry,
   ``seed_prologue_template``, and timed beside it, also at the IVF
   build's shape, 1,000,000 rows of d = 128 in 4,096-row tiles), K2
   (seeding round) with resident centroids on and off at
   m = 1 and m = 8, every K2 and K7 launch bitwise its template entry
   (``distance_min_update_template``, their body at every width before
   d >= 8 took K5's row loop) and timed beside it, K5's row loop on K2's
   work at ``FULL`` (every tile active, no row pruned) timed beside K2, K3 (tiled assignment) at k = 50 or 64 (tps > 1) and at
   k = 1, K5 (gated seeding round) at m = 1 and 8, resident on and off, with
   the gate's mask, all tiles, half and none active, every K5 launch
   bitwise its template entry (``distance_min_update_gated_template``, K5's
   kernel before) in all four outputs and timed beside it, and K6 (gated
   assignment) at k = 50 or 64 and k = 1 from a carried state whose lower
   bounds make the prune fire, with every tile, half the supers and the
   gate's mask active, every K3 launch (its screened route at d = 128, its
   row pass at d = 2) bitwise the template kernel's entry
   (``lloyd_assign_tiled_template``) in all six outputs and timed beside
   it and kernel by kernel (torch.profiler: pass A or the row pass, pass
   B, the super reduce), K11 (the rejection sampler's drawn-row D², row by
   row and for a round's 8 attempts in one launch, each entry bitwise the
   one-row launch; timed at 8) and K12 (its per-tile envelope caps, over
   K1's tile balls, and the hier round's whole tile envelope in one launch,
   ``tile_envelope``: the caps, the capped tile masses, the tight tiles and
   their count, bitwise ``tile_envelope_torch``, timed beside the caps
   alone) against a pending block of 8 centroids with count 0, 1
   and 8. Two launches must give
   identical bits, skipped tiles must keep their carried values, all-active
   K5 and K6 (the latter with no carried bound) must be bitwise K2 and K3,
   every K6 launch (its screened route at d = 128, its split row pass at
   d = 2) bitwise the template kernel's entry
   (``lloyd_assign_gated_template``) in all eight outputs, with the
   template entry's time printed beside K6's, and K11/K12 must be bitwise
   their plain twins (+inf everywhere at count 0). Each kernel's median
   time (CUDA events) is printed beside its plain
   twin's and its bound (for the gated kernels, from the bytes of the
   active tiles). The bf16 stream (``precision="bf16"``): K2 (m = 1,
   resident and not), K3, K5 (m = 1; the gate's mask resident and not, all
   active) and K6 on the points rounded to bf16, with the fp32 points'
   norms, each held three ways: against its twin at the fp32 case's
   tolerance, bitwise against the fp32 instance on the bf16 values widened
   back (the conversion is exact, the arithmetic the same), and bitwise
   against a second launch; its time beside the fp32 instance's there and
   its bound from the bf16 bytes, its dot products counted at the bf16
   tensor-core rate and the rest at fp32's. (All-active K5 is K2 but on
   the rows the bound prunes, which keep their D²: bitwise K2 in fp32.)
   K5 also on rows too wide for 32 staged a block (fp32 d = 1,024, bf16
   d = 2,048, 100,003 label-sorted rows, m = 1 and 8, resident and not,
   the gate's mask), bitwise and timed beside its template entry.
   Then (phase 2 (large k)) d = 128, k = 8,192 on 50,000 rows, past the
   template's staging (k <= 390 at 4,096-row tiles), pass A's old
   all-chunk norm staging and pass B's one-block limit (6,688 centroids):
   K3, K6 (all active, then a round from that state), K4 and K10a (two
   problems), each bitwise a second launch, labels and counts bitwise the
   plain twin's, D² within tolerance, sums over the kernel's labels, K3
   bitwise K10a problem by problem and all-active K6 bitwise K3; each
   launch timed beside its twin. Then (phase 2 (refused)) the shapes the
   template's whole-(k, d) staging refused, through the engine, counted,
   each round's kernel at that shape held to its twin (labels and counts
   bitwise on lattice data, D² within tolerance): a weighted ``fit`` at
   d = 5, k = 4,096 (K4); ``kmeans_batched`` at d = 4, k = 4,200, two
   problems of 20,000 rows, gated (K8, K10b) bitwise ungated (K7, K10a), and
   ``ops.lloyd_assign`` on them (K9); ``kmeans(bounds=False)`` at fp32
   d = 200, k = 300 (K3), weighted (K4), and bf16 d = 300 (K3); and the
   seeding round folding 1,024 centroids at d = 64 (K2, the guard heal's
   fold), resident bitwise not. Each of those assignment rounds' new
   routes (K4, K9, K10a, K10b, K3) also runs at the old cap on the same
   points, bitwise its template entry and timed beside it. Since slice 17
   also: a gated ``kmeans`` at d = 60,000 (K1 on its wide route, the
   template entry refusing; K5 and K6 reading the centroids from device
   memory where not one stages), K1 at the engine's tiles held to its twin
   (norms bitwise), K6 and K3 at that width held to theirs, a flat rejection
   seeding at d = 60,000 (K11 once a round, and on 8 rows bitwise its twin)
   and a hier rejection seeding at d = 8,000 with ``refresh_block`` 8 (K12
   on the (8, 8,000) block bitwise its twin and timed), each counted and
   held to its plain paths: the gated kmeans and the flat seeding bitwise
   the ungated card engine's, and all three against
   ``ClusterEngine(device="cpu")`` (the plain twins) from the same draws:
   seeds and the rejection counters equal, min_d2 within the D² tolerance,
   the kmeans's labels and n_iters equal, its centroids and inertia within
   fp32 roundings.
3. Drive the main path, ``ClusterEngine(device="cuda").kmeans`` (bound-gated)
   at the paper's size, k = 50, 25 iterations, for sampler cdf and tiled, on
   the shuffled blobs and on a label-sorted copy, with the launch counters
   zeroed just before each run and read just after (K1 once, K5 k times,
   K6 n_iters times, K2/K3 never); each run is held bitwise to
   ``bounds=False`` (seeds, centroids, assignment, inertia, n_iters), and a
   second run to the first. The ungated path is driven the same way
   (K2 k times, K3 n_iters times) and compared with the plain
   ``FusedBackend`` on the card from the same draws. Then the main path
   under ``precision="bf16"`` (shuffled blobs, cdf and tiled, gated and
   ungated), counted (gated: K1 once, bf16 K5 k, bf16 K6 n_iters; ungated:
   bf16 K2 k, bf16 K3 n_iters; no fp32 round), each bitwise a second run
   and its own seed then fit, its inertia within 15% of an fp32 fit from
   the same seeds (the reference's pin); the seeds and labels where gated
   and ungated bf16 differ are printed, not held (under bf16 the gate
   suppresses bf16-noise updates its bound proves spurious).
   Then (phase 3 (robustness)) the reference's robustness contract on the
   label-sorted copy, ``cuda`` backend: every fault of the matrix
   (``repro_torch.testing.FaultSpec`` through ``seed``/``fit``'s
   ``_fault=``: seeding ``nan_tile`` at round 2 and ``nan_state`` at the
   first round whose gate skips tile 0 and the first that skips other
   tiles only, the gated fit's ``zero_counts`` and ``nan_state`` at
   iterations 2 and 4, rejection hier's ``neg_envelope`` and
   ``stale_super`` at round 3) bitwise the clean run of the same call,
   ``recovered`` flagged where the plain twin (``fused`` on the card)
   flags it, each heal's extra launches and host ms printed; K5 and K6 on
   NaN carries (a skipped tile's NaN partial copied through, a NaN D² row
   kept NaN); the checkpointed gated ``seed`` (cdf, tiled; every 10
   rounds) and ``fit`` (25 iterations, every 5) bitwise the plain calls,
   and again after the newest two steps are deleted, each save's MB,
   snapshot and write ms printed beside the chunk before it; a resume
   with another k or precision raising ``CheckpointError``;
   ``fit_minibatch`` over a ``flaky_read_fn`` source bitwise the clean
   run, and ``kill_prefetch`` raising ``PipelineError`` with its step.
4. Rejection seeding at the paper's size, ``ClusterEngine(device="cuda")
   .seed/kmeans(sampler="rejection", refresh_block=8)`` for proposal hier
   and flat on both layouts, counted like phase 3: K1 once, K5 once per
   refresh (the schedule's, the exact fallbacks' and the settling one),
   K11 once per round that proposes (one launch prices every attempt of
   the round), K12 (the tile envelope) once per hier round with a live
   pending centroid (none in the round after a refresh) and never under
   flat; ungated, K2 in K5's place and no K12. Held: two runs bitwise
   equal; flat gated bitwise ungated (seeds, D², the kmeans fit); at
   ``refresh_block=1`` hier, flat and the tiled sampler pick the same
   seeds; the returned D² bitwise one K2 fold of all k seeds from +inf;
   the counters under ``core.telemetry``'s contract; the kmeans fit
   bitwise a fit from the seeding's seeds. Seeding ms of rejection beside
   tiled, gated and ungated (median of 3 host-clock runs).
5. Batched problems at ``kvquant-gemma2-2b`` (``configs/kvquant.py``: the
   PQ codebook sweep of one gemma2-2b K tensor, B = 1664 problems of
   n = 16384 rows, d = 16, k = 256, 6 Lloyd iterations; blobs made on the
   card from a seed), bounds off: K7 (batched seeding round, m = 1 and 8)
   and K10a (batched assignment round) against their plain twins, two
   launches bitwise, rows 0, 1 and B−1 bitwise K2 (K7) and every problem
   bitwise K3 (K10a) on that problem's slice, and K10a's screened-route
   counters (candidates per row, rows on the full scan); then ``ClusterEngine(device="cuda", bounds=False)
   .kmeans_batched`` for sampler cdf and tiled, counted (K7 k times, K10a
   once per iteration of the slowest problem, nothing else), a second run
   bitwise, rows 0, 1 and B−1 bitwise the single ``seed`` then ``fit``
   from the same draws, every problem's inertia within 1e-4 of the plain
   fit's from the same seeds. Printed: seeding ms, Lloyd ms per iteration,
   kmeans_batched s and ms per problem beside a loop of single seed + fit
   over 16 problems. K7 (m = 1) and K10a on the bf16 stream are held as
   phase 2's bf16 cases, rows 0, 1 and B−1 bitwise the single bf16 launch.
6. Gated batched problems (``bounds=True``, the default) at
   ``kvquant-gemma2-2b``: the batched K1 (prologue; bitwise its template
   entry and timed beside it), K8 (gated batched
   seeding round; m = 1 and 8, each problem's gate, every tile, and a
   mixed mask with tiles off and one problem off) and K10b (gated batched
   assignment round, from a carried state whose lower bounds make the
   prune fire; every tile, a mixed mask with supers off, the movement
   gate's) against their plain twins, two launches bitwise, skipped tiles
   keeping their carries, rows 0, 1 and B−1 bitwise K1/K5 and every
   problem bitwise the template's K6 (``lloyd_assign_gated_template``,
   for K10b) on that problem's slice; then ``ClusterEngine(device="cuda").kmeans_batched``
   for sampler cdf and tiled, on the sweep and on 16 problems of 4 blobs
   with rows sorted by blob (the tile gate skips), counted (the batched K1
   twice, one prologue per phase; K8 k times; K10b once per iteration of
   the slowest problem; nothing else), bitwise the ``bounds=False`` run
   (seeds, centroids, assignment, inertia, n_iters) and a second run, rows
   0, 1 and B−1 bitwise the single gated ``seed`` then ``fit`` with their
   skip and prune counters. Printed: the counters' totals, gated and
   ungated seconds. K8 (m = 1, the gate's mask and all active) and K10b
   (the gate's mask) on the bf16 stream, held as phase 5's. Then
   (phase 6 (screen)) K10a and K10b's screened route (d >= 8: a
   tensor-core screen with an exact recheck) on adversarial problems
   (B = 64, n = 16384, d in {8, 13, 16}, k in {250, 256}, fp32 and bf16:
   duplicated centroids, rows between two centroids and on one, a zero
   row, a NaN row, every other problem shifted by 1e3), each problem
   bitwise K3 / the template's K6 on its slice (compared as bit patterns, NaN equal to
   NaN), all-active K10b bitwise K10a, K10b screening exactly the rows that
   do not prune, the counters printed; and K10b at the IVF build's PQ
   sweep shape (16 problems, d = 8, k = 256) on its own.
   Then (phase 6 (rejection)) batched rejection seeding at
   ``kvquant-gemma2-2b``: the problem-list forms of K7 and K8 over an
   unsorted eighth of the problems against a pending block of 8 (the
   listed carries bitwise the full launch, the rest untouched, within
   tolerance of the twins, an empty list launching nothing), the batched
   K11 (8 attempts a problem) and K12 (the tile envelope, every eighth
   problem at count 0) bitwise their twins and the single launches on
   problems 0, 1 and B−1, each timed beside its twin and bound; then
   ``kmeans_batched(sampler="rejection")`` (refresh_block 8, hier, 8
   attempts) gated and ungated, counted (per seeding: one listed K8 or K7
   launch a round in which some problem's block filled, one a round in
   which some problem's attempts all rejected, the settle; K11 once a
   round; K12 once a round with a live pending centroid, gated; the
   batched K1 once per phase; K10b or K10a once per iteration), each
   problem's refreshes recorded from the listed launches and equal to its
   single seeding's (``refreshes``), rows 0, 1 and B−1 bitwise their single
   rejection seedings with their counters, two runs bitwise, the fit
   bitwise ``seed_batched`` then ``fit_batched``; the host syncs of one
   seeding (torch's sync debug mode), its seconds, device busy time and
   idle share beside the batched cdf and tiled seedings, and the fit's
   inertia over the cdf seeds' fit (printed, not held). Then 16 problems
   sorted by blob, each bitwise its single gated rejection seeding.
7. Weighted and mini-batch Lloyd. K4 (the untiled assignment round) at
   the paper's shape, unweighted and with integer weights 1–8, and at
   n = 100,003, d = 128, k = 64, and K9 (K4 over a batch of problems) at
   ``kvquant-gemma2-2b``, against their plain twins (labels outside
   near-ties, D² within tolerance, sums and counts over the kernel's own
   labels), two launches bitwise, every launch bitwise the template entry
   (``lloyd_assign_template``, ``lloyd_assign_batched_template``: K9 on
   every problem) in all four outputs, K4's labels and D² bitwise K3's,
   K9's rows 0, 1 and B−1 bitwise K4; each timed beside the template entry
   and kernel by kernel (torch.profiler over the route's launches: pass A
   or the row pass, pass B, the all-tile reduce), the screen's counters
   printed where it is screened; K9's path, ``ops.lloyd_assign`` on the
   sweep's (B, n, d) points against its fitted codebooks, one counted
   launch, codes bitwise K10a's labels. Then the weighted
   ``ClusterEngine(device="cuda").kmeans`` at the paper's size for cdf,
   tiled and rejection (hier, flat), counted (K1 once, K2 per round or
   refresh, K11 per proposing round, K12 per hier round with a live
   pending centroid, K4 per iteration, no
   K3/K5/K6), bitwise a second run and (but for hier, which tightens its
   envelope only with the tile balls) the ``bounds=False`` run, the kmeans
   bitwise its seeding's seeds then a weighted fit, the inertia within
   1e-4 of the plain twins' fit from the same seeds; and
   ``fit_minibatch`` over the paper's 4,000,000 points streamed from the
   host array through ``DataPipeline``, 16 batches of 262,144 rows, one
   pass, counted (K4 per batch), bitwise a second run. Printed: seeding
   ms (median of 3), Lloyd ms per iteration, kmeans s; ms per batch with the
   host-to-device copies and the device busy time (profiler), and the
   mini-batch inertia over all rows over the full-batch fit's. K4 (weighted
   and not) and K9 on the bf16 stream, held as phase 2's. Then the other
   entry points under ``precision="bf16"``, each counted and bitwise a
   second run: the weighted kmeans (cdf; K1, bf16 K2, bf16 K4),
   ``fit_minibatch`` (bf16 K4 per batch), ``kmeans_batched`` at
   ``kvquant-gemma2-2b`` gated (the batched K1, bf16 K8, bf16 K10b) and
   ungated (bf16 K7, bf16 K10a), and K9's path on the bf16 rows (bf16 K9).
8. IVF serving and KV-cache PQ at ``IVF_SIFT1M`` (``configs/ivf.py``:
   the shape of ANN-benchmarks' sift-128-euclidean, 1,000,000 rows of
   d = 128 and 10,000 queries, synthetic blobs made on the card, by
   default of an assumed low intrinsic dimension, with ``--ivf-data
   isotropic`` drawn in all 128 dimensions; nlist 1,024,
   nprobe 128, PQ with 16 sub-spaces). ``IvfIndex.build(layout="label",
   pq_nsub=16)`` on ``ClusterEngine(device="cuda")``, timed, the arguments
   of its K6 launches recorded; K6 again on each (bitwise the build's
   launch; the first, middle and last bitwise the template entry where
   its (k, d) staging fits, else bitwise K6 with pass B in 64-centroid
   chunks and all eight outputs held to the plain twin: pruned counts and
   pruned rows bitwise, labels outside near-ties, D², lb, partials and gaps
   within tolerance, sums and counts over the kernel's labels, skipped
   tiles' and supers' carries kept; the first's rows and
   centroids all-active without a bound bitwise K3), timed (their sum the
   build's K6 device time) with the screen's counters, the template entry
   timed on the middle one where it fits; K13
   (``ivf_scan``) and K14 (``ivf_adc_scan``) against their plain twins on
   the first 256 queries' probe maps at nprobe 128 and nlist (rows equal
   where the twin's adjacent D² clear twice the tolerance, dists within
   it, gate_skipped equal, then dists and rows bitwise; gate on bitwise
   gate off; two launches bitwise); ``search(nprobe=nlist)`` bitwise
   ``exhaustive`` and ADC
   within tolerance of decode-then-exact on 64 queries; over all 10,000
   queries ``check_ivf_counters``, a gate that skips, and every
   ``corrupt_list_offsets`` kind raising ``CorruptedStateError``; K13 and
   K14 timed at Q = 10,000, nprobe 128 (CUDA events, median of 3; K13's
   time is all of ``ivf_scan``: its glue, the tile top-k part and the
   replay, and K14's likewise; each tile top-k part with its glue is also
   timed alone, not counted) beside their twins run
   in chunks of 2,048 queries, whose outputs must be the kernel's bitwise,
   and their bounds (the larger of the bytes read once, each probed row's
   4d + 4 or n_sub + 8 bytes with the queries, tile lists and LUTs, and
   the operations, 2d or n_sub + 4 per scored row; for K14 also its LUT
   gathers' bound, n_sub a scored row, 32 a warp-wide shared-memory load,
   one an SM a clock at the card's highest SM clock); search ms, QPS and
   recall@10 (1,000 queries against ``exhaustive``) at nprobe 128 and
   1,024,
   exact and ADC, each search counted (one K13 or K14 launch). Then
   ``compress_transformer_cache`` on one gemma2_2b-shaped fp32 cache (26
   layers, 4 kv heads, head_dim 256, 16,384 tokens, n_sub 16) with its
   reconstruction error and compression, two runs bitwise; and
   ``kmeans(order="morton")`` at the paper's size: ``reorder`` the Morton
   permutation, the assignment the reordered fit's mapped back to the
   caller's rows, bitwise a second run. The cache and its PQ form go on
   to phase 9.
9. Attention at gemma2-2b's width (``GEMMA2``: 8 query heads over 4 kv
   heads, head_dim 256, window 4,096, softcap 50, context 8,192), inputs
   made on the card from the script's seed. A decode step over phase 8's
   compressed cache: one query per layer through K16
   (``pq_decode_attention``), 26 counted launches, at ``cache_len`` 8,192
   (an int) and 8,191 (a 0-d int32 tensor on the card); per layer K16
   within 2e-4 of its twin, of its template entry
   (``pq_decode_attention_template``, the three-launch kernel its redesign
   replaced) and of K15 over the reconstructed cache (decode form: Sq 1,
   ``causal=False``, keys cut at ``cache_len``), two launches bitwise, the
   arrival counters back at 0 after the step, and its relative error
   against K15 over the uncompressed cache printed (Gaussian data: not a
   gate). One layer's K16 is timed beside its template entry, its bound
   and the launch floor (a one-element add on the same stream), the
   device launches of one call counted by torch.profiler (it fails unless
   they are ``pq_lut_kernel`` once and ``decode_kernel`` once), and the whole
   26-layer step timed by CUDA events, K16 and the template entry. Prefill,
   Sq = Skv = 8,192, cap 50: a global (causal) and a local (window) layer
   in fp32 and bf16 through K15 (``flash_attention``: both on ``wgmma``
   tensor cores fed by TMA, fp32 in split TF32), 4 counted launches
   (2 of each kernel), each against its twin (blocked, so no score matrix
   is materialized; fp32 within 2e-5, bf16 within one bf16 ulp) and a
   second launch bitwise. K16's one-layer and K15's times (CUDA events)
   beside their twins' and their bounds (K16: the valid codes and both
   codebooks read once, bytes; K15: for bf16 inputs 4·hd flops per valid
   pair at bf16's rate; for fp32 the three TF32 products of 3xTF32, the
   fastest arithmetic that holds 2e-5, 12·hd flops a pair at TF32's rate,
   with 4·hd flops a pair at fp32's rate printed beside it), and at cap 0
   K15 in each dtype beside
   one ``torch.nn.functional.scaled_dot_product_attention(is_causal=True,
   enable_gqa=True)`` call on the global layer in the same dtype (the
   yardstick only: SDPA has no softcap, and the port never calls it). The prefill's host wall
   is printed beside its kernel time (the device's idle share).
10. The other training paths (phase 10 (init)). The Gumbel sampler at
   the paper's shape, gated (K1 once, K5 k times) and ungated (K2 k
   times): bitwise each other and a second run, the fused twin's seeds on
   the card from the same draws (D² within tolerance); a round's noise
   and draw timed on the device beside the tiled and cdf draws, and the
   seeding's host time beside theirs. Batched at the codebook sweep (the
   batched K1 once, K8 k times), rows 0, 1 and B−1 bitwise the single
   seedings, timed beside the batched tiled seeding. k-means|| at the
   paper's shape (l = 100, 5 rounds; K1 twice, K5 5 times at m = l, K4
   twice, K2 k times in the reduce), its peak allocation below an
   (n, n_cand) matrix, bitwise a second run; against the fused twin: the
   same candidates, K4's labels the twin's outside near-ties and the
   weights their counts, and the twin's reduce on these candidates and
   weights the same seeds (D² within tolerance); K5 at m = l, K4 against
   the 501 candidates, and K1 and K2 on the candidate rows, each held to
   its twin and timed. ``kmeans(init=...)`` for 'kmeans++', 'kmeans||' and
   'random' at the paper's shape, each bitwise a second run, their
   inertia printed side by side (not a gate). The reference backend's
   serial mode bitwise its global mode on the card. ``semdedup`` on
   200,000 embeddings of width 512 (CLIP ViT-B/16's; 1,024 topics, 2,000
   planted near-copies), k = 256, threshold 0.95: its keep mask against a
   plain pass that sorts the rows by cluster and compares within each
   cluster only (rows may differ only on the threshold's rounding), every
   copy that shares its source's cluster dropped, and the copies the
   clustering put elsewhere (they escape by design) at most 5% of them;
   its clustering bitwise its seeding then its fit, the fit from those
   seeds held to the fused twin's (inertia within 1e-4), its labels the
   plain assignment's against the centroids its last iteration read
   (outside near-ties), and K5 (m = 1) and K6 (k = 256, every tile
   and the gate's mask) at its shape held to their twins and timed; its
   (2048, n) fp32 products timed beside their bound. The Gumbel seeding,
   k-means|| and SemDeDup's fit are also profiled (device busy, idle
   share).
11. With ``--profile`` only: trace one seeding run per sampler (rejection
   hier and flat included) and one Lloyd fit at the paper's shape,
   ungated and gated (shuffled and sorted), the weighted seeding (cdf,
   tiled), the weighted fit and the mini-batch run, the batched seeding
   (cdf, tiled) and fit at the codebook sweep's, ungated and gated, the
   IVF build and one search per mode and the K16 decode step, and the
   bf16 gated seeding (cdf) and fit, with torch.profiler, and print the
   device time by kernel and the device's idle share.

Kernels are timed as medians of CUDA-event readings; the plain versions
of the batched kernels (K1's batched form, K7, K8, K9, K10a, K10b; 0.2–3 s
a call), the IVF twins (in chunks of queries) and K15's twin are timed
once.

The last three lines of stdout are the card's name and power limit, the
kernels' JSON record (the rounds' bf16 instances under ``<name>_bf16``;
every kernel must have launched on a driven path), and ``{"ok": true,
"device": {...}}``. Without a CUDA
device, or outside the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory rate
FP32_FLOP_PER_S = 67e12      # H100 SXM fp32 rate outside the tensor cores
BF16_FLOP_PER_S = 989e12     # H100 SXM dense bf16 tensor-core rate
TF32_FLOP_PER_S = 495e12     # H100 SXM dense TF32 tensor-core rate
EPS32 = 2.0 ** -23
# gemma2-2b's attention (src/repro/configs/gemma2_2b.py:8-11, Google's
# gemma-2-2b config): 26 layers, 8 query heads over 4 kv heads of head_dim
# 256, a 4,096-position window on alternate layers, scores softcapped at
# 50, an 8,192-token context
GEMMA2 = dict(layers=26, heads=8, kv_heads=4, head_dim=256, window=4096,
              softcap=50.0, context=8192)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout
    return out.strip().splitlines()[0]


def sm_clock_hz() -> float:
    """The card's highest SM clock (nvidia-smi's clocks.max.sm), in Hz."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], check=True,
                         capture_output=True, text=True).stdout
    return float(out.strip().splitlines()[0]) * 1e6


def gpu_ms(torch, fn, reps: int = 15, warmup: int = 3) -> float:
    """Median device time of ``fn`` from CUDA events. The launches are queued
    behind a device-side sleep, so each event pair brackets device work only,
    not the host's time to issue it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    torch.cuda._sleep(50_000_000)
    for s, e in zip(starts, ends):
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def bound_ms(n_bytes: float, flops: float,
             flop_rate: float = FP32_FLOP_PER_S) -> tuple[float, str]:
    t_b, t_f = n_bytes / HBM_BYTES_PER_S, flops / flop_rate
    return (max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations")


def round_bound_ms(torch, pts, n_bytes: float, dot_flops: float,
                   flops: float, tf32: bool = False) -> tuple[float, str]:
    """A round kernel's bound: the point-centroid dot products (``dot_flops``,
    2d a pair) at the rate of the stream's type (bf16 inputs with fp32
    accumulation run on the tensor cores at ``BF16_FLOP_PER_S``; fp32 at
    ``FP32_FLOP_PER_S``, or at TF32's ``TF32_FLOP_PER_S`` for the screened
    rounds, ``tf32``, whose exact recheck is counted with the rest), plus
    the remaining per-pair and per-row operations (``flops``) at the fp32
    rate; the larger of that time and the bytes' time."""
    dot_rate = (BF16_FLOP_PER_S if pts.dtype == torch.bfloat16
                else TF32_FLOP_PER_S if tf32 else FP32_FLOP_PER_S)
    return bound_ms(n_bytes, flops + dot_flops * FP32_FLOP_PER_S / dot_rate)


def bits_equal(torch, a, b) -> bool:
    """Bitwise equality; fp32 tensors compared as their int32 bit patterns,
    so that NaN equals NaN."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def every_problem(torch, what, out, single, bsz) -> None:
    """Every problem b of a batched round's outputs ``out`` bitwise the
    single-problem round ``single(b)`` on its slice."""
    for b in range(bsz):
        one = single(b)
        check(all(bits_equal(torch, u[b], v) for u, v in zip(out, one)),
              f"{what}: problem {b} is not bitwise the single kernel on its "
              "slice")


def screen_record(la, name, pts, torch) -> dict:
    """The screened route's counters of the last launch of ``name``, as
    shares: candidates per screened row (mean, most) and the share of
    screened rows on the full exact scan; {} off the route."""
    if not la.screened(pts.shape[-1], pts.dtype == torch.bfloat16):
        return {}
    st = la.screen_stats(name)
    rows = max(st["rows"], 1)
    return {"screened_rows": st["rows"],
            "candidates_per_row": st["candidates"] / rows,
            "max_candidates": st["max_candidates"],
            "full_scan_share": st["full_scan_rows"] / rows}


def screen_text(c: dict) -> str:
    if "screened_rows" not in c:
        return ""
    return (f"; screen: {c['screened_rows']} rows, "
            f"{c['candidates_per_row']:.3f} candidates a row (most "
            f"{c['max_candidates']}), {c['full_scan_share']:.4f} on the full "
            f"scan; fp32-FMA bound {c['fma_bound_ms']:.4f} ms")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def kernel_build(_build, lib: str, log: str, pat: str, name) -> dict:
    """The kernels of library ``lib`` whose mangled names match ``pat``,
    named by ``name(match)``: registers and spill bytes from the ptxas log
    (this run's, or the one kept beside a reused build), and the count of
    tensor-core (HGMMA) and TMA load (UTMALDG) instructions in each one's
    SASS."""
    out: dict = {}
    fn = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(pat, m.group(1))
            fn = name(k) if k else None
            continue
        m = fn and re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                             r"loads", line)
        if m:
            out.setdefault(fn, {}).setdefault(
                "spill_bytes", int(m.group(1)) + int(m.group(2)))
        m = fn and re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(fn, {}).setdefault("registers", int(m.group(1)))
    sass = subprocess.run(
        [_build.toolkit_bin("cuobjdump"), "-sass",
         str(_build.library_path(lib))],
        check=True, capture_output=True, text=True).stdout
    for part in sass.split("Function : ")[1:]:
        k = re.search(pat, part.split("\n", 1)[0])
        if k:
            c = out.setdefault(name(k), {})
            c["HGMMA"] = part.count("HGMMA")
            c["UTMALDG"] = part.count("UTMALDG")
    return out


def k15_build(_build, log: str) -> dict:
    """K15's instances, bf16 (``flash_bf16_kernel<chunks>``) and fp32
    (``flash_tf32_kernel<chunks>``), as ``kernel_build`` reads them."""
    return kernel_build(
        _build, "flash_attention", log, r"flash_(bf16|tf32)_kernelILi(\d+)E",
        lambda m: f"flash_{m.group(1)}_kernel<{m.group(2)}>")


def screen_build(_build, log: str) -> dict:
    """The screened route's kernels (K3, K6, K10a, K10b, K4 and K9 at
    d >= 8): pass A (``screen_kernel<stream, D, [gated], [chunked]>``, D the
    compiled width or 0, chunked the instance past 256 centroids) and pass
    B (``reduce_kernel<stream, [gated | untiled], columns>``, the tiled,
    gated and untiled instances at 8 and at 4 columns a slice), as
    ``kernel_build`` reads them."""
    return kernel_build(
        _build, "lloyd_assign", log,
        r"(screen_kernel|reduce_kernel)I(f|13__nv_bfloat16)(?:Li(\d+)E)?"
        r"Lb([01])ELb([01])E(?:Li(\d+)E)?",
        lambda m: (f"{m.group(1)}<{'fp32' if m.group(2) == 'f' else 'bf16'}"
                   + (f", {m.group(3)}" if m.group(3) else "")
                   + (", gated" if m.group(4) == "1" else "")
                   + ((", chunked" if m.group(1) == "screen_kernel"
                       else ", untiled") if m.group(5) == "1" else "")
                   + (f", {m.group(6)} cols" if m.group(6) else "") + ">"))


def split_build(_build, logs: dict) -> dict:
    """K6's split row pass (``row_kernel<stream, D>``, D 2 or 0), the row
    pass of K3, K4, K9 and K10a (``untiled_row_kernel<stream, D, R[,
    second]>``, D 2 or 0, R rows a thread, and past the screened widths
    ``wide_row_kernel<stream[, second]>``; the instances keeping the second
    best are K3's and K10a's), K5 and K8 (``gated_round_kernel<stream,
    resident, path>``, ``wide_rows_kernel<stream, resident, staged>`` and
    ``wide_tile_kernel``), the super reduces (``super_reduce_kernel``,
    ``chain_reduce_kernel``) and K14's part (a) (``adc_pair_topk_kernel
    <kR>``, ``adc_tile_sort_kernel``), as ``kernel_build`` reads them."""
    out = kernel_build(
        _build, "lloyd_assign", logs["lloyd_assign"],
        r"(?<!untiled_)row_kernelI(f|13__nv_bfloat16)Li(\d+)E",
        lambda m: (f"row_kernel<{'fp32' if m.group(1) == 'f' else 'bf16'}, "
                   f"{m.group(2)}>"))
    out.update(kernel_build(
        _build, "lloyd_assign", logs["lloyd_assign"],
        r"untiled_row_kernelI(f|13__nv_bfloat16)Li(\d+)ELi(\d+)ELb([01])E",
        lambda m: (f"untiled_row_kernel<"
                   f"{'fp32' if m.group(1) == 'f' else 'bf16'}, "
                   f"{m.group(2)}, {m.group(3)}"
                   f"{', second' if m.group(4) == '1' else ''}>")))
    out.update(kernel_build(
        _build, "lloyd_assign", logs["lloyd_assign"],
        r"wide_row_kernelI(f|13__nv_bfloat16)Lb([01])E",
        lambda m: (f"wide_row_kernel<"
                   f"{'fp32' if m.group(1) == 'f' else 'bf16'}"
                   f"{', second' if m.group(2) == '1' else ''}>")))
    out.update(kernel_build(
        _build, "kmeans_distance", logs["kmeans_distance"],
        r"gated_round_kernelI(f|13__nv_bfloat16)Lb([01])ELi(\d)ELb([01])E",
        lambda m: (f"gated_round_kernel<"
                   f"{'fp32' if m.group(1) == 'f' else 'bf16'}, "
                   f"{'resident' if m.group(2) == '1' else 'global'}, "
                   f"{('regs2', 'regs', 'vec4', 'vec8')[int(m.group(3))]}"
                   f"{'' if m.group(4) == '1' else ', ungated'}>")))
    out.update(kernel_build(
        _build, "kmeans_distance", logs["kmeans_distance"],
        r"wide_(rows_kernelI(f|13__nv_bfloat16)Lb([01])ELb([01])ELb([01])E|"
        r"tile_kernelILb([01])E)",
        lambda m: (f"wide_rows_kernel<"
                   f"{'fp32' if m.group(2) == 'f' else 'bf16'}, "
                   f"{'resident' if m.group(3) == '1' else 'global'}, "
                   f"{'staged' if m.group(4) == '1' else 'unstaged'}"
                   f"{'' if m.group(5) == '1' else ', ungated'}>"
                   if m.group(2) else "wide_tile_kernel"
                   + ("" if m.group(6) == "1" else "<ungated>"))))
    out.update(kernel_build(
        _build, "lloyd_assign", logs["lloyd_assign"],
        r"\d((?:super|chain)_reduce_kernel)E", lambda m: m.group(1)))
    out.update(kernel_build(
        _build, "ivf_scan", logs["ivf_scan"],
        r"adc_(pair_topk_kernelILi(\d)E|tile_sort_kernel)",
        lambda m: (f"adc_pair_topk_kernel<{m.group(2)}>" if m.group(2)
                   else "adc_tile_sort_kernel")))
    return out


def k1_build(_build, logs: dict) -> dict:
    """K1's kernels (the lone route ``lone_kernel<V, G, all | part>``, and
    the template's kernel ``seed_prologue_kernel<wide>``: the wide route
    at ``wide``, the template entry's kernel otherwise) and K11's and
    K12's, as ``kernel_build`` reads them."""
    out = kernel_build(
        _build, "seed_prologue", logs["seed_prologue"],
        r"lone_kernelILi(\d)ELi(\d)ELb([01])E|seed_prologue_kernelILb([01])E",
        lambda m: (f"lone_kernel<{m.group(1)}, {m.group(2)}, "
                   f"{'all' if m.group(3) == '1' else 'part'}>" if m.group(1)
                   else "seed_prologue_kernel<"
                   f"{'wide' if m.group(4) == '1' else 'template'}>"))
    out.update(kernel_build(
        _build, "rejection", logs["rejection"],
        r"(row_min_d2_kernel|tile_cap_kernel|tile_envelope_kernel)",
        lambda m: m.group(1)))
    return out


def k16_build(_build, log: str) -> dict:
    """K16's kernels (``decode_kernel<q, V>``, ``pq_lut_kernel<q>``) and its
    template entry's (``pq_split_kernel``, ``pq_combine_kernel<q>``), q the
    query's type, as ``kernel_build`` reads them."""
    def q(t):
        return "fp32" if t == "f" else "bf16"
    return kernel_build(
        _build, "pq_decode", log,
        r"(decode_kernelI(f|13__nv_bfloat16)Li(\d)E|"
        r"pq_(lut|combine)_kernelI(f|13__nv_bfloat16)E|pq_split_kernel)",
        lambda m: (f"decode_kernel<{q(m.group(2))}, {m.group(3)}>"
                   if m.group(2) else
                   f"pq_{m.group(4)}_kernel<{q(m.group(5))}>" if m.group(4)
                   else "pq_split_kernel"))


def d2_tol(torch, norms, cents) -> float:
    """Largest |kernel − plain| allowed on a matmul-form D². Each side's
    error is at most (d + 4)·eps·(‖x‖² + ‖c‖²): d roundings in the dot
    product plus the two add/subtracts; the two sides can err in opposite
    directions."""
    d = cents.shape[1]
    c = cents.float()
    cmax = float((c * c).sum(dim=1).max())
    return 2 * (d + 4) * EPS32 * (float(norms.max()) + cmax)


def partial_tol(d2tol: float, block_n: int, partials) -> "object":
    """Per-tile partial tolerance: block_n rows of D² error, plus the two
    reduction orders, each within block_n·eps of the tile's sum."""
    return block_n * d2tol + 2 * block_n * EPS32 * partials.abs()


def label_diffs(torch, d2, lab, want, tol) -> tuple[int, int]:
    """(rows whose labels differ, rows among them whose two picks' D² lie
    more than ``tol`` apart): within the D² tolerance either label is a
    correct argmin."""
    diff = lab.long() != want.long()
    gap = (d2.gather(1, lab.long()[:, None])
           - d2.gather(1, want.long()[:, None])).abs()[:, 0]
    return int(diff.sum()), int((diff & (gap > tol)).sum())


def widened(torch, what, call, pts, cents, out, reps=15):
    """A bf16 launch's outputs ``out`` against the fp32 instance of its
    kernel, ``call(points, centroids)``, on the bf16 points and centroids
    widened back: bitwise (the conversion is exact and every later
    operation the same). Returns the fp32 instance's median time on the
    widened copy; None (nothing run) for an fp32 case."""
    if pts.dtype != torch.bfloat16:
        return None
    pu, cu = pts.float(), cents.float()
    full = call(pu, cu)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(out, full)),
          f"{what} bf16: not bitwise the fp32 kernel on the widened copy")
    del full
    return gpu_ms(torch, lambda: call(pu, cu), reps=reps)


def stream_tag(torch, pts) -> str:
    return "bf16" if pts.dtype == torch.bfloat16 else "fp32"


def print_bf16(name: str, c: dict) -> None:
    """One bf16 kernel case: its error against the twin, its time beside
    the fp32 instance's on the widened copy (bitwise the same outputs) and
    its bound from the bf16 stream's bytes (``round_bound_ms``)."""
    shape = (f"B={c['batch']} " if "batch" in c else "") \
        + f"n={c['n']} d={c['d']}" \
        + "".join(f" {key}={c[key]}" for key in ("m", "k", "resident", "mask")
                  if key in c)
    fp32 = ("not timed" if c["fp32_ms"] is None
            else f"{c['fp32_ms']:.4f} ms")
    print(f"{name} bf16 {shape}: err {c['max_abs_err']:.3g} (tol "
          f"{c['tol']:.3g}), bitwise the fp32 kernel on the widened copy "
          f"and a second launch; {c['ms']:.4f} ms (fp32 instance {fp32}), "
          f"plain " + ("not timed" if c["plain_ms"] is None
                       else f"{c['plain_ms']:.4f} ms")
          + f", bound {c['bound_ms']:.4f} ms ({c['bound_by']})"
          + screen_text(c))


def k2_case(torch, kd, ops, pts, norms, m, resident, gen):
    n, d = pts.shape
    bn = ops.choose_block_n(n, d, 50)
    rows = torch.randint(n, (2 * m,), generator=gen, device=pts.device)
    cents = pts[rows[:m]].contiguous()
    md_in, _ = kd.distance_min_update_torch(
        pts, norms, pts[rows[m:]].contiguous(),
        torch.full((n,), torch.inf, device=pts.device), block_n=bn)
    out1 = kd.distance_min_update(pts, norms, cents, md_in, block_n=bn,
                                  resident=resident)
    out2 = kd.distance_min_update(pts, norms, cents, md_in, block_n=bn,
                                  resident=resident)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(out1, out2)),
          f"K2 m={m} resident={resident}: two launches differ")
    ref = kd.distance_min_update_torch(pts, norms, cents, md_in, block_n=bn)
    tol = d2_tol(torch, norms, cents)
    err_md = float((out1[0] - ref[0]).abs().max())
    check(err_md <= tol, f"K2 min_d2 err {err_md} > {tol}")
    ptol = partial_tol(tol, bn, ref[1])
    check(bool(((out1[1] - ref[1]).abs() <= ptol).all()),
          f"K2 partials outside tolerance (max err "
          f"{float((out1[1] - ref[1]).abs().max())})")
    fp32_ms = widened(torch, f"K2 m={m} resident={resident}",
                      lambda p, c: kd.distance_min_update(
                          p, norms, c, md_in, block_n=bn, resident=resident),
                      pts, cents, out1)
    ms = gpu_ms(torch, lambda: kd.distance_min_update(
        pts, norms, cents, md_in, block_n=bn, resident=resident))
    # the template entry (K2's kernel at every width before d >= 8 took
    # K5's row loop): bitwise, and timed beside it
    what = f"K2 {stream_tag(torch, pts)} d={d} m={m} resident={resident}"
    same_bits(torch, f"{what} vs the template entry", out1,
              kd.distance_min_update_template(pts, norms, cents, md_in,
                                              block_n=bn, resident=resident))
    template_ms = gpu_ms(torch, lambda: kd.distance_min_update_template(
        pts, norms, cents, md_in, block_n=bn, resident=resident))
    print(f"  {what}: bitwise the template entry; template entry "
          f"{template_ms:.4f} ms")
    plain = gpu_ms(torch, lambda: kd.distance_min_update_torch(
        pts, norms, cents, md_in, block_n=bn))
    t = -(-n // bn)
    xb = pts.element_size()
    bms, by = round_bound_ms(torch, pts,
                             xb * (n * d + m * d) + 4 * (3 * n + t),
                             n * m * 2 * d, n * m * 3)
    return dict(n=n, d=d, m=m, resident=resident, block_n=bn,
                stream=stream_tag(torch, pts), max_abs_err=err_md, tol=tol,
                ms=ms, template_ms=template_ms, plain_ms=plain,
                fp32_ms=fp32_ms, bound_ms=bms, bound_by=by)


def super_sums_ok(torch, pts, lab, ssums, scounts, rows_per_super,
                  supers=None, s_of=None, w=None) -> bool:
    """Super-tile sums and counts against a float64 segment sum over the
    KERNEL's labels ``lab``: counts exact, sums within 1e-4 of the rows'
    absolute sum (the sequential fp32 adds of up to ``rows_per_super``
    rows). ``supers`` (n_super,) bool restricts the check to those supers;
    ``s_of`` (n,) gives each row's super when it is not row //
    rows_per_super (batched problems flattened into one). ``w`` (n,)
    weighs the rows (integer weights keep the counts exact in fp32)."""
    n, d = pts.shape
    n_super, k = scounts.shape
    if s_of is None:
        s_of = torch.arange(n, device=pts.device) // rows_per_super
    slot = s_of * k + lab.long()
    w64 = None if w is None else w.double()
    want_c = torch.bincount(slot, weights=w64,
                            minlength=n_super * k).view(n_super, k)
    x64 = pts.double() if w is None else pts.double() * w64[:, None]
    want_s = torch.zeros(n_super * k, d, dtype=torch.float64,
                         device=pts.device).index_add_(0, slot, x64)
    abs_s = torch.zeros_like(want_s).index_add_(0, slot, x64.abs())
    ok_s = ((ssums.double().view(-1, d) - want_s).abs()
            <= 1e-4 * abs_s + 1e-6).view(n_super, k, d).all(dim=2)
    ok = ok_s & (scounts == want_c.float())
    if supers is not None:
        ok = ok[supers]
    return bool(ok.all())


def k3_case(torch, la, ops, bounds, pts, norms, k, gen):
    """K3 on one shape: two launches bitwise, and bitwise the template entry
    (``lloyd_assign_tiled_template``) in all six outputs; against its plain
    twin (labels outside near-ties, D², partials and gaps within
    tolerance, sums and counts over its own labels); times (the route, the
    template entry, the route's kernels by the profiler), the screen's
    counters where it is screened, and the bound (the screened route's
    dots at TF32's rate on fp32 streams)."""
    n, d = pts.shape
    bn = ops.choose_block_n(n, d, k)
    tps = bounds.tiles_per_super(-(-n // bn))
    cents = pts[torch.randint(n, (k,), generator=gen,
                              device=pts.device)].contiguous()
    out1 = la.lloyd_assign_tiled(pts, norms, cents, block_n=bn, tps=tps)
    stats = screen_record(la, "lloyd_assign_tiled", pts, torch)
    out2 = la.lloyd_assign_tiled(pts, norms, cents, block_n=bn, tps=tps)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(out1, out2)),
          f"K3 k={k}: two launches differ")
    same_bits(torch, f"K3 n={n} d={d} k={k} vs the template entry", out1,
              la.lloyd_assign_tiled_template(pts, norms, cents, block_n=bn,
                                             tps=tps))
    lab, md, part, gap, ssums, scounts = out1
    ref = la.lloyd_assign_tiled_torch(pts, norms, cents, block_n=bn, tps=tps)
    tol = d2_tol(torch, norms, cents)
    n_diff, bad = label_diffs(torch, la.tile_d2(pts, cents, norms), lab,
                              ref[0], tol)
    check(bad == 0, f"K3 k={k}: {bad} labels differ beyond near-ties")
    err_md = float((md - ref[1]).abs().max())
    check(err_md <= tol, f"K3 min_d2 err {err_md} > {tol}")
    check(bool(((part - ref[2]).abs() <= partial_tol(tol, bn, ref[2])).all()),
          "K3 partials outside tolerance")
    # gaps are distance units: sqrt turns a D² error δ into at most √δ
    gfin = torch.isfinite(ref[3])
    check(torch.equal(torch.isfinite(gap), gfin)
          and bool(((gap - ref[3])[gfin].abs() <= 2 * math.sqrt(tol)).all()),
          "K3 gaps outside tolerance")
    check(super_sums_ok(torch, pts, lab, ssums, scounts, bn * tps),
          f"K3 k={k}: super sums or counts outside tolerance")
    n_super = ssums.shape[0]
    fp32_ms = widened(torch, f"K3 k={k}", lambda p, c: la.lloyd_assign_tiled(
        p, norms, c, block_n=bn, tps=tps), pts, cents, out1)
    scr = la.screened(d, pts.dtype == torch.bfloat16)
    times = untiled_times(torch, la.lloyd_assign_tiled,
                          la.lloyd_assign_tiled_template,
                          (pts, norms, cents), dict(block_n=bn, tps=tps), 15)
    plain = gpu_ms(torch, lambda: la.lloyd_assign_tiled_torch(
        pts, norms, cents, block_n=bn, tps=tps))
    t = -(-n // bn)
    xb = pts.element_size()
    work = (xb * (n * d + k * d)
            + 4 * (3 * n + 2 * t + n_super * k * (d + 1)),
            n * k * 2 * d, n * k * 3 + n * d)
    bms, by = round_bound_ms(torch, pts, *work, tf32=scr)
    if scr:
        stats["fma_bound_ms"] = round_bound_ms(torch, pts, *work)[0]
    return dict(n=n, d=d, k=k, block_n=bn, tps=tps,
                stream=stream_tag(torch, pts),
                route=("screened" if scr else "row pass" if d < 8
                       else "template"),
                label_diffs=n_diff, max_abs_err=err_md, tol=tol,
                plain_ms=plain, fp32_ms=fp32_ms, bound_ms=bms, bound_by=by,
                **times, **stats)


def timed(torch, fn, plain):
    return gpu_ms(torch, fn), gpu_ms(torch, plain)


def bitwise_err(torch, a, b) -> float:
    """Largest |a − b|, with equal entries (+inf included) counting 0."""
    return float(torch.where(a == b, 0.0, (a - b).abs()).max())


def rejection_kernel_cases(torch, kd, pts, centers, radii, gen, p=8,
                           attempts=8):
    """K11 and K12 on one shape against a (p, d) pending block, count 0, 1
    and p: each launch bitwise its plain twin and a second launch, +inf
    everywhere at count 0; K11 at four drawn rows one by one and at the
    ``attempts`` of a round in one launch (the rejection loop's form), each
    entry bitwise the one-row launch. Timed at count p (K11 at ``attempts``
    rows, and at one beside)."""
    n, d = pts.shape
    dev = pts.device
    pend = pts[torch.randint(n, (p,), generator=gen, device=dev)].contiguous()
    rows = torch.randint(n, (4,), generator=gen, device=dev)
    many = torch.randint(n, (attempts,), generator=gen, device=dev)
    # a hier round's envelope inputs: rows a tile as the tile masses, and
    # partials that the caps of a fuller pending block undercut
    t = centers.shape[0]
    tile_w = torch.full((t,), float(-(-n // t)), device=dev)
    partials = kd.tile_cap_torch(centers, radii, pend[:1], 1) * tile_w
    err11 = err12 = 0.0
    n_tight = 0
    for count in (0, 1, p):
        cnt = torch.tensor(count, dtype=torch.int32, device=dev)
        what = f"n={n} d={d} count={count}"
        for i in rows.unbind():
            a = kd.row_min_d2(pts, i, pend, cnt)
            b = kd.row_min_d2(pts, i, pend, cnt)
            plain = kd.row_min_d2_torch(pts, i, pend, cnt)
            check(torch.equal(a, b), f"K11 {what}: two launches differ")
            check(torch.equal(a, plain),
                  f"K11 {what}: {float(a)} is not the plain {float(plain)}")
            err11 = max(err11, bitwise_err(torch, a, plain))
            check(count > 0 or bool(torch.isinf(a)), f"K11 {what}: not +inf")
        got = kd.row_min_d2(pts, many, pend, cnt)
        check(bits_equal(torch, got, kd.row_min_d2(pts, many, pend, cnt))
              and bits_equal(torch, got, kd.row_min_d2_torch(pts, many, pend,
                                                             cnt))
              and all(bits_equal(torch, got[j], kd.row_min_d2(
                  pts, many[j], pend, cnt)) for j in range(attempts)),
              f"K11 {what}: {attempts} rows in one launch are not the plain "
              "version's, a second launch's or the one-row launches'")
        err11 = max(err11, bitwise_err(torch, got, kd.row_min_d2_torch(
            pts, many, pend, cnt)))
        c1 = kd.tile_cap(centers, radii, pend, cnt)
        c2 = kd.tile_cap(centers, radii, pend, cnt)
        plain = kd.tile_cap_torch(centers, radii, pend, cnt)
        check(torch.equal(c1, c2), f"K12 {what}: two launches differ")
        check(torch.equal(c1, plain), f"K12 {what}: not bitwise the plain "
              f"version (max err {bitwise_err(torch, c1, plain)})")
        err12 = max(err12, bitwise_err(torch, c1, plain))
        check(bool(torch.isinf(c1).all()) if count == 0
              else bool(torch.isfinite(c1).all()),
              f"K12 {what}: +inf where it should not be, or missing")
        env = kd.tile_envelope(centers, radii, pend, cnt, partials, tile_w)
        check(all(bits_equal(torch, a, b) for a, b in zip(
            env, kd.tile_envelope(centers, radii, pend, cnt, partials,
                                  tile_w)))
              and all(bits_equal(torch, a, b) for a, b in zip(
                  env, kd.tile_envelope_torch(centers, radii, pend, cnt,
                                              partials, tile_w)))
              and bits_equal(torch, env[0], c1),
              f"K12 {what}: the tile envelope is not bitwise its twin, a "
              "second launch's, or its caps K12's")
        n_tight = int(env[3])
    i = rows[0]
    cnt = torch.tensor(p, dtype=torch.int32, device=dev)
    ms11, plain11 = timed(torch, lambda: kd.row_min_d2(pts, many, pend, cnt),
                          lambda: kd.row_min_d2_torch(pts, many, pend, cnt))
    ms11_one = gpu_ms(torch, lambda: kd.row_min_d2(pts, i, pend, cnt))
    cap_ms = gpu_ms(torch, lambda: kd.tile_cap(centers, radii, pend, cnt))
    ms12, plain12 = timed(
        torch, lambda: kd.tile_envelope(centers, radii, pend, cnt, partials,
                                        tile_w),
        lambda: kd.tile_envelope_torch(centers, radii, pend, cnt, partials,
                                       tile_w))
    # K11 reads the drawn rows, the block, idx and count and writes a float
    # a row; K12 as the hier round runs it (the tile envelope) reads the
    # balls, the block, the partials, the tile masses and count and writes
    # the caps, the capped masses, the tight flags and their count
    b11, by11 = bound_ms(4 * (attempts * (d + 1) + p * d) + 8 * attempts + 4,
                         attempts * p * 3 * d)
    b12, by12 = bound_ms(4 * (t * (d + 1) + p * d + 2 * t) + 4
                         + 9 * t + 4, t * (p * 3 * d + 3 + 3))
    return (dict(n=n, d=d, p=p, a=attempts, max_abs_err=err11, ms=ms11,
                 one_row_ms=ms11_one, plain_ms=plain11, bound_ms=b11,
                 bound_by=by11),
            dict(n=n, d=d, p=p, tiles=t, max_abs_err=err12, ms=ms12,
                 tile_cap_ms=cap_ms, tight=n_tight, plain_ms=plain12,
                 bound_ms=b12, bound_by=by12))


def k1_case(torch, kd, bounds, pts, bn=None):
    """K1 at tile height ``bn`` (4096 where n allows, else 128): two
    launches bitwise, all four outputs bitwise the template entry
    (``seed_prologue_template``, K1's kernel before its redesign), norms
    bitwise ``bounds.point_norms``, the balls within tolerance of the plain
    twin (sums in another order); K1, the template entry and the twin
    timed; the bound; the route the source picks."""
    n, d = pts.shape
    bn = bn or (4096 if n >= 4096 else 128)
    out1 = kd.seed_prologue(pts, bn)
    out2 = kd.seed_prologue(pts, bn)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(out1, out2)),
          f"K1 d={d}: two launches differ")
    check(all(bits_equal(torch, a, b) for a, b in
              zip(out1, kd.seed_prologue_template(pts, bn))),
          f"K1 d={d}: not bitwise the template entry")
    check(torch.equal(out1[0], bounds.point_norms(pts)),
          f"K1 d={d}: norms are not bitwise bounds.point_norms")
    ref = kd.seed_prologue_torch(pts, bn)
    # centers are means and radii/center_d square roots of sums of d
    # squares, each summed in another order than the plain version's
    tol = 1e-5 * float(pts.abs().max())
    err = max(float((a - b).abs().max()) for a, b in zip(out1[1:], ref[1:]))
    check(err <= tol, f"K1 d={d}: centers/radii/center_d err {err} > {tol}")
    ms, plain = timed(torch, lambda: kd.seed_prologue(pts, bn),
                      lambda: kd.seed_prologue_torch(pts, bn))
    template_ms = gpu_ms(torch, lambda: kd.seed_prologue_template(pts, bn))
    ms_again = gpu_ms(torch, lambda: kd.seed_prologue(pts, bn))
    t = -(-n // bn)
    bms, by = bound_ms(4 * (n * d + 2 * n + t * (d + 1)),
                       n * (3 * d + 1) + t * d)
    return dict(n=n, d=d, block_n=bn, max_abs_err=err, tol=tol, ms=ms,
                ms_again=ms_again, template_ms=template_ms, plain_ms=plain,
                bound_ms=bms, bound_by=by,
                route=("lone", "wide")[kd.prologue_route(d, bn) == 0])


def k1_text(c: dict) -> str:
    return (f"K1 n={c['n']} d={c['d']} block_n={c['block_n']} ({c['route']} "
            f"route): bitwise the template entry, err {c['max_abs_err']:.3g} "
            f"(tol {c['tol']:.3g}); {c['ms']:.4f} ms (again "
            f"{c['ms_again']:.4f}; template entry {c['template_ms']:.4f} ms), "
            f"plain {c['plain_ms']:.4f} ms, bound {c['bound_ms']:.4f} ms "
            f"({c['bound_by']})")


def k5_case(torch, kd, bounds, ops, pts, cache, md_in, cents, mask, resident):
    """K5 on one carried state: ``mask`` is 'gate' (the seeding gate's own
    mask for these centroids), 'all', 'half' or 'none'."""
    n, d = pts.shape
    m = cents.shape[0]
    bn = ops.choose_block_n(n, d, 50)
    parts = kd.distance_min_update_torch(pts, cache.norms, cents[:1],
                                         md_in, block_n=bn)[1]
    tmax = bounds.tile_reduce_max(md_in, bn)
    act, dc, margin = bounds.seed_gate(cents, cache, tmax)
    t = act.shape[0]
    act = {"gate": act, "all": torch.ones_like(act),
           "half": torch.arange(t, device=pts.device) % 2 == 0,
           "none": torch.zeros_like(act)}[mask]
    args = (pts, cache.norms, cents, md_in, cache.center_d, dc, margin,
            parts, tmax, act)
    out1 = kd.distance_min_update_gated(*args, block_n=bn, resident=resident)
    out2 = kd.distance_min_update_gated(*args, block_n=bn, resident=resident)
    torch.cuda.synchronize()
    what = f"K5 d={d} m={m} resident={resident} mask={mask}"
    check(all(torch.equal(a, b) for a, b in zip(out1, out2)),
          f"{what}: two launches differ")
    # the template entry (K5's kernel before): every output bitwise
    same_bits(torch, f"{what} vs the template entry", out1,
              kd.distance_min_update_gated_template(*args, block_n=bn,
                                                    resident=resident))
    ref = kd.distance_min_update_gated_torch(*args, block_n=bn)
    tol = d2_tol(torch, cache.norms, cents)
    err = float((out1[0] - ref[0]).abs().max())
    check(err <= tol, f"{what}: min_d2 err {err} > {tol}")
    check(bool(((out1[1] - ref[1]).abs()
                <= partial_tol(tol, bn, ref[1])).all()),
          f"{what}: partials outside tolerance")
    check(float((out1[2] - ref[2]).abs().max()) <= tol,
          f"{what}: tile maxima outside tolerance")
    # the prune test is the same four roundings on the same inputs
    check(torch.equal(out1[3], ref[3]), f"{what}: pruned counts differ")
    skip = ~act
    rows = bounds.expand_mask(skip, bn, n)
    check(torch.equal(out1[0][rows], md_in[rows])
          and torch.equal(out1[1][skip], parts[skip])
          and torch.equal(out1[2][skip], tmax[skip])
          and not bool(out1[3][skip].any()),
          f"{what}: a skipped tile's outputs moved")
    if mask == "all":
        # every row K2 computes, but for the rows the bound prunes, which
        # keep md: in fp32 those are the same bits (all-active K5 is K2);
        # a bf16 K2 may lower a pruned row's D² by bf16 noise the bound
        # proves spurious
        k2 = kd.distance_min_update(pts, cache.norms, cents, md_in,
                                    block_n=bn, resident=resident)
        prune = bounds.seed_point_prune(
            md_in, cache.center_d, bounds.expand_mask(dc, bn, n),
            bounds.expand_mask(margin, bn, n))
        check(torch.equal(out1[0], torch.where(prune, md_in, k2[0]))
              and (pts.dtype != torch.float32
                   or (torch.equal(out1[0], k2[0])
                       and torch.equal(out1[1], k2[1]))),
              f"{what}: all-active K5 is not K2 but on its pruned rows")
    fp32_ms = widened(torch, what, lambda p, c: kd.distance_min_update_gated(
        p, *args[1:2], c, *args[3:], block_n=bn, resident=resident),
        pts, cents, out1)
    # the kernel and its template entry side by side (the entry's time
    # includes the carry copies its contract asks of the caller)
    ms = gpu_ms(torch, lambda: kd.distance_min_update_gated(
        *args, block_n=bn, resident=resident))
    template_ms = gpu_ms(torch, lambda: kd.distance_min_update_gated_template(
        *args, block_n=bn, resident=resident))
    ms2 = gpu_ms(torch, lambda: kd.distance_min_update_gated(
        *args, block_n=bn, resident=resident))
    # in place (the seeding loop's rounds after the first): a scratch carry,
    # whose later launches see the same prune (an updated row's D² is its
    # fresh value, which the bound cannot prune) and bitwise the same outputs
    carry = md_in.clone()
    inpl = kd.distance_min_update_gated(*args[:3], carry, *args[4:],
                                        block_n=bn, resident=resident,
                                        inplace=True)
    same_bits(torch, f"{what} in place", inpl, out1)
    inplace_ms = gpu_ms(torch, lambda: kd.distance_min_update_gated(
        *args[:3], carry, *args[4:], block_n=bn, resident=resident,
        inplace=True))
    same_bits(torch, f"{what} in place, repeated", (carry,), (out1[0],))
    del carry, inpl
    plain = gpu_ms(torch, lambda: kd.distance_min_update_gated_torch(
        *args, block_n=bn))
    rows_act = int(bounds.expand_mask(act, bn, n).sum())
    n_pruned = int(out1[3].sum())
    fresh = rows_act - n_pruned
    xb = pts.element_size()
    bms, by = round_bound_ms(torch, pts, xb * (fresh * d + m * d)
                             + 4 * (3 * rows_act + fresh + 7 * t),
                             fresh * m * 2 * d, fresh * m * 3 + rows_act * 6)
    return dict(n=n, d=d, m=m, resident=resident, mask=mask, block_n=bn,
                stream=stream_tag(torch, pts), active_tiles=int(act.sum()),
                tiles=t, pruned=n_pruned, max_abs_err=err, tol=tol, ms=ms,
                ms_again=ms2, inplace_ms=inplace_ms,
                template_ms=template_ms, plain_ms=plain,
                fp32_ms=fp32_ms, bound_ms=bms, bound_by=by)


def row_loop_beside_k2(torch, kd, bounds, pts, cache, cents, bn) -> dict:
    """K5's row loop on K2's work at a width where K2 keeps the template
    body (d < 8), both timed side by side: every tile active on an
    all-+inf carry, where the bound prunes no row, so K5's D² are K2's bit
    for bit (and in fp32 its partials). Why K2 and K7 take the row loop at
    d >= 8 only."""
    k2, k5 = kd.distance_min_update, kd.distance_min_update_gated
    inf = torch.full(pts.shape[:-1], torch.inf, device=pts.device)
    tmax = bounds.tile_reduce_max(inf, bn)
    _, dc, margin = bounds.seed_gate(cents, cache, tmax)
    args = (pts, cache.norms, cents, inf, cache.center_d, dc, margin,
            torch.zeros_like(tmax), tmax,
            torch.ones_like(tmax, dtype=torch.bool))
    got = k5(*args, block_n=bn)
    want = k2(pts, cache.norms, cents, inf, block_n=bn)
    what = (f"K5 {stream_tag(torch, pts)} d={pts.shape[-1]} "
            f"m={cents.shape[-2]} on K2's work")
    check(not bool(got[3].any()), f"{what}: a row was pruned")
    check(bits_equal(torch, got[0], want[0])
          and (pts.dtype != torch.float32
               or bits_equal(torch, got[1], want[1])),
          f"{what}: not bitwise K2")
    ms = gpu_ms(torch, lambda: k5(*args, block_n=bn))
    k2_ms = gpu_ms(torch, lambda: k2(pts, cache.norms, cents, inf,
                                     block_n=bn))
    ms2 = gpu_ms(torch, lambda: k5(*args, block_n=bn))
    print(f"{what}: bitwise; {ms:.4f} ms (again {ms2:.4f}), K2 "
          f"{k2_ms:.4f} ms")
    return dict(what=what, ms=ms, ms_again=ms2, k2_ms=k2_ms)


def k6_bound(torch, pts, k, rows_act, fresh, t, s_act, screened):
    """K6's bound: an active row reads x and its three carries and writes
    label, D² and lb, a fresh row also reads its norm; the tile and super
    outputs; the dots of the fresh rows (at TF32's or bf16's tensor-core
    rate on the screened route, whose exact recheck counts with the rest).
    Returns (bound, by, fp32-FMA bound)."""
    d = pts.shape[1]
    xb = pts.element_size()
    work = (xb * (rows_act * d + k * d)
            + 4 * (rows_act * 6 + fresh + k + 6 * t + s_act * k * (d + 1)),
            fresh * k * 2 * d, fresh * k * 3 + rows_act * (d + 4))
    bms, by = round_bound_ms(torch, pts, *work, tf32=screened)
    return bms, by, round_bound_ms(torch, pts, *work)[0]


def same_bits(torch, what, got, want) -> None:
    """Every output bitwise (fp32 as int32 patterns)."""
    check(len(got) == len(want)
          and all(bits_equal(torch, u, v) for u, v in zip(got, want)),
          f"{what}: not bitwise")


def k6_held(torch, la, bounds, what, args, bn, tps, out1) -> dict:
    """All eight outputs of K6's launch ``out1`` on ``args`` (K6's
    arguments: the carries and the mask among them) against the plain
    twin: the pruned counts, and the pruned rows' label, D² and lb (the
    carried label and D², lb = prev_lb − absorb: one fp32 subtraction on
    the same inputs), bitwise; labels outside near-ties; D² within the
    matmul tolerance; fresh rows' lb = √second and active tiles' gaps
    within 2·√tol (sqrt turns a D² error δ into at most √δ); active
    tiles' partials within ``partial_tol``; active supers' sums and counts
    over the kernel's own labels, pruned rows under their carried label
    included (``super_sums_ok``: counts exact); skipped tiles' and supers'
    outputs their carries, bitwise, and their pruned counts 0. Returns the
    label differences, the D² error and the tolerance."""
    pts, norms, cents, delta, thresh = args[:5]
    n = pts.shape[0]
    act = bounds.align_supers(args[13], tps)
    ref = la.lloyd_assign_gated_torch(*args[:13], act, block_n=bn, tps=tps)
    act_pt = bounds.expand_mask(act, bn, n)
    prune = bounds.assign_point_prune(args[6], args[7], args[8], delta,
                                      bounds.expand_mask(thresh, bn, n),
                                      act_pt)
    check(torch.equal(out1[7], ref[7]), f"{what}: pruned counts differ")
    check(all(torch.equal(o[prune], r[prune])
              for o, r in zip(out1[:3], ref[:3])),
          f"{what}: pruned rows' label, D² or lb differ")
    tol = d2_tol(torch, norms, cents)
    n_diff, bad = label_diffs(torch, la.tile_d2(pts, cents, norms), out1[0],
                              ref[0], tol)
    check(bad == 0, f"{what}: {bad} labels differ beyond near-ties")
    err = float((out1[1] - ref[1]).abs().max())
    check(err <= tol, f"{what}: min_d2 err {err} > {tol}")
    fin = torch.isfinite(ref[2])
    fresh_pt = act_pt & ~prune & fin
    check(torch.equal(torch.isfinite(out1[2]), fin)
          and bool(((out1[2] - ref[2])[fresh_pt].abs()
                    <= 2 * math.sqrt(tol)).all()),
          f"{what}: lower bounds outside tolerance")
    check(bool(((out1[3] - ref[3])[act].abs()
                <= partial_tol(tol, bn, ref[3])[act]).all()),
          f"{what}: partials outside tolerance")
    gfin = torch.isfinite(ref[4])
    check(torch.equal(torch.isfinite(out1[4]), gfin)
          and bool(((out1[4] - ref[4])[gfin & act].abs()
                    <= 2 * math.sqrt(tol)).all()),
          f"{what}: gaps outside tolerance")
    sup_act = bounds.super_any(act, tps)
    check(super_sums_ok(torch, pts, out1[0], out1[5], out1[6], bn * tps,
                        sup_act),
          f"{what}: super sums or counts outside tolerance")
    skip, sup_skip = ~act, ~sup_act
    rows = bounds.expand_mask(skip, bn, n)
    kept = all(torch.equal(o[sel], c[sel]) for o, c, sel in (
        (out1[0], args[6], rows), (out1[1], args[7], rows),
        (out1[2], args[8], rows), (out1[3], args[9], skip),
        (out1[4], args[10], skip), (out1[5], args[11], sup_skip),
        (out1[6], args[12], sup_skip)))
    check(kept and not bool(out1[7][skip].any()),
          f"{what}: a skipped tile's or super's outputs moved")
    return dict(label_diffs=n_diff, max_abs_err=err, tol=tol)


def k6_case(torch, la, bounds, ops, pts, cache, k, gen,
            masks=("all", "half", "gate")):
    """K6 from a carried state: one all-active launch with no carried bound
    (held bitwise to K3 and to the template entry) gives the state; two
    centroids then move a little (none at k = 1), so the rows of unmoved
    clusters prune. ``masks`` of every tile ('all'), half the supers
    ('half'), the movement gate's ('gate'); each launch bitwise the
    template entry (all eight outputs), whose time is measured beside
    K6's, where the template holds k (``ops.template_max_k``; past it
    ``template_ms`` is None)."""
    n, d = pts.shape
    bn = ops.choose_block_n(n, d, k)
    has_tmpl = k <= ops.template_max_k(d, bn, gated=True)
    t = -(-n // bn)
    tps = bounds.tiles_per_super(t)
    s = -(-t // tps)
    dev = pts.device
    # the centroid carry is fp32, the kernel gets it in the stream's dtype
    c0 = (pts[torch.randint(n, (k,), generator=gen, device=dev)].float()
          + 0.01).contiguous()
    c0k = c0.to(pts.dtype)
    all_on = torch.ones(t, dtype=torch.bool, device=dev)
    zero_t = torch.zeros(t, device=dev)
    first = la.lloyd_assign_gated(
        pts, cache.norms, c0k, torch.zeros(k, device=dev), zero_t, zero_t,
        torch.zeros(n, dtype=torch.int32, device=dev),
        torch.zeros(n, device=dev), torch.full((n,), -torch.inf, device=dev),
        zero_t, zero_t, torch.zeros((s, k, d), device=dev),
        torch.zeros((s, k), device=dev), all_on, block_n=bn, tps=tps)
    k3 = la.lloyd_assign_tiled(pts, cache.norms, c0k, block_n=bn, tps=tps)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(
        (first[0], first[1], first[3], first[4], first[5], first[6]), k3))
        and not bool(first[7].any()),
        f"K6 d={d} k={k}: all-active K6 without a bound is not bitwise K3")
    if has_tmpl:
        same_bits(torch, f"K6 d={d} k={k} all-active vs the template entry",
                  first, la.lloyd_assign_gated_template(
                      pts, cache.norms, c0k, torch.zeros(k, device=dev),
                      zero_t, zero_t,
                      torch.zeros(n, dtype=torch.int32, device=dev),
                      torch.zeros(n, device=dev),
                      torch.full((n,), -torch.inf, device=dev), zero_t,
                      zero_t, torch.zeros((s, k, d), device=dev),
                      torch.zeros((s, k), device=dev), all_on, block_n=bn,
                      tps=tps))
    scr = la.screened(d, pts.dtype == torch.bfloat16)
    c1 = c0.clone()
    if k > 1:
        c1[[0, k - 1]] += 0.002
    st = bounds.BoundState(first[3], tile_gap=first[4], tile_sums=first[5],
                           tile_counts=first[6], assignment=first[0],
                           min_d2=first[1], point_lb=first[2],
                           lb_debt=zero_t)
    delta = bounds.centroid_movement(c1, c0)
    c1 = c1.to(pts.dtype)
    thresh, absorb = bounds.assign_point_scalars(delta, c1, st, cache)
    made = {"all": lambda: all_on,
            "half": lambda: (torch.arange(t, device=dev) // tps) % 2 == 0,
            "gate": lambda: bounds.expand_active_supers(
                bounds.assign_active_tiles(delta, c1, st, cache, tps=tps),
                tps)}
    res = []
    for name in masks:
        act = made[name]()
        what = f"K6 d={d} k={k} mask={name}"
        args = (pts, cache.norms, c1, delta, thresh, absorb, st.assignment,
                st.min_d2, st.point_lb, st.partials, st.tile_gap,
                st.tile_sums, st.tile_counts, act)
        out1 = la.lloyd_assign_gated(*args, block_n=bn, tps=tps)
        stats = screen_record(la, "lloyd_assign_gated", pts, torch)
        out2 = la.lloyd_assign_gated(*args, block_n=bn, tps=tps)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(out1, out2)),
              f"{what}: two launches differ")
        if has_tmpl:
            same_bits(torch, f"{what} vs the template entry", out1,
                      la.lloyd_assign_gated_template(*args, block_n=bn,
                                                     tps=tps))
        held = k6_held(torch, la, bounds, what, args, bn, tps, out1)
        if name != "half":
            check(int(out1[7].sum()) > 0, f"{what}: the prune never fired")
        act_pt = bounds.expand_mask(act, bn, n)
        sup_act = bounds.super_any(act, tps)
        fp32_ms = widened(torch, what, lambda p, c, args=args: (
            la.lloyd_assign_gated(p, args[1], c, *args[3:], block_n=bn,
                                  tps=tps)), pts, c1, out1)
        ms, plain = timed(
            torch, lambda: la.lloyd_assign_gated(*args, block_n=bn, tps=tps),
            lambda: la.lloyd_assign_gated_torch(*args, block_n=bn, tps=tps))
        tmpl_ms = gpu_ms(torch, lambda: la.lloyd_assign_gated_template(
            *args, block_n=bn, tps=tps), reps=5) if has_tmpl else None
        rows_act = int(act_pt.sum())
        n_pruned = int(out1[7].sum())
        bms, by, fma_ms = k6_bound(torch, pts, k, rows_act,
                                   rows_act - n_pruned, t,
                                   int(sup_act.sum()), scr)
        res.append(dict(n=n, d=d, k=k, mask=name, block_n=bn, tps=tps,
                        stream=stream_tag(torch, pts),
                        route="screened" if scr else "split",
                        active_tiles=int(act.sum()), tiles=t,
                        pruned=n_pruned, label_diffs=held["label_diffs"],
                        max_abs_err=held["max_abs_err"], tol=held["tol"],
                        ms=ms, plain_ms=plain,
                        fp32_ms=fp32_ms, template_ms=tmpl_ms, bound_ms=bms,
                        bound_by=by, fma_bound_ms=fma_ms, **stats))
    return res


def scan_determinism(torch, sampling, w, reps: int) -> dict:
    """How many distinct bit patterns ``reps`` runs of torch.cumsum and of
    the samplers' fixed-order prefix_sum give on one tensor, and the host
    time of one synchronised call of each (median of ``reps``, in µs)."""
    out = {}
    for name, fn in (("torch.cumsum", lambda: torch.cumsum(w, 0)),
                     ("prefix_sum", lambda: sampling.prefix_sum(w))):
        runs, times = [], []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs.append(fn())
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e6)
        distinct = []
        for r in runs:
            if not any(torch.equal(r, q) for q in distinct):
                distinct.append(r)
        out[name] = len(distinct)
        out[f"{name} us"] = statistics.median(times)
    return out


def profile_call(torch, fn, cpu: bool = True) -> dict:
    """Device time by kernel over one call of ``fn`` and the device's idle
    share of the call's wall time, from torch.profiler (whose own host-side
    cost lengthens the wall time, so the idle share is an upper bound).
    ``cpu=False`` records the device's activity only: a call of tens of
    thousands of operations is then read back in seconds, not minutes."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU] * cpu
                 + [ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels[evt.key] = (evt.self_device_time_total / 1e3, evt.count)
    busy = sum(ms for ms, _ in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    return dict(wall_ms=wall_ms, busy_ms=busy, idle_share=1 - busy / wall_ms,
                kernels={name: {"ms": ms, "count": c}
                         for name, (ms, c) in top})


def device_launches(torch, fn, reps: int = 10, sessions: int = 8) -> dict:
    """Device kernels a call of ``fn`` launches, by kernel name (the
    function's, without namespace or arguments), per call: the most that
    any of ``sessions`` torch.profiler sessions records, each over ``reps``
    calls after a warm-up step of ``reps`` calls whose records it drops.
    The profiler loses records, at a session's start and at times within
    one (ROADMAP hazards 9 and 17), but makes none up, so each session's
    count is a lower bound."""
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    out = {}
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        seen = {}
        for evt in prof.key_averages():
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                key = re.sub(r"^void\s+", "", evt.key.replace(
                    "(anonymous namespace)::", ""))
                name = re.match(r"[\w:]*", key).group(0).split("::")[-1]
                name = name or evt.key
                seen[name] = seen.get(name, 0) + evt.count / reps
        for name, n in seen.items():
            out[name] = max(out.get(name, 0), n)
    return out


def print_profile(name: str, p: dict) -> None:
    top = ", ".join(f"{kname[:48]} {v['ms']:.3f} ms x{v['count']}"
                    for kname, v in list(p["kernels"].items())[:5])
    print(f"profile {name}: wall {p['wall_ms']:.2f} ms, device busy "
          f"{p['busy_ms']:.2f} ms, idle share {p['idle_share']:.3f}; {top}")


def kmeans_run(torch, ops, eng, pts, k, sampler, draws, max_iters=25,
               **kw):
    """One counted kmeans: counters zeroed just before, read just after."""
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.kmeans(pts, k, draws=draws, sampler=sampler,
                     max_iters=max_iters, **kw)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, dict(ops.LAUNCHES)


def seed_run(torch, ops, eng, pts, k, draws, **kw):
    """One counted seeding: counters zeroed just before, read just after."""
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.seed(pts, k, draws=draws, **kw)
    torch.cuda.synchronize()
    return res, (time.perf_counter() - t0) * 1e3, dict(ops.LAUNCHES)


def median_seed_ms(torch, eng, pts, k, draws, reps=3, **kw) -> float:
    """Median host-clock ms of ``reps`` synchronised seedings."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.seed(pts, k, draws=draws, **kw)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def refreshes(accepts, k: int, p: int) -> int:
    """Round-kernel launches a rejection seeding makes: the schedule's
    (every p appended centroids, the first at round 1), one per round
    whose attempts all rejected (the count restarts), and the settle."""
    count, r = p - 1, 0
    for m in range(1, k):
        count += 1
        if count >= p:
            r, count = r + 1, 0
        if not accepts[m]:
            r, count = r + 1, 0
    return r + 1


def live_rounds(accepts, k: int, p: int) -> int:
    """Rounds of a rejection seeding that start with a live pending
    centroid (the count after the round's append and any refresh is not
    0): a hier seeding's tile envelopes, K12's launches."""
    count, live = p - 1, 0
    for m in range(1, k):
        count += 1
        if count >= p:
            count = 0
        live += count > 0
        if not accepts[m]:
            count = 0
    return live


def same_seeds(torch, a, b) -> bool:
    return (torch.equal(a.indices, b.indices)
            and torch.equal(a.centroids, b.centroids)
            and torch.equal(a.min_d2, b.min_d2))


def phase_ms(torch, eng, pts, k, sampler, draws, max_iters=25):
    """Seeding ms and Lloyd ms per iteration, the two phases apart."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seeds = eng.seed(pts, k, draws=draws, sampler=sampler)
    torch.cuda.synchronize()
    seed_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    fit = eng.fit(pts, seeds.centroids, max_iters=max_iters)
    torch.cuda.synchronize()
    lloyd_ms = (time.perf_counter() - t0) * 1e3 / max(fit.n_iters, 1)
    return seeds, fit, seed_ms, lloyd_ms


def same_fit(torch, a, b) -> bool:
    """Bitwise equal fits; n_iters an int, or a tensor when batched."""
    return (torch.equal(a.centroids, b.centroids)
            and torch.equal(a.assignment, b.assignment)
            and torch.equal(a.inertia, b.inertia)
            and torch.equal(torch.as_tensor(a.n_iters).long().cpu(),
                            torch.as_tensor(b.n_iters).long().cpu()))


def counted_as(what, got, want_nonzero) -> None:
    """Every launch counter is 0 but those named, which hold their counts."""
    want = {name: 0 for name in got}
    want.update(want_nonzero)
    check(got == want, f"{what}: launches "
          f"{ {n: c for n, c in got.items() if c} }, want {want_nonzero}")


def bf16_main_path(torch, ops, ClusterEngine, Draws, pts, full, dev,
                   launches) -> list:
    """The main path under ``precision="bf16"`` at ``full``: ``kmeans`` for
    cdf and tiled, gated and ungated, counted (gated: K1 once, bf16 K5 k
    times, bf16 K6 n_iters times; ungated: bf16 K2 k, bf16 K3 n_iters; no
    fp32 round), each bitwise a second run and a bf16 seed then fit from
    the same draws; the Lloyd inertia within 15% of an fp32 fit from the
    same seeds (the reference's pin, ``tests/test_engine.py:527-545``);
    gated against ungated, the seeds and labels that differ are printed
    (not a gate: under bf16 the gate suppresses bf16-noise updates that
    its bound proves spurious, as the reference's does)."""
    k = full.k
    eng32 = ClusterEngine(device="cuda")
    runs = []
    for sampler in ("cdf", "tiled"):
        draws = Draws.sample(pts.shape[0], k,
                             generator=torch.Generator().manual_seed(0),
                             device=dev)
        out = {}
        for tag, on in (("gated", True), ("ungated", False)):
            eng = ClusterEngine(device="cuda", precision="bf16", bounds=on)
            what = f"bf16 kmeans[{sampler}, {tag}]"
            res, total_s, got = kmeans_run(torch, ops, eng, pts, k, sampler,
                                           draws, max_iters=full.max_iters)
            for name in launches:
                launches[name] += got[name]
            counted_as(what, got, dict(
                seed_prologue=1, distance_min_update_gated_bf16=k,
                lloyd_assign_gated_bf16=res.n_iters) if on else dict(
                distance_min_update_bf16=k,
                lloyd_assign_tiled_bf16=res.n_iters))
            check(tuple(res.centroids.shape) == (k, full.dim)
                  and res.centroids.dtype == torch.float32
                  and bool(torch.isfinite(res.centroids).all())
                  and bool(torch.isfinite(res.inertia))
                  and int(res.assignment.min()) >= 0
                  and int(res.assignment.max()) < k,
                  f"{what}: output malformed")
            again = kmeans_run(torch, ops, eng, pts, k, sampler, draws,
                               max_iters=full.max_iters)[0]
            check(same_fit(torch, again, res), f"{what}: two runs differ")
            # kmeans seeds at the fit's tile geometry: an engine whose
            # backend budgets for k centroids seeds the same way
            eng_k = ClusterEngine(eng.backend.__class__(tile_m=k),
                                  device="cuda", precision="bf16", bounds=on)
            seeds = eng_k.seed(pts, k, draws=draws, sampler=sampler)
            fit = eng_k.fit(pts, seeds.centroids, max_iters=full.max_iters)
            check(same_fit(torch, fit, res),
                  f"{what}: not its seeding then its fit")
            fit32 = eng32.fit(pts, seeds.centroids, max_iters=full.max_iters)
            rel = abs(float(res.inertia) - float(fit32.inertia)) \
                / float(fit32.inertia)
            check(rel < 0.15, f"{what}: inertia {float(res.inertia)} is "
                  f"{rel:.3g} off the fp32 fit's {float(fit32.inertia)}")
            out[tag] = (res, seeds)
            runs.append(dict(sampler=sampler, gated=on, n_iters=res.n_iters,
                             inertia=float(res.inertia),
                             fp32_fit_inertia=float(fit32.inertia),
                             inertia_rel_diff=rel, kmeans_s=total_s,
                             launches={n: c for n, c in got.items() if c},
                             repeat_bitwise=True))
            print(f"{what} at {full.name}: {total_s:.3f} s, n_iters "
                  f"{res.n_iters}, inertia {float(res.inertia):.6g} against "
                  f"the fp32 fit's {float(fit32.inertia):.6g} from the same "
                  f"seeds (rel {rel:.3g}); two runs bitwise; launches "
                  f"{runs[-1]['launches']}")
        (g, gs), (u, us) = out["gated"], out["ungated"]
        seed_diff = int((gs.indices != us.indices).sum())
        label_diff = int((g.assignment != u.assignment).sum())
        runs[-1].update(gated_vs_ungated_seeds=seed_diff,
                        gated_vs_ungated_labels=label_diff)
        print(f"bf16 kmeans[{sampler}]: gated against ungated, {seed_diff} "
              f"of {k} seeds and {label_diff} of {pts.shape[0]} labels "
              "differ (not a gate)")
    return runs


def launch_diff(got: dict, base: dict) -> dict:
    """The launches ``got`` made beyond ``base``, by kernel."""
    return {n: c - base.get(n, 0) for n, c in got.items()
            if c != base.get(n, 0)}


def carry_checks(torch, kd, bounds, sampling, engine, eng, pts, seeds,
                 k) -> dict:
    """K5 and K6 on a NaN carry, at ``pts``' shape: a skipped tile's
    poisoned partial is copied through (so it reaches the round's total or
    the inertia), and K5 keeps a NaN D² row of an active tile NaN (its
    nan_min: an fminf would replace it with the new distance, a wrong D²
    no check could see)."""
    be = eng.backend
    n, d = pts.shape
    out = {}
    # K5: tile 0 skipped with a NaN carried partial; then every tile active
    # with NaN D² rows
    bn = be.seed_tile(n, d)
    cache = be.prologue(pts)
    md = kd.distance_min_update_torch(pts, cache.norms, seeds[:4].contiguous(),
                                      torch.full((n,), torch.inf,
                                                 device=pts.device),
                                      block_n=bn)[0]
    c = seeds[4:5].contiguous()
    tmax = bounds.tile_reduce_max(md, bn)
    _, dc, margin = bounds.seed_gate(c, cache, tmax)
    parts = sampling.tile_partials(md, bn)
    parts[0] = torch.nan
    active = torch.ones_like(tmax, dtype=torch.bool)
    active[0] = False
    got = kd.distance_min_update_gated(pts, cache.norms, c, md,
                                       cache.center_d, dc, margin, parts,
                                       tmax, active, block_n=bn)
    out["K5 skipped tile keeps its NaN partial"] = bool(
        torch.isnan(got[1][0]) and torch.isnan(got[1].sum()))
    md_nan = md.clone()
    md_nan[:64] = torch.nan
    got = kd.distance_min_update_gated(pts, cache.norms, c, md_nan,
                                       cache.center_d, dc, margin,
                                       sampling.tile_partials(md, bn), tmax,
                                       torch.ones_like(active), block_n=bn)
    out["K5 active tile keeps its NaN rows"] = bool(
        torch.isnan(got[0][:64]).all() and not torch.isnan(got[0][64:]).any()
        and torch.isnan(got[1][0]))
    # K6: three gated iterations, then the first super of tiles skipped
    # with NaN carried partials
    cache = be.prologue(pts, m=k)
    make_init, step, _, _ = engine.fit_points(pts, seeds, be, 25, -1.0,
                                              cache=cache, parts=True)
    carry = make_init()
    for _ in range(3):
        carry = step(carry)
    st = carry.state
    tile = be.seed_tile(n, d, k)
    tps = be.tiles_per_super(st.partials.shape[0])
    parts = st.partials.clone()
    parts[:tps] = torch.nan
    delta = bounds.centroid_movement(carry.centroids, carry.prev_centroids)
    thresh, absorb = bounds.assign_point_scalars(delta, carry.centroids, st,
                                                 cache)
    active = torch.ones_like(parts, dtype=torch.bool)
    active[:tps] = False
    got = be._assign_gated(pts, cache.norms, carry.centroids, delta, thresh,
                           absorb, st._replace(partials=parts), active, tile,
                           tps)
    out["K6 skipped super keeps its NaN partials"] = bool(
        torch.isnan(got[3][:tps]).all()
        and not torch.isnan(got[3][tps:]).any()
        and torch.isnan(sampling.fixed_sum(got[3])))
    for what, ok in out.items():
        check(ok, f"carry check failed: {what}")
    return out


def timed_manager(torch, directory):
    """A ``CheckpointManager`` (blocking writes) whose saves are timed: for
    each, in ``.saves``, the chunk it follows (host ms, and ms by CUDA
    events from the end of the last save, or of the manager's making, to
    the start of this one), the host snapshot ms, the file write ms and the
    MB written."""
    from repro_torch.checkpoint import CheckpointManager

    class Timed(CheckpointManager):
        def mark(self):
            self.t_mark = time.perf_counter()
            self.ev_mark = torch.cuda.Event(enable_timing=True)
            self.ev_mark.record()

        def save(self, step, state, *, blocking=False, meta=None):
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            t0 = time.perf_counter()
            named, manifest = self._snapshot(step, state, meta)
            t1 = time.perf_counter()
            self._commit(step, named, manifest)
            t2 = time.perf_counter()
            self.saves.append(dict(
                step=step, chunk_host_ms=(t0 - self.t_mark) * 1e3,
                chunk_event_ms=self.ev_mark.elapsed_time(end),
                snapshot_ms=(t1 - t0) * 1e3, write_ms=(t2 - t1) * 1e3,
                mb=sum(t.numel() * t.element_size()
                       for t in named.values()) / 1e6))
            self.mark()

    mgr = Timed(directory, async_save=False)
    mgr.saves = []
    mgr.mark()
    return mgr


def robustness_phase(torch, ops, kd, bounds, sampling, ClusterEngine, Draws,
                     pts, full, dev, launches) -> dict:
    """Phase 3 (robustness) at ``full``, label-sorted (the gate skips), on
    the ``cuda`` backend. The fault matrix: seeding ``nan_tile`` at round
    2 (or the first round after it whose gate computes tile 0, whose rows
    it poisons), ``nan_state`` at the first round whose gate skips tile 0
    (its carried partial, poisoned, reaches the total: flagged) and at the
    first that skips tiles but not tile 0 (recomputed: not flagged), the
    gated fit's ``zero_counts`` and ``nan_state`` at iterations 2 and 4,
    rejection (hier) seeding's ``neg_envelope`` and ``stale_super`` at
    round 3: each bitwise the clean run of the same call (seeds, min_d2,
    centroids, assignment, inertia, n_iters, the rejection counters) with
    ``recovered`` the fused twin's on the same card, and each heal's extra
    launches and host ms printed. Also the reference's blind spot,
    ``nan_tile`` at a round whose gate skips tile 0: healed a round late,
    the seeds before it the clean run's, flagged as the fused twin flags
    it. Then K5 and K6 on NaN carries (:func:`carry_checks`). Checkpointed:
    gated ``seed`` (cdf and tiled, ``checkpoint_every=10``) and gated
    ``fit`` (25 iterations, ``checkpoint_every=5``) bitwise the plain
    calls, again after the newest two steps are deleted; a resume with
    another k or precision raises ``CheckpointError``; every save timed
    (:func:`timed_manager`). The pipeline: ``fit_minibatch`` over a
    ``flaky_read_fn`` source bitwise the clean run, and ``kill_prefetch``
    surfacing as a ``PipelineError`` with its step. Every counted launch
    goes into ``launches``."""
    import shutil
    import tempfile
    from repro_torch.core import CheckpointError, PipelineError
    from repro_torch.core import engine
    from repro_torch.data import DataPipeline
    from repro_torch.testing import FaultSpec, flaky_read_fn, kill_prefetch
    k, n = full.k, pts.shape[0]
    eng = ClusterEngine(device=dev)
    fused = ClusterEngine("fused", device=dev)
    out = {"faults": [], "saves": {}}

    def run(e, fn):
        res, s, got = counted(torch, ops, fn)
        if e is eng:
            for name in launches:
                launches[name] += got[name]
        return res, s * 1e3, got

    def case(what, loop, call, kind, rd, fields, clean, flags):
        # the fault's run bitwise the clean run, flagged at ``flags`` and
        # where the fused twin flags it; ``fields`` None: the reference's
        # blind spot (a nan_tile in a tile the gate skips: the guard sees
        # it in a later round, after the sampler read the NaN rows), where
        # only the seeds drawn before round ``rd`` are the clean run's, and
        # ``flags`` None, one flag after round ``rd``'s slot
        hurt, ms, got = run(eng, lambda: call(eng, FaultSpec(kind, rd)))
        twin = call(fused, FaultSpec(kind, rd))
        if fields is None:
            check(torch.equal(hurt.indices[:rd], clean[0].indices[:rd]),
                  f"{what}: the seeds before round {rd} differ")
        else:
            check(all(bits_equal(torch, getattr(hurt, f),
                                 getattr(clean[0], f))
                      if isinstance(getattr(hurt, f), torch.Tensor)
                      else getattr(hurt, f) == getattr(clean[0], f)
                      for f in fields), f"{what}: not bitwise the clean run")
        check(torch.equal(hurt.recovered, twin.recovered),
              f"{what}: recovered {hurt.recovered.tolist()} != the fused "
              f"twin's {twin.recovered.tolist()}")
        slots = torch.nonzero(hurt.recovered).flatten().tolist()
        check(slots == flags if flags is not None
              else len(slots) == 1 and slots[0] >= rd,
              f"{what}: recovered at {slots}, not {flags or 'one later'}")
        c = dict(loop=loop, kind=kind, round=rd, recovered_slots=slots,
                 bitwise_clean=fields is not None,
                 extra_launches=launch_diff(got, clean[2]),
                 extra_host_ms=ms - clean[1])
        out["faults"].append(c)
        print(f"fault {what}: "
              + ("bitwise the clean run" if fields is not None else
                 f"the seeds before round {rd} the clean run's, "
                 f"{int((hurt.indices != clean[0].indices).sum())} later "
                 "ones not (the reference's blind spot)")
              + f", recovered at slots {slots} (the fused twin's), heal's "
              f"extra launches {c['extra_launches']}, extra host "
              f"{c['extra_host_ms']:.2f} ms")
        return c

    draws = Draws.sample(n, k, generator=torch.Generator().manual_seed(0),
                         device=dev, max_attempts=8)
    seed_fields = ("indices", "centroids", "min_d2")

    def seed_call(e, fault=None):
        return e.seed(pts, k, draws=draws, _fault=fault)

    seed_call(eng)          # warm: the clean runs' host ms are the base
    clean = run(eng, lambda: seed_call(eng))
    check(int(clean[0].recovered.sum()) == 0, "clean seeding healed")
    # the rounds whose gate skips tile 0 (the rows and the partial the
    # seeding faults poison), from the loop's own parts and gate on the
    # clean run's carries
    cache = eng.backend.prologue(pts)
    make_init, body, _ = engine.seed_points(draws, pts, k, eng.backend,
                                            cache=cache, parts=True)
    carry, tile0_skipped = make_init(draws), []
    while carry.m < k:
        c_m = carry.centroids[carry.m - 1:carry.m]
        if not bool(bounds.seed_gate(c_m, cache, carry.state.tile_max)[0][0]):
            tile0_skipped.append(carry.m)
        carry = body(carry)
    del cache, carry
    skipped = clean[0].skipped.tolist()
    tile0_active = [m for m in range(2, k) if m not in tile0_skipped]
    others_only = [m for m in tile0_active if skipped[m - 1]]
    check(tile0_skipped and others_only, f"no round to poison: tile 0 "
          f"skipped in {tile0_skipped}, other tiles only in {others_only}")
    out["tile0_skipped_rounds"] = tile0_skipped
    print(f"the gate skips tile 0 in rounds {tile0_skipped} of the clean "
          f"seeding")
    # nan_tile at round 2, or at the first round after it that computes
    # tile 0 (the guard sees a NaN row only where its tile is computed)
    rd = tile0_active[0]
    case(f"seed[cdf] nan_tile round {rd}", "seed", seed_call, "nan_tile", rd,
         seed_fields, clean, [rd - 1])
    rd = tile0_skipped[0]
    case(f"seed[cdf] nan_tile round {rd} (tile 0 skipped)", "seed",
         seed_call, "nan_tile", rd, None, clean, None)
    for rd, flags in ((tile0_skipped[0], [tile0_skipped[0] - 1]),
                      (others_only[0], [])):
        case(f"seed[cdf] nan_state round {rd} ({skipped[rd - 1]} tiles "
             f"skipped, tile 0 {'not ' * (not flags)}among them)", "seed",
             seed_call, "nan_state", rd, seed_fields, clean, flags)

    seeds = clean[0].centroids
    fit_fields = ("centroids", "assignment", "inertia", "n_iters")

    def fit_call(e, fault=None):
        return e.fit(pts, seeds, max_iters=full.max_iters, _fault=fault)

    fit_call(eng)
    fclean = run(eng, lambda: fit_call(eng))
    check(int(fclean[0].recovered.sum()) == 0, "clean fit healed")
    for kind in ("zero_counts", "nan_state"):
        for rd in (2, 4):
            case(f"fit {kind} iteration {rd}", "fit", fit_call, kind, rd,
                 fit_fields, fclean, [rd])
    rej_fields = seed_fields + ("proposals", "accepts", "tightened",
                                "supers")

    def rej_call(e, fault=None):
        return e.seed(pts, k, draws=draws, sampler="rejection",
                      proposal="hier", _fault=fault)

    rej_call(eng)
    rclean = run(eng, lambda: rej_call(eng))
    for kind in ("neg_envelope", "stale_super"):
        case(f"rejection[hier] {kind} round 3", "rejection", rej_call, kind,
             3, rej_fields, rclean, [3])
    out["carry_checks"] = carry_checks(torch, kd, bounds, sampling, engine,
                                       eng, pts, seeds, k)
    print(f"carry checks: {out['carry_checks']}")

    # checkpointed runs
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    try:
        def drop_newest(mgr):
            for st in mgr.all_steps()[-2:]:
                shutil.rmtree(mgr.dir / f"step_{st:08d}")

        def checkpointed(what, plain, call, fields, every):
            for attempt in ("run", "resume"):
                mgr = timed_manager(torch, tmp / what)
                res, ms, _ = run(eng, lambda: call(mgr, every))
                check(all(bits_equal(torch, getattr(res, f),
                                     getattr(plain, f))
                          if isinstance(getattr(res, f), torch.Tensor)
                          else getattr(res, f) == getattr(plain, f)
                          for f in fields),
                      f"checkpointed {what} ({attempt}): not bitwise the "
                      "plain call")
                out["saves"][f"{what} {attempt}"] = dict(host_ms=ms,
                                                          saves=mgr.saves)
                for sv in mgr.saves:
                    print(f"checkpointed {what} ({attempt}) save at step "
                          f"{sv['step']}: {sv['mb']:.2f} MB, snapshot "
                          f"{sv['snapshot_ms']:.2f} ms, write "
                          f"{sv['write_ms']:.2f} ms; the chunk before it "
                          f"{sv['chunk_host_ms']:.2f} ms host, "
                          f"{sv['chunk_event_ms']:.2f} ms by events")
                print(f"checkpointed {what} ({attempt}): {ms:.1f} ms, "
                      f"bitwise the plain call")
                if attempt == "run":
                    drop_newest(mgr)

        for sampler in ("cdf", "tiled"):
            plain = eng.seed(pts, k, draws=draws, sampler=sampler)
            checkpointed(f"seed[{sampler}]", plain, lambda mgr, every: (
                eng.seed(pts, k, draws=draws, sampler=sampler,
                         checkpoint_dir=mgr, checkpoint_every=every)),
                seed_fields + ("skipped", "pruned", "recovered"), 10)
        plain = eng.fit(pts, seeds, max_iters=full.max_iters, tol=-1.0)
        checkpointed("fit", plain, lambda mgr, every: eng.fit(
            pts, seeds, max_iters=full.max_iters, tol=-1.0,
            checkpoint_dir=mgr, checkpoint_every=every),
            fit_fields + ("skipped", "pruned", "recovered"), 5)
        bf16 = ClusterEngine(device=dev, precision="bf16")
        refused = []
        for what, fn in (
                ("seed, another k", lambda: eng.seed(
                    pts, k - 1, draws=draws, checkpoint_dir=tmp / "seed[cdf]",
                    checkpoint_every=10)),
                ("seed, another precision", lambda: bf16.seed(
                    pts, k, draws=draws, checkpoint_dir=tmp / "seed[cdf]",
                    checkpoint_every=10)),
                ("fit, another k", lambda: eng.fit(
                    pts, seeds[:-1], max_iters=full.max_iters, tol=-1.0,
                    checkpoint_dir=tmp / "fit", checkpoint_every=5)),
                ("fit, another precision", lambda: bf16.fit(
                    pts, seeds, max_iters=full.max_iters, tol=-1.0,
                    checkpoint_dir=tmp / "fit", checkpoint_every=5))):
            try:
                fn()
            except CheckpointError:
                refused.append(what)
            else:
                check(False, f"checkpointed {what}: resumed, not refused")
        out["refused_resumes"] = refused
        print(f"refused with CheckpointError: {', '.join(refused)}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # the pipeline
    rows = 262_144
    host = pts.cpu().numpy()

    def read(i):
        return host[i * rows:(i + 1) * rows]

    n_batches = -(-n // rows)
    mclean = run(eng, lambda: eng.fit_minibatch(seeds, read,
                                                n_batches=n_batches))
    fails = {1: 2, n_batches - 1: 1}
    mflaky = run(eng, lambda: eng.fit_minibatch(
        seeds, flaky_read_fn(read, fail_steps=fails), n_batches=n_batches))
    check(same_fit(torch, mflaky[0], mclean[0])
          and set(fails.values()) == {0},
          "fit_minibatch over a flaky source: not the clean run")
    pipe = DataPipeline(read, prefetch=1, device=dev)
    it = iter(pipe)
    next(it)
    kill_prefetch(pipe)
    step = None
    try:
        for _ in range(8):
            next(it)
    except PipelineError as e:
        step = e.step
    finally:
        pipe.stop()
    check(step is not None, "kill_prefetch: no PipelineError with a step")
    out["pipeline"] = dict(flaky_bitwise=True, retried_reads=3,
                           flaky_ms=mflaky[1], clean_ms=mclean[1],
                           killed_at_step=step)
    print(f"pipeline: fit_minibatch over a flaky source ({mflaky[1]:.1f} ms, "
          f"3 retried reads) bitwise the clean run ({mclean[1]:.1f} ms); "
          f"kill_prefetch raised PipelineError at step {step}")
    return out


def bf16_entry_points(torch, ops, bounds, ClusterEngine, Draws, paper,
                      paper_np, wts, kvq_pts, full, kvq, dev, launches,
                      batch_rows=262_144) -> dict:
    """The other entry points under ``precision="bf16"``, each counted and
    each run twice, bitwise: the weighted ``kmeans`` at ``full`` (cdf; K1
    once, bf16 K2 k times, bf16 K4 n_iters times), ``fit_minibatch`` over
    ``full`` from host memory (bf16 K4 once per batch), ``kmeans_batched``
    at ``kvq`` gated (the batched K1 twice, bf16 K8 k times, bf16 K10b per
    iteration of the slowest problem) and ungated (bf16 K7, bf16 K10a), and
    K9's path, ``ops.lloyd_assign`` on the sweep's bf16 rows against the
    gated run's codebooks rounded to bf16, on the fp32 rows' norms (bf16
    K9 once)."""
    k = full.k
    eng = ClusterEngine(device="cuda", precision="bf16")
    out = {}

    def twice(what, fn, want):
        res, secs, got = counted(torch, ops, fn)
        for name in launches:
            launches[name] += got[name]
        counted_as(what, got, want(res))
        check(same_fit(torch, fn(), res), f"{what}: two runs differ")
        return res, secs, got

    wdraws = Draws.sample(full.n_points, k, weighted=True, device=dev,
                          generator=torch.Generator().manual_seed(0))
    res, secs, _ = twice(
        "bf16 weighted kmeans[cdf]",
        lambda: eng.kmeans(paper, k, weights=wts, draws=wdraws,
                           max_iters=full.max_iters),
        lambda r: dict(seed_prologue=1, distance_min_update_bf16=k,
                       lloyd_assign_bf16=r.n_iters))
    out["weighted_kmeans"] = dict(s=secs, n_iters=res.n_iters,
                                  inertia=float(res.inertia))
    print(f"bf16 weighted kmeans[cdf] at {full.name}: {secs:.3f} s, n_iters "
          f"{res.n_iters}, inertia {float(res.inertia):.6g}; counted, two "
          "runs bitwise")
    n_b = -(-full.n_points // batch_rows)
    init = paper[:k].clone()
    res, secs, _ = twice(
        "bf16 fit_minibatch",
        lambda: eng.fit_minibatch(
            init, lambda i: paper_np[i * batch_rows:(i + 1) * batch_rows],
            n_batches=n_b),
        lambda r: dict(lloyd_assign_bf16=n_b))
    out["fit_minibatch"] = dict(s=secs, ms_per_batch=secs * 1e3 / n_b)
    print(f"bf16 fit_minibatch over {full.name}, {n_b} batches: "
          f"{secs * 1e3 / n_b:.3f} ms per batch; counted, two runs bitwise")
    for tag, on in (("gated", True), ("ungated", False)):
        e = ClusterEngine(device="cuda", precision="bf16", bounds=on)
        draws = Draws.sample_batched(kvq.batch, kvq.n_points, kvq.k,
                                     generator=torch.Generator()
                                     .manual_seed(0), device=dev)
        res, secs, _ = twice(
            f"bf16 kmeans_batched[cdf, {tag}]",
            lambda e=e, draws=draws: e.kmeans_batched(
                kvq_pts, kvq.k, draws=draws, max_iters=kvq.max_iters),
            lambda r, on=on: dict(
                seed_prologue_batched=2,
                distance_min_update_gated_batched_bf16=kvq.k,
                lloyd_assign_gated_batched_bf16=int(r.n_iters.max()))
            if on else dict(distance_min_update_batched_bf16=kvq.k,
                            lloyd_assign_tiled_batched_bf16=int(
                                r.n_iters.max())))
        check(bool(torch.isfinite(res.inertia).all())
              and res.centroids.dtype == torch.float32,
              f"bf16 kmeans_batched[{tag}]: output malformed")
        out[f"kmeans_batched_{tag}"] = dict(
            s=secs, n_iters_max=int(res.n_iters.max()),
            inertia_mean=float(res.inertia.mean()))
        if on:
            book = res.centroids
        print(f"bf16 kmeans_batched[cdf, {tag}] at {kvq.name}: {secs:.3f} s, "
              f"n_iters max {int(res.n_iters.max())}, mean inertia "
              f"{float(res.inertia.mean()):.6g}; counted, two runs bitwise")
    knorms = bounds.point_norms(kvq_pts)
    kvq16, book16 = kvq_pts.bfloat16(), book.bfloat16()
    del book
    codes, secs, got = counted(torch, ops, lambda: ops.lloyd_assign(
        kvq16, book16, norms=knorms))
    for name in launches:
        launches[name] += got[name]
    counted_as("bf16 K9 path", got, dict(lloyd_assign_batched_bf16=1))
    again = ops.lloyd_assign(kvq16, book16, norms=knorms)
    check(all(torch.equal(a, b) for a, b in zip(codes, again)),
          "bf16 K9 path: two runs differ")
    out["k9_path_ms"] = secs * 1e3
    print(f"bf16 K9 path (ops.lloyd_assign, B={kvq.batch}): "
          f"{secs * 1e3:.2f} ms, one bf16 K9 launch, two runs bitwise")
    return out


def rejection_phase(torch, ops, kd, bounds, telemetry, Draws, eng, ungated,
                    layouts, k, dev, launches, max_iters=25):
    """Phase 4: rejection seeding (hier, flat) and its kmeans on each
    ``(name, points)`` of ``layouts``, gated (``eng``) and ungated, counted
    and held to its pins; every counted run's launches are added to
    ``launches``. Returns one record per layout and proposal."""
    P, A = 8, 8
    n, dim = layouts[0][1].shape
    n_tiles = -(-n // ops.choose_block_n(n, dim, 1))
    block_n = ops.choose_block_n(n, dim, k)
    rej_runs = []
    for layout, pts in layouts:
        draws = Draws.sample(pts.shape[0], k,
                             generator=torch.Generator().manual_seed(0),
                             device=dev, max_attempts=A)
        norms = bounds.point_norms(pts)
        tiled_ms = median_seed_ms(torch, eng, pts, k, draws, sampler="tiled")
        tiled_off_ms = median_seed_ms(torch, ungated, pts, k, draws,
                                      sampler="tiled")
        tiled = eng.seed(pts, k, draws=draws, sampler="tiled")
        for prop in ("hier", "flat"):
            hier = prop == "hier"
            what = f"rejection[{prop}, {layout}]"
            kw = dict(sampler="rejection", proposal=prop, refresh_block=P)
            outs = {}
            for tag, e in (("gated", eng), ("ungated", ungated)):
                res, ms, got = seed_run(torch, ops, e, pts, k, draws, **kw)
                for name in launches:
                    launches[name] += got[name]
                r = refreshes(res.accepts.tolist(), k, P)
                want = {name: 0 for name in got}
                # one K11 launch prices every attempt of a round
                want["row_min_d2"] = int((res.proposals > 0).sum())
                if tag == "gated":
                    want.update(seed_prologue=1,
                                distance_min_update_gated=r,
                                tile_cap=live_rounds(res.accepts.tolist(), k,
                                                     P) if hier else 0)
                else:
                    want["distance_min_update"] = r
                check(got == want, f"{what} {tag}: launches {got}, want "
                      f"{want}")
                check(tuple(res.centroids.shape) == (k, dim)
                      and bool(torch.isfinite(res.min_d2).all())
                      and len(set(res.indices.tolist())) == k,
                      f"{what} {tag}: output malformed")
                telemetry.check_rejection_counters(
                    res.proposals, res.accepts, k, A, res.recovered)
                telemetry.check_hier_counters(
                    res.tightened, res.supers, res.proposals, k,
                    n_tiles=n_tiles, hier=hier)
                check(int(res.recovered.sum()) == 0,
                      f"{what} {tag}: a guard healed a round")
                again = e.seed(pts, k, draws=draws, **kw)
                check(same_seeds(torch, res, again)
                      and all(torch.equal(getattr(res, f), getattr(again, f))
                              for f in ("proposals", "accepts", "tightened",
                                        "supers")),
                      f"{what} {tag}: two runs differ")
                # the settled D² is one fold of all k seeds from +inf
                fold, _ = kd.distance_min_update(
                    pts, norms, res.centroids.contiguous(),
                    torch.full_like(norms, torch.inf), block_n=block_n)
                check(torch.equal(fold, res.min_d2),
                      f"{what} {tag}: min_d2 is not one fold of the seeds "
                      f"(max err {bitwise_err(torch, fold, res.min_d2)})")
                outs[tag] = dict(res=res, ms=ms, launches=got, refreshes=r)
            on, off = outs["gated"]["res"], outs["ungated"]["res"]
            if not hier:
                check(same_seeds(torch, on, off)
                      and torch.equal(on.proposals, off.proposals)
                      and torch.equal(on.accepts, off.accepts),
                      f"{what}: gated is not bitwise ungated")
            # refresh_block=1: hier, flat and the tiled sampler agree
            one = eng.seed(pts, k, draws=draws, sampler="rejection",
                           proposal=prop, refresh_block=1)
            check(torch.equal(one.indices, tiled.indices),
                  f"{what}: refresh_block=1 is not the tiled seeds")
            # the kmeans entry point: the seeding's seeds, then Lloyd
            fit, fit_s, fgot = kmeans_run(torch, ops, eng, pts, k,
                                          "rejection", draws, max_iters,
                                          proposal=prop)
            for name in launches:
                launches[name] += fgot[name]
            check(fgot["lloyd_assign_gated"] == fit.n_iters
                  and fgot["seed_prologue"] == 1
                  and fgot["row_min_d2"] == int((on.proposals > 0).sum())
                  and fgot["tile_cap"] == (live_rounds(
                      on.accepts.tolist(), k, P) if hier else 0),
                  f"{what}: kmeans launches {fgot}")
            check(same_fit(torch, fit, eng.fit(pts, on.centroids,
                                               max_iters=max_iters)),
                  f"{what}: kmeans is not a fit from the seeding's seeds")
            if not hier:
                ofit, _, _ = kmeans_run(torch, ops, ungated, pts, k,
                                        "rejection", draws, max_iters,
                                        proposal=prop)
                check(same_fit(torch, fit, ofit),
                      f"{what}: kmeans gated is not bitwise ungated")
            rej_ms = median_seed_ms(torch, eng, pts, k, draws, **kw)
            rej_off_ms = median_seed_ms(torch, ungated, pts, k, draws, **kw)
            run = dict(layout=layout, proposal=prop,
                       proposals=int(on.proposals.sum()),
                       accepts=int(on.accepts.sum()),
                       fallbacks=int((on.accepts[1:] == 0).sum()),
                       tightened=int(on.tightened.sum()),
                       refreshes=outs["gated"]["refreshes"],
                       ungated_refreshes=outs["ungated"]["refreshes"],
                       seed_skipped=int(on.skipped.sum()),
                       seed_pruned=int(on.pruned.sum()),
                       seed_ms=rej_ms, ungated_seed_ms=rej_off_ms,
                       tiled_seed_ms=tiled_ms,
                       tiled_ungated_seed_ms=tiled_off_ms,
                       kmeans_s=fit_s, n_iters=fit.n_iters,
                       inertia=float(fit.inertia),
                       launches=outs["gated"]["launches"],
                       ungated_launches=outs["ungated"]["launches"])
            rej_runs.append(run)
            print(f"{what}: seeding {rej_ms:.2f} ms gated / {rej_off_ms:.2f} "
                  f"ms ungated (tiled {tiled_ms:.2f} / {tiled_off_ms:.2f}); "
                  f"proposals {run['proposals']}, accepts {run['accepts']}, "
                  f"fallbacks {run['fallbacks']}, tightened "
                  f"{run['tightened']}, refreshes {run['refreshes']} gated / "
                  f"{run['ungated_refreshes']} ungated; skipped "
                  f"{run['seed_skipped']} tiles, pruned {run['seed_pruned']} "
                  f"rows; kmeans {fit_s:.3f} s, n_iters {fit.n_iters}, "
                  f"inertia {run['inertia']:.6g}; launches "
                  f"{outs['gated']['launches']}")
    return rej_runs


def scan_row_census(torch, sampling, dev, n_problems, n) -> dict:
    """What batched sampling rests on: how many bit patterns one row's scan
    takes over tensors of 1, 8, 64 and 6656 rows, for ``torch.cumsum``
    along dim 1 (rows of 4096 floats, the samplers' rows before batching)
    and for the samplers' row scan (``sampling._row_scan``, rows of
    ``SCAN_BLOCK``); and whether rows 0, 1 and B−1 of a (B, n)
    ``prefix_sum`` are the 1-D calls."""
    gen = torch.Generator(device=dev).manual_seed(1)
    out = {}
    for name, width, scan in (
            ("torch.cumsum dim 1", 4096, lambda x: torch.cumsum(
                torch.cat([x, torch.zeros_like(x)]) if x.shape[0] == 1
                else x, 1)),
            ("sampling row scan", sampling.SCAN_BLOCK, sampling._row_scan)):
        base = torch.rand((6656, width), generator=gen, device=dev)
        rows = []
        for count in (1, 8, 64, 6656):
            row = scan(base[:count])[0]
            if not any(torch.equal(row, r) for r in rows):
                rows.append(row)
        out[name] = len(rows)
    w = torch.rand((n_problems, n), generator=gen, device=dev)
    got = sampling.prefix_sum(w)
    out["prefix_sum rows bitwise"] = all(
        torch.equal(got[b], sampling.prefix_sum(w[b]))
        for b in (0, 1, n_problems - 1))
    return out


def k7_case(torch, kd, ops, pts, norms, m, gen):
    """K7 at the batched shape: two launches bitwise, against its plain
    twin, rows 0, 1 and B−1 bitwise K2 on their problem; times and bound."""
    bsz, n, d = pts.shape
    bn = ops.choose_block_n(n, d, 1)        # the seeding rounds' tiles
    rows = torch.randint(n, (2 * m,), generator=gen, device=pts.device)
    cents = pts[:, rows[:m]].contiguous()
    md_in = kd.distance_min_update_batched_torch(
        pts, norms, pts[:, rows[m:]].contiguous(),
        torch.full((bsz, n), torch.inf, device=pts.device), block_n=bn)[0]
    out1 = kd.distance_min_update_batched(pts, norms, cents, md_in,
                                          block_n=bn)
    out2 = kd.distance_min_update_batched(pts, norms, cents, md_in,
                                          block_n=bn)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(out1, out2)),
          f"K7 m={m}: two launches differ")
    ref = kd.distance_min_update_batched_torch(pts, norms, cents, md_in,
                                               block_n=bn)
    tol = d2_tol(torch, norms, cents.reshape(-1, d))
    err_md = float((out1[0] - ref[0]).abs().max())
    check(err_md <= tol, f"K7 min_d2 err {err_md} > {tol}")
    check(bool(((out1[1] - ref[1]).abs()
                <= partial_tol(tol, bn, ref[1])).all()),
          f"K7 partials outside tolerance (max err "
          f"{float((out1[1] - ref[1]).abs().max())})")
    for b in (0, 1, bsz - 1):
        single = kd.distance_min_update(pts[b], norms[b], cents[b], md_in[b],
                                        block_n=bn)
        check(all(torch.equal(u[b], v) for u, v in zip(out1, single)),
              f"K7 m={m}: problem {b} is not bitwise K2 on its slice")
    fp32_ms = widened(torch, f"K7 m={m}", lambda p, c: (
        kd.distance_min_update_batched(p, norms, c, md_in, block_n=bn)),
        pts, cents, out1)
    ms = gpu_ms(torch, lambda: kd.distance_min_update_batched(
        pts, norms, cents, md_in, block_n=bn))
    what = f"K7 {stream_tag(torch, pts)} d={d} m={m}"
    same_bits(torch, f"{what} vs the template entry", out1,
              kd.distance_min_update_template(pts, norms, cents, md_in,
                                              block_n=bn))
    template_ms = gpu_ms(torch, lambda: kd.distance_min_update_template(
        pts, norms, cents, md_in, block_n=bn), reps=5)
    print(f"  {what}: bitwise the template entry; template entry "
          f"{template_ms:.4f} ms")
    plain = gpu_ms(torch, lambda: kd.distance_min_update_batched_torch(
        pts, norms, cents, md_in, block_n=bn), reps=1, warmup=0)
    t = -(-n // bn)
    xb = pts.element_size()
    bms, by = round_bound_ms(
        torch, pts, bsz * (xb * (n * d + m * d) + 4 * (3 * n + t)),
        bsz * n * m * 2 * d, bsz * n * m * 3)
    return dict(batch=bsz, n=n, d=d, m=m, block_n=bn,
                stream=stream_tag(torch, pts), max_abs_err=err_md, tol=tol,
                ms=ms, template_ms=template_ms, plain_ms=plain,
                fp32_ms=fp32_ms, bound_ms=bms, bound_by=by)


def k10a_case(torch, la, kd, ops, bounds, pts, norms, k, gen):
    """K10a at the batched shape: two launches bitwise, against its plain
    twin (labels outside near-ties, D², partials and gaps within tolerance,
    super counts exact and sums within tolerance over its own labels), every
    problem bitwise K3 on its slice; the screened route's counters, times
    and bounds (at d >= 8 the record's is the screen's, the dots at TF32's
    or bf16's tensor-core rate, with the fp32-FMA bound beside it)."""
    bsz, n, d = pts.shape
    bn = ops.choose_block_n(n, d, k)
    t = -(-n // bn)
    tps = bounds.tiles_per_super(t)
    idx = torch.randint(n, (bsz, k, 1), generator=gen, device=pts.device)
    cents = torch.take_along_dim(pts, idx, dim=1).contiguous()
    out1 = la.lloyd_assign_tiled_batched(pts, norms, cents, block_n=bn,
                                         tps=tps)
    scr = screen_record(la, "lloyd_assign_tiled_batched", pts, torch)
    out2 = la.lloyd_assign_tiled_batched(pts, norms, cents, block_n=bn,
                                         tps=tps)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(out1, out2)),
          f"K10a k={k}: two launches differ")
    lab, md, part, gap, ssums, scounts = out1
    ref = la.lloyd_assign_tiled_batched_torch(pts, norms, cents, block_n=bn,
                                              tps=tps)
    tol = d2_tol(torch, norms, cents.reshape(-1, d))
    n_diff, bad = map(sum, zip(*(
        label_diffs(torch, kd.tile_d2(pts[b], cents[b], norms[b]), lab[b],
                    ref[0][b], tol) for b in range(bsz))))
    check(bad == 0, f"K10a k={k}: {bad} labels differ beyond near-ties")
    err_md = float((md - ref[1]).abs().max())
    check(err_md <= tol, f"K10a min_d2 err {err_md} > {tol}")
    check(bool(((part - ref[2]).abs() <= partial_tol(tol, bn, ref[2])).all()),
          "K10a partials outside tolerance")
    gfin = torch.isfinite(ref[3])
    check(torch.equal(torch.isfinite(gap), gfin)
          and bool(((gap - ref[3])[gfin].abs() <= 2 * math.sqrt(tol)).all()),
          "K10a gaps outside tolerance")
    n_super = ssums.shape[1]
    s_of = (torch.arange(bsz, device=pts.device)[:, None] * n_super
            + torch.arange(n, device=pts.device)[None, :] // (bn * tps))
    check(super_sums_ok(torch, pts.reshape(-1, d), lab.reshape(-1),
                        ssums.reshape(-1, k, d), scounts.reshape(-1, k),
                        bn * tps, s_of=s_of.reshape(-1)),
          f"K10a k={k}: super sums or counts outside tolerance")
    every_problem(torch, f"K10a k={k}", out1, lambda b: la.lloyd_assign_tiled(
        pts[b], norms[b], cents[b], block_n=bn, tps=tps), bsz)
    fp32_ms = widened(torch, f"K10a k={k}", lambda p, c: (
        la.lloyd_assign_tiled_batched(p, norms, c, block_n=bn, tps=tps)),
        pts, cents, out1, reps=5)
    ms = gpu_ms(torch, lambda: la.lloyd_assign_tiled_batched(
        pts, norms, cents, block_n=bn, tps=tps), reps=5)
    plain = gpu_ms(torch, lambda: la.lloyd_assign_tiled_batched_torch(
        pts, norms, cents, block_n=bn, tps=tps), reps=1, warmup=0)
    xb = pts.element_size()
    work = (bsz * (xb * (n * d + k * d)
                   + 4 * (3 * n + 2 * t + n_super * k * (d + 1))),
            bsz * n * k * 2 * d, bsz * (n * k * 3 + n * d))
    fma_ms, _ = round_bound_ms(torch, pts, *work)
    bms, by = round_bound_ms(torch, pts, *work, tf32=bool(scr))
    return dict(batch=bsz, n=n, d=d, k=k, block_n=bn, tps=tps,
                stream=stream_tag(torch, pts), label_diffs=n_diff,
                max_abs_err=err_md, tol=tol, ms=ms, plain_ms=plain,
                fp32_ms=fp32_ms, bound_ms=bms, bound_by=by,
                fma_bound_ms=fma_ms, **scr)


def row(res, b):
    """Problem b of a batched result, as the single result type."""
    return type(res)(*(f if f is None else f[b] for f in res))


def batched_phase(torch, ops, kd, la, bounds, ClusterEngine, Draws, pts,
                  cfg, dev, launches, gen, n_single=16):
    """Phase 5: K7 and K10a at ``cfg``, then ``kmeans_batched`` with bounds
    off for both samplers, counted (K7 once per round, K10a once per
    iteration of the slowest problem, nothing else), repeated bitwise,
    rows 0, 1 and B−1 bitwise the single ``seed`` then ``fit`` from the same
    draws, and every problem's inertia within 1e-4 of the plain fit's from
    the same seeds. Times: seeding, Lloyd per iteration, kmeans_batched,
    and a loop of single seed + fit over ``n_single`` problems."""
    bsz, n, d, k = cfg.batch, cfg.n_points, cfg.dim, cfg.k
    norms = bounds.point_norms(pts)
    cases = {"K7": [k7_case(torch, kd, ops, pts, norms, m, gen)
                    for m in (1, 8)],
             "K10a": [k10a_case(torch, la, kd, ops, bounds, pts, norms, k,
                                gen)]}
    # the bf16 stream: m = 1 (a seeding round's), the norms the fp32 points'
    pts16 = pts.bfloat16()
    cases["K7 bf16"] = [k7_case(torch, kd, ops, pts16, norms, 1, gen)]
    cases["K10a bf16"] = [k10a_case(torch, la, kd, ops, bounds, pts16, norms,
                                    k, gen)]
    del norms, pts16
    for name, cs in cases.items():
        if name.endswith("bf16"):
            for c in cs:
                print_bf16(name.split()[0], c)
            continue
        for c in cs:
            print(f"{name} B={c['batch']} n={c['n']} d={c['d']} "
                  + (f"m={c['m']}" if name == "K7" else
                     f"k={c['k']} tps={c['tps']} label diffs "
                     f"{c['label_diffs']}")
                  + f": err {c['max_abs_err']:.3g} (tol {c['tol']:.3g}), "
                  + ("every problem" if name == "K10a" else "rows 0, 1, B-1")
                  + " bitwise the single kernel; "
                  f"{c['ms']:.4f} ms, plain {c['plain_ms']:.4f} ms, bound "
                  f"{c['bound_ms']:.4f} ms ({c['bound_by']})"
                  + screen_text(c))
    eng = ClusterEngine(device="cuda", bounds=False)
    fused = ClusterEngine("fused", device="cuda", bounds=False)
    runs = []
    for sampler in ("cdf", "tiled"):
        what = f"kmeans_batched[{sampler}]"
        draws = Draws.sample_batched(
            bsz, n, k, generator=torch.Generator().manual_seed(0), device=dev)
        kw = dict(draws=draws, sampler=sampler, max_iters=cfg.max_iters)
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.kmeans_batched(pts, k, **kw)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        got = dict(ops.LAUNCHES)
        for name in launches:
            launches[name] += got[name]
        iters = int(res.n_iters.max())
        want = {name: 0 for name in got}
        want.update(distance_min_update_batched=k,
                    lloyd_assign_tiled_batched=iters)
        check(got == want, f"{what}: launches {got}, want {want}")
        check(tuple(res.centroids.shape) == (bsz, k, d)
              and tuple(res.assignment.shape) == (bsz, n)
              and bool(torch.isfinite(res.centroids).all())
              and bool(torch.isfinite(res.inertia).all())
              and int(res.assignment.min()) >= 0
              and int(res.assignment.max()) < k
              and int(res.n_iters.min()) >= 1 and iters <= cfg.max_iters,
              f"{what}: output malformed")
        again = eng.kmeans_batched(pts, k, **kw)
        check(same_fit(torch, again, res), f"{what}: two runs differ")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        seeds = eng.seed_batched(pts, k, draws=draws, sampler=sampler)
        torch.cuda.synchronize()
        seed_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        fit = eng.fit_batched(pts, seeds.centroids, max_iters=cfg.max_iters)
        torch.cuda.synchronize()
        lloyd_ms = (time.perf_counter() - t0) * 1e3 / iters
        check(same_fit(torch, fit, res),
              f"{what}: not seed_batched then fit_batched")
        for b in (0, 1, bsz - 1):
            one = eng.seed(pts[b], k, draws=draws[b], sampler=sampler)
            check(same_seeds(torch, one, row(seeds, b)),
                  f"{what}: problem {b}'s seeds are not the single seeding's")
            check(same_fit(torch, eng.fit(pts[b], one.centroids,
                                          max_iters=cfg.max_iters),
                           row(res, b)),
                  f"{what}: problem {b} is not the single seed + fit")
        # the plain twins on the card from the same seeds
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = fused.fit_batched(pts, seeds.centroids,
                                  max_iters=cfg.max_iters)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        rel = float(((plain.inertia - res.inertia).abs()
                     / res.inertia).max())
        # 1e-4: both fits take the same Lloyd steps; they differ only in
        # the fp32 summation order of partials and sums
        check(rel <= 1e-4, f"{what}: plain fit inertia differs by {rel:.3g}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in range(n_single):
            one = eng.seed(pts[b], k, draws=draws[b], sampler=sampler)
            eng.fit(pts[b], one.centroids, max_iters=cfg.max_iters)
        torch.cuda.synchronize()
        single_ms = (time.perf_counter() - t0) * 1e3 / n_single
        run = dict(sampler=sampler, kmeans_batched_s=total_s,
                   seed_ms=seed_ms, lloyd_ms_per_iter=lloyd_ms,
                   n_iters_max=iters, n_iters_min=int(res.n_iters.min()),
                   inertia_mean=float(res.inertia.mean()),
                   plain_fit_s=plain_s, inertia_rel_diff_max=rel,
                   ms_per_problem=total_s * 1e3 / bsz,
                   single_ms_per_problem=single_ms, launches=got,
                   repeat_bitwise=True, rows_bitwise_single=True)
        runs.append(run)
        print(f"{what} at {cfg.name} (B={bsz}, n={n}, d={d}, k={k}): "
              f"{total_s:.3f} s end to end, seeding {seed_ms:.1f} ms, Lloyd "
              f"{lloyd_ms:.2f} ms/iter ({iters} iterations, min "
              f"{run['n_iters_min']}); {run['ms_per_problem']:.4f} ms per "
              f"problem against {single_ms:.2f} ms for a single seed + fit "
              f"({n_single} problems); plain fit {plain_s:.2f} s, inertia "
              f"rel diff max {rel:.3g}; launches "
              f"{ {n: c for n, c in got.items() if c} }")
    return cases, runs


def k1b_case(torch, kd, bounds, ops, pts):
    """The batched K1 at the seeding tiles of the batched shape: two
    launches bitwise, all four outputs bitwise the batched template entry
    (``seed_prologue_template``), norms bitwise ``bounds.point_norms``, the
    tile balls against the plain twin, rows 0, 1 and B−1 bitwise K1 on
    their problem; times of K1 and the template entry beside the
    bound."""
    bsz, n, d = pts.shape
    bn = ops.choose_block_n(n, d, 1)
    out1 = kd.seed_prologue_batched(pts, bn)
    out2 = kd.seed_prologue_batched(pts, bn)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(out1, out2)),
          "batched K1: two launches differ")
    check(all(bits_equal(torch, a, b) for a, b in
              zip(out1, kd.seed_prologue_template(pts, bn))),
          "batched K1: not bitwise the template entry")
    check(torch.equal(out1[0], bounds.point_norms(pts)),
          "batched K1: norms are not bitwise bounds.point_norms")
    ref = kd.seed_prologue_torch(pts, bn)
    tol = 1e-5 * float(pts.abs().max())
    err = max(float((a - b).abs().max()) for a, b in zip(out1[1:], ref[1:]))
    check(err <= tol, f"batched K1: centers/radii/center_d err {err} > {tol}")
    for b in (0, 1, bsz - 1):
        single = kd.seed_prologue(pts[b], bn)
        check(all(torch.equal(u[b], v) for u, v in zip(out1, single)),
              f"batched K1: problem {b} is not bitwise K1 on its slice")
    ms = gpu_ms(torch, lambda: kd.seed_prologue_batched(pts, bn), reps=5)
    template_ms = gpu_ms(torch, lambda: kd.seed_prologue_template(pts, bn),
                         reps=5)
    ms_again = gpu_ms(torch, lambda: kd.seed_prologue_batched(pts, bn),
                      reps=5)
    plain = gpu_ms(torch, lambda: kd.seed_prologue_torch(pts, bn), reps=1,
                   warmup=0)
    t = -(-n // bn)
    bms, by = bound_ms(4 * bsz * (n * d + 2 * n + t * (d + 1)),
                       bsz * (n * (3 * d + 1) + t * d))
    return dict(batch=bsz, n=n, d=d, block_n=bn, max_abs_err=err, tol=tol,
                ms=ms, ms_again=ms_again, template_ms=template_ms,
                plain_ms=plain, bound_ms=bms,
                bound_by=by,
                route=("lone", "wide")[kd.prologue_route(d, bn) == 0])


def k8_case(torch, kd, bounds, ops, pts, cache, md_in, cents, mask):
    """K8 on one carried state of every problem: ``mask`` is 'gate' (each
    problem's seeding gate), 'all' or 'mixed' (the gate with tile
    b % n_tiles of problem b forced off, and nothing active in problem 1).
    Two launches bitwise; against the plain twin; skipped tiles keep their
    carries; rows 0, 1 and B−1 bitwise K5 on their problem; all active,
    bitwise K7. Times and bound (from the active tiles' bytes)."""
    bsz, n, d = pts.shape
    m = cents.shape[1]
    bn = ops.choose_block_n(n, d, 1)
    dev = pts.device
    parts = kd.distance_min_update_batched(pts, cache.norms,
                                           cents[:, :1].contiguous(), md_in,
                                           block_n=bn)[1]
    tmax = bounds.tile_reduce_max(md_in, bn)
    act, dc, margin = bounds.seed_gate(cents, cache, tmax)
    t = act.shape[-1]
    if mask == "all":
        act = torch.ones_like(act)
    elif mask == "mixed":
        act = act.clone()
        ar = torch.arange(bsz, device=dev)
        act[ar, ar % t] = False
        act[1] = False
    args = (pts, cache.norms, cents, md_in, cache.center_d, dc, margin,
            parts, tmax, act)
    out1 = kd.distance_min_update_gated_batched(*args, block_n=bn)
    out2 = kd.distance_min_update_gated_batched(*args, block_n=bn)
    torch.cuda.synchronize()
    what = f"K8 m={m} mask={mask}"
    check(all(torch.equal(a, b) for a, b in zip(out1, out2)),
          f"{what}: two launches differ")
    ref = kd.distance_min_update_gated_batched_torch(*args, block_n=bn)
    tol = d2_tol(torch, cache.norms, cents.reshape(-1, d))
    err = float((out1[0] - ref[0]).abs().max())
    check(err <= tol, f"{what}: min_d2 err {err} > {tol}")
    check(bool(((out1[1] - ref[1]).abs()
                <= partial_tol(tol, bn, ref[1])).all()),
          f"{what}: partials outside tolerance")
    check(float((out1[2] - ref[2]).abs().max()) <= tol,
          f"{what}: tile maxima outside tolerance")
    check(torch.equal(out1[3], ref[3]), f"{what}: pruned counts differ")
    skip = ~act
    rows = bounds.expand_mask(skip, bn, n)
    check(torch.equal(out1[0][rows], md_in[rows])
          and torch.equal(out1[1][skip], parts[skip])
          and torch.equal(out1[2][skip], tmax[skip])
          and not bool(out1[3][skip].any()),
          f"{what}: a skipped tile's outputs moved")
    for b in (0, 1, bsz - 1):
        single = kd.distance_min_update_gated(*(a[b] for a in args),
                                              block_n=bn)
        check(all(torch.equal(u[b], v) for u, v in zip(out1, single)),
              f"{what}: problem {b} is not bitwise K5 on its slice")
    if mask == "all":
        # as K5 against K2: K7's bits but on the pruned rows (fp32: all)
        k7 = kd.distance_min_update_batched(pts, cache.norms, cents, md_in,
                                            block_n=bn)
        prune = bounds.seed_point_prune(
            md_in, cache.center_d, bounds.expand_mask(dc, bn, n),
            bounds.expand_mask(margin, bn, n))
        check(torch.equal(out1[0], torch.where(prune, md_in, k7[0]))
              and (pts.dtype != torch.float32
                   or (torch.equal(out1[0], k7[0])
                       and torch.equal(out1[1], k7[1]))),
              f"{what}: all-active K8 is not K7 but on its pruned rows")
    fp32_ms = widened(torch, what, lambda p, c: (
        kd.distance_min_update_gated_batched(p, args[1], c, *args[3:],
                                             block_n=bn)),
        pts, cents, out1, reps=5)
    ms = gpu_ms(torch, lambda: kd.distance_min_update_gated_batched(
        *args, block_n=bn), reps=5)
    plain = gpu_ms(torch, lambda: kd.distance_min_update_gated_batched_torch(
        *args, block_n=bn), reps=1, warmup=0)
    rows_act = int(bounds.expand_mask(act, bn, n).sum())
    n_pruned = int(out1[3].sum())
    fresh = rows_act - n_pruned
    # an active row reads md and center_d and writes md; a fresh row also
    # reads x and its norm; each tile's gate scalars, carries and outputs
    xb = pts.element_size()
    bms, by = round_bound_ms(torch, pts, xb * (fresh * d + bsz * m * d)
                             + 4 * (3 * rows_act + fresh + 7 * bsz * t),
                             fresh * m * 2 * d, fresh * m * 3 + rows_act * 6)
    return dict(batch=bsz, n=n, d=d, m=m, mask=mask, block_n=bn,
                stream=stream_tag(torch, pts), active_tiles=int(act.sum()),
                tiles=bsz * t, pruned=n_pruned, max_abs_err=err, tol=tol,
                ms=ms, plain_ms=plain, fp32_ms=fp32_ms, bound_ms=bms,
                bound_by=by)


def k10b_case(torch, la, kd, bounds, ops, pts, cache, k, gen, only=None):
    """K10b from a carried state of every problem: one all-active launch
    with no carried bound (held bitwise to K10a) gives the state; two
    centroids of each problem then move a little, so the rows of unmoved
    clusters prune. Masks: every tile, mixed (problem 0 every other super,
    problem 1 none, the others all but super b % n_super), and the movement
    gate's (``only`` names a subset). Two launches bitwise; against the
    plain twin; skipped tiles and supers keep their carries; every problem
    bitwise the template's K6 (``lloyd_assign_gated_template``) on its
    slice; the screened route's counters and both bounds
    as K10a's."""
    bsz, n, d = pts.shape
    bn = ops.choose_block_n(n, d, k)
    t = -(-n // bn)
    tps = bounds.tiles_per_super(t)
    s = -(-t // tps)
    dev = pts.device
    idx = torch.randint(n, (bsz, k, 1), generator=gen, device=dev)
    # the centroid carry is fp32, the kernel gets it in the stream's dtype
    c0 = (torch.take_along_dim(pts, idx, dim=1).float() + 0.01).contiguous()
    c0k = c0.to(pts.dtype)
    all_on = torch.ones((bsz, t), dtype=torch.bool, device=dev)
    zt = torch.zeros((bsz, t), device=dev)
    first = la.lloyd_assign_gated_batched(
        pts, cache.norms, c0k, torch.zeros((bsz, k), device=dev), zt, zt,
        torch.zeros((bsz, n), dtype=torch.int32, device=dev),
        torch.zeros((bsz, n), device=dev),
        torch.full((bsz, n), -torch.inf, device=dev), zt, zt,
        torch.zeros((bsz, s, k, d), device=dev),
        torch.zeros((bsz, s, k), device=dev), all_on, block_n=bn, tps=tps)
    k10a = la.lloyd_assign_tiled_batched(pts, cache.norms, c0k, block_n=bn,
                                         tps=tps)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(
        (first[0], first[1], first[3], first[4], first[5], first[6]), k10a))
        and not bool(first[7].any()),
        f"K10b k={k}: all-active K10b without a bound is not bitwise K10a")
    del k10a
    c1 = c0.clone()
    c1[:, [0, k - 1]] += 0.002
    st = bounds.BoundState(first[3], tile_gap=first[4], tile_sums=first[5],
                           tile_counts=first[6], assignment=first[0],
                           min_d2=first[1], point_lb=first[2], lb_debt=zt)
    del first
    delta = bounds.centroid_movement(c1, c0)
    c1 = c1.to(pts.dtype)
    thresh, absorb = bounds.assign_point_scalars(delta, c1, st, cache)
    sup = torch.ones((bsz, s), dtype=torch.bool, device=dev)
    ar = torch.arange(bsz, device=dev)
    sup[ar, ar % s] = False
    sup[0] = torch.arange(s, device=dev) % 2 == 0
    sup[1] = False
    mixed = bounds.expand_mask(sup, tps, t)
    masks = {"all": all_on, "mixed": mixed,
             "gate": bounds.expand_active_supers(bounds.assign_active_tiles(
                 delta, c1, st, cache, tps=tps), tps)}
    tol = d2_tol(torch, cache.norms, c1.reshape(-1, d))
    res = []
    for name, act in masks.items():
        if only is not None and name not in only:
            continue
        what = f"K10b k={k} mask={name}"
        args = (pts, cache.norms, c1, delta, thresh, absorb, st.assignment,
                st.min_d2, st.point_lb, st.partials, st.tile_gap,
                st.tile_sums, st.tile_counts, act)
        out1 = la.lloyd_assign_gated_batched(*args, block_n=bn, tps=tps)
        scr = screen_record(la, "lloyd_assign_gated_batched", pts, torch)
        out2 = la.lloyd_assign_gated_batched(*args, block_n=bn, tps=tps)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(out1, out2)),
              f"{what}: two launches differ")
        del out2
        ref = la.lloyd_assign_gated_batched_torch(*args, block_n=bn, tps=tps)
        act_pt = bounds.expand_mask(act, bn, n)
        prune = bounds.assign_point_prune(
            st.assignment, st.min_d2, st.point_lb, delta,
            bounds.expand_mask(thresh, bn, n), act_pt)
        check(torch.equal(out1[7], ref[7]), f"{what}: pruned counts differ")
        check(int(out1[7].sum()) > 0, f"{what}: the prune never fired")
        check(all(torch.equal(o[prune], r[prune])
                  for o, r in zip(out1[:3], ref[:3])),
              f"{what}: pruned rows' label, D² or lb differ")
        bad = n_diff = 0
        for b in range(bsz):
            diff = out1[0][b] != ref[0][b]
            if bool(diff.any()):
                d2 = kd.tile_d2(pts[b], c1[b], cache.norms[b])
                gap = (d2.gather(1, out1[0][b].long()[:, None])
                       - d2.gather(1, ref[0][b].long()[:, None])).abs()[:, 0]
                bad += int((diff & (gap > tol)).sum())
                n_diff += int(diff.sum())
        check(bad == 0, f"{what}: {bad} labels differ beyond near-ties")
        err = float((out1[1] - ref[1]).abs().max())
        check(err <= tol, f"{what}: min_d2 err {err} > {tol}")
        sup_act = bounds.super_any(act, tps)
        s_of = (torch.arange(bsz, device=dev)[:, None] * s
                + torch.arange(n, device=dev)[None, :] // (bn * tps))
        check(super_sums_ok(torch, pts.reshape(-1, d), out1[0].reshape(-1),
                            out1[5].reshape(-1, k, d),
                            out1[6].reshape(-1, k), bn * tps,
                            sup_act.reshape(-1), s_of=s_of.reshape(-1)),
              f"{what}: super sums or counts outside tolerance")
        skip = ~act
        rows = bounds.expand_mask(skip, bn, n)
        sup_skip = ~sup_act
        kept = all(torch.equal(o[sel], c[sel]) for o, c, sel in (
            (out1[0], st.assignment, rows), (out1[1], st.min_d2, rows),
            (out1[2], st.point_lb, rows), (out1[3], st.partials, skip),
            (out1[4], st.tile_gap, skip), (out1[5], st.tile_sums, sup_skip),
            (out1[6], st.tile_counts, sup_skip)))
        check(kept and not bool(out1[7][skip].any()),
              f"{what}: a skipped tile's or super's outputs moved")
        every_problem(torch, what, out1, lambda b, args=args: (
            la.lloyd_assign_gated_template(*(a[b] for a in args),
                                           block_n=bn, tps=tps)), bsz)
        del ref
        fp32_ms = widened(torch, what, lambda p, c, args=args: (
            la.lloyd_assign_gated_batched(p, args[1], c, *args[3:],
                                          block_n=bn, tps=tps)),
            pts, c1, out1, reps=5) if name == "gate" else None
        ms = gpu_ms(torch, lambda: la.lloyd_assign_gated_batched(
            *args, block_n=bn, tps=tps), reps=5)
        plain = gpu_ms(torch, lambda: la.lloyd_assign_gated_batched_torch(
            *args, block_n=bn, tps=tps), reps=1, warmup=0) \
            if name == "gate" else None
        rows_act = int(act_pt.sum())
        n_pruned = int(out1[7].sum())
        fresh = rows_act - n_pruned
        s_act = int(sup_act.sum())
        xb = pts.element_size()
        work = (xb * (rows_act * d + bsz * k * d)
                + 4 * (rows_act * 6 + fresh + bsz * k + 6 * bsz * t
                       + s_act * k * (d + 1)),
                fresh * k * 2 * d, fresh * k * 3 + rows_act * (d + 4))
        fma_ms, _ = round_bound_ms(torch, pts, *work)
        bms, by = round_bound_ms(torch, pts, *work, tf32=bool(scr))
        res.append(dict(batch=bsz, n=n, d=d, k=k, mask=name, block_n=bn,
                        tps=tps, stream=stream_tag(torch, pts),
                        active_tiles=int(act.sum()), tiles=bsz * t,
                        pruned=n_pruned, label_diffs=n_diff,
                        max_abs_err=err, tol=tol, ms=ms, plain_ms=plain,
                        fp32_ms=fp32_ms, bound_ms=bms, bound_by=by,
                        fma_bound_ms=fma_ms, **scr))
        del out1
    return res


def adversarial_problems(torch, blobs_batched, bsz, n, d, k, dev, seed):
    """(points (B, n, d), centroids (B, k, d)), fp32, with the screen's hard
    cases: duplicated centroids (1 = 0, k - 1 = 2), a row halfway between
    two centroids (row 2) and a row on one (row 3), every other problem
    shifted by 1e3 in every coordinate (norms far above the distances), a
    zero row (row 0) and a NaN row (row 1)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    pts = blobs_batched(bsz, n, d, 64, generator=g)
    idx = torch.randint(n, (bsz, k, 1), generator=g, device=dev)
    cents = torch.take_along_dim(pts, idx, dim=1) + 0.01
    cents[:, 1] = cents[:, 0]
    cents[:, k - 1] = cents[:, 2]
    pts[:, 2] = 0.5 * (cents[:, 0] + cents[:, k // 2])
    pts[:, 3] = cents[:, 5]
    shift = (torch.arange(bsz, device=dev) % 2 == 0).float() * 1e3
    pts += shift[:, None, None]
    cents += shift[:, None, None]
    pts[:, 0] = 0.0
    pts[:, 1] = float("nan")
    return pts.contiguous(), cents.contiguous()


def screen_case(torch, la, kd, ops, bounds, pts, cents, dtype):
    """K10a and K10b on the screened route on adversarial problems (fp32
    ``pts`` and ``cents``, run in ``dtype``; norms from the fp32 points):
    K10a every problem bitwise K3; K10b all active with no carried bound
    bitwise K10a; then a gated K10b from that state with two centroids
    moved, every problem bitwise the template's K6
    (``lloyd_assign_gated_template``), screening exactly the rows that do
    not prune. Returns the screened route's counters of both."""
    bsz, n, d = pts.shape
    k = cents.shape[1]
    dev = pts.device
    norms = bounds.point_norms(pts)
    bn = ops.choose_block_n(n, d, k)
    t = -(-n // bn)
    tps = bounds.tiles_per_super(t)
    s = -(-t // tps)
    p, c = pts.to(dtype), cents.to(dtype)
    what = f"screen d={d} k={k} {stream_tag(torch, p)}"
    out = la.lloyd_assign_tiled_batched(p, norms, c, block_n=bn, tps=tps)
    a_st = screen_record(la, "lloyd_assign_tiled_batched", p, torch)
    check(a_st.get("screened_rows") == bsz * n,
          f"{what}: K10a did not take the screened route on every row")
    every_problem(torch, f"{what} K10a", out, lambda b: la.lloyd_assign_tiled(
        p[b], norms[b], c[b], block_n=bn, tps=tps), bsz)
    zt = torch.zeros((bsz, t), device=dev)
    all_on = torch.ones((bsz, t), dtype=torch.bool, device=dev)
    first = la.lloyd_assign_gated_batched(
        p, norms, c, torch.zeros((bsz, k), device=dev), zt, zt,
        torch.zeros((bsz, n), dtype=torch.int32, device=dev),
        torch.zeros((bsz, n), device=dev),
        torch.full((bsz, n), -torch.inf, device=dev), zt, zt,
        torch.zeros((bsz, s, k, d), device=dev),
        torch.zeros((bsz, s, k), device=dev), all_on, block_n=bn, tps=tps)
    check(all(bits_equal(torch, u, v) for u, v in zip(
        (first[0], first[1], first[3], first[4], first[5], first[6]), out))
        and not bool(first[7].any()),
        f"{what}: all-active K10b without a bound is not bitwise K10a")
    del out
    c1 = cents.clone()
    c1[:, [0, k - 1]] += 0.002
    st = bounds.BoundState(first[3], tile_gap=first[4], tile_sums=first[5],
                           tile_counts=first[6], assignment=first[0],
                           min_d2=first[1], point_lb=first[2], lb_debt=zt)
    delta = bounds.centroid_movement(c1, cents)
    c1 = c1.to(dtype)
    cache = bounds.RoundCache(*kd.seed_prologue_batched(pts, bn))
    thresh, absorb = bounds.assign_point_scalars(delta, c1, st, cache)
    args = (p, norms, c1, delta, thresh, absorb, st.assignment, st.min_d2,
            st.point_lb, st.partials, st.tile_gap, st.tile_sums,
            st.tile_counts, all_on)
    gated = la.lloyd_assign_gated_batched(*args, block_n=bn, tps=tps)
    b_st = screen_record(la, "lloyd_assign_gated_batched", p, torch)
    pruned = int(gated[7].sum())
    check(pruned > 0 and b_st.get("screened_rows") == bsz * n - pruned,
          f"{what}: K10b screened {b_st.get('screened_rows')} rows, "
          f"{bsz * n - pruned} did not prune")
    every_problem(torch, f"{what} K10b", gated,
                  lambda b: la.lloyd_assign_gated_template(
                      *(a[b] for a in args), block_n=bn, tps=tps), bsz)
    return dict(batch=bsz, n=n, d=d, k=k, stream=stream_tag(torch, p),
                pruned=pruned, k10a=a_st, k10b=b_st)


def screen_phase(torch, ops, kd, la, bounds, blobs_batched, dev, gen):
    """Phase 6 (screen): K10a and K10b on adversarial problems (B = 64,
    n = 16384) for d in {8, 13, 16} and k in {250, 256}, fp32 and bf16,
    each held bitwise to K3 / the template's K6 problem by problem
    (``screen_case``), with
    the screened route's counters; then K10b alone at the IVF build's PQ
    sweep shape (16 problems of 16384 rows, d = 8, k = 256; the gate's
    mask), as phase 6 holds it."""
    cases = []
    for d in (8, 13, 16):
        for k in (250, 256):
            pts, cents = adversarial_problems(torch, blobs_batched, 64, 16384,
                                              d, k, dev, 100 * d + k)
            for dtype in (torch.float32, torch.bfloat16):
                c = screen_case(torch, la, kd, ops, bounds, pts, cents, dtype)
                cases.append(c)
                print(f"screen B=64 n=16384 d={d} k={k} {c['stream']}: every "
                      f"problem bitwise K3 (K10a) and the template's K6 "
                      f"(K10b, {c['pruned']} rows pruned), all-active K10b bitwise K10a; K10a "
                      f"{c['k10a']['candidates_per_row']:.3f} candidates a "
                      f"row (most {c['k10a']['max_candidates']}), "
                      f"{c['k10a']['full_scan_share']:.4f} on the full scan; "
                      f"K10b {c['k10b']['candidates_per_row']:.3f} (most "
                      f"{c['k10b']['max_candidates']}), "
                      f"{c['k10b']['full_scan_share']:.4f}")
            del pts, cents
    ivf = blobs_batched(16, 16384, 8, 256, generator=torch.Generator(
        device=dev).manual_seed(3))
    cache = bounds.RoundCache(*kd.seed_prologue_batched(
        ivf, ops.choose_block_n(16384, 8, 256)))
    ivf_case = k10b_case(torch, la, kd, bounds, ops, ivf, cache, 256, gen,
                         only=("gate",))[0]
    print(f"K10b at the IVF build's PQ sweep shape (B=16 n=16384 d=8 k=256, "
          f"the gate's mask, {ivf_case['pruned']} rows pruned): every "
          f"problem bitwise the template's K6; {ivf_case['ms']:.4f} ms, bound "
          f"{ivf_case['bound_ms']:.4f} ms ({ivf_case['bound_by']})"
          + screen_text(ivf_case))
    return cases, ivf_case


def counted(torch, ops, fn):
    """``fn()`` with the launch counters zeroed just before and read just
    after: (result, host seconds, launches)."""
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, dict(ops.LAUNCHES)


def gated_batched_phase(torch, ops, kd, la, bounds, ClusterEngine, Draws,
                        layouts, cfg, dev, launches, gen):
    """Phase 6: the batched K1, K8 and K10b at ``cfg`` against their plain
    twins, then the gated ``kmeans_batched`` (bounds on, the default) for
    both samplers on every ``(name, points)`` of ``layouts``, counted (the
    batched K1 once per phase, K8 once per round, K10b once per iteration of
    the slowest problem, nothing else), bitwise the ``bounds=False`` run
    and a second run, rows 0, 1 and B−1 bitwise the single gated ``seed``
    then ``fit`` with their counters; times beside the ungated run."""
    pts = layouts[0][1]
    bsz, n, d = pts.shape
    k = cfg.k
    cases = {"K1b": [k1b_case(torch, kd, bounds, ops, pts)]}
    cache = bounds.RoundCache(*kd.seed_prologue_batched(
        pts, ops.choose_block_n(n, d, 1)))
    rows = torch.randint(n, (bsz, 10, 1), generator=gen, device=dev)
    picks = torch.take_along_dim(pts, rows, dim=1)
    md_in = kd.distance_min_update_batched(
        pts, cache.norms, picks[:, 8:].contiguous(),
        torch.full((bsz, n), torch.inf, device=dev),
        block_n=ops.choose_block_n(n, d, 1))[0]
    cases["K8"] = [k8_case(torch, kd, bounds, ops, pts, cache, md_in,
                           picks[:, :m].contiguous(), mask)
                   for m in (1, 8) for mask in ("gate", "all", "mixed")]
    pts16 = pts.bfloat16()
    cases["K8 bf16"] = [k8_case(torch, kd, bounds, ops, pts16, cache, md_in,
                                picks[:, :1].bfloat16(), mask)
                        for mask in ("gate", "all")]
    del cache, md_in, picks
    cache = bounds.RoundCache(*kd.seed_prologue_batched(
        pts, ops.choose_block_n(n, d, k)))
    cases["K10b"] = k10b_case(torch, la, kd, bounds, ops, pts, cache, k, gen)
    cases["K10b bf16"] = k10b_case(torch, la, kd, bounds, ops, pts16, cache,
                                   k, gen, only=("gate",))
    del cache, pts16
    torch.cuda.empty_cache()
    for name, cs in cases.items():
        if name.endswith("bf16"):
            for c in cs:
                print_bf16(name.split()[0], c)
            continue
        for c in cs:
            print(f"{name} B={c['batch']} n={c['n']} d={c['d']}"
                  + (f" m={c['m']}" if "m" in c else "")
                  + (f" k={c['k']} tps={c['tps']}" if "k" in c else "")
                  + (f" mask={c['mask']}: {c['active_tiles']}/{c['tiles']} "
                     f"tiles active, {c['pruned']} rows pruned"
                     if "mask" in c else "")
                  + f": err {c['max_abs_err']:.3g} (tol {c['tol']:.3g}), "
                  + ("every problem" if name == "K10b" else "rows 0, 1, B-1")
                  + " bitwise the single kernel; "
                  f"{c['ms']:.4f} ms, plain "
                  + (f"{c['plain_ms']:.4f} ms" if c["plain_ms"] is not None
                     else "not timed")
                  + f", bound {c['bound_ms']:.4f} ms ({c['bound_by']})"
                  + screen_text(c))
    c = cases["K1b"][0]
    print(f"  K1b ({c['route']} route) bitwise the batched template entry; "
          f"{c['ms']:.4f} ms (again {c['ms_again']:.4f}; template entry "
          f"{c['template_ms']:.4f} ms)")
    eng = ClusterEngine(device="cuda")
    ungated = ClusterEngine(device="cuda", bounds=False)
    runs = []
    for layout, pts in layouts:
        bsz = pts.shape[0]
        for sampler in ("cdf", "tiled"):
            what = f"gated kmeans_batched[{sampler}, {layout}]"
            draws = Draws.sample_batched(
                bsz, n, k, generator=torch.Generator().manual_seed(0),
                device=dev)
            kw = dict(draws=draws, sampler=sampler, max_iters=cfg.max_iters)
            res, total_s, got = counted(
                torch, ops, lambda: eng.kmeans_batched(pts, k, **kw))
            for name in launches:
                launches[name] += got[name]
            iters = int(res.n_iters.max())
            want = {name: 0 for name in got}
            want.update(seed_prologue_batched=2,
                        distance_min_update_gated_batched=k,
                        lloyd_assign_gated_batched=iters)
            check(got == want, f"{what}: launches {got}, want {want}")
            check(tuple(res.centroids.shape) == (bsz, k, d)
                  and tuple(res.assignment.shape) == (bsz, n)
                  and tuple(res.skipped.shape) == (bsz, cfg.max_iters)
                  and bool(torch.isfinite(res.centroids).all())
                  and bool(torch.isfinite(res.inertia).all())
                  and int(res.assignment.min()) >= 0
                  and int(res.assignment.max()) < k
                  and int(res.n_iters.min()) >= 1 and iters <= cfg.max_iters,
                  f"{what}: output malformed")
            off, off_s, _ = counted(
                torch, ops, lambda: ungated.kmeans_batched(pts, k, **kw))
            check(same_fit(torch, res, off),
                  f"{what}: not bitwise the bounds=False kmeans_batched")
            again = eng.kmeans_batched(pts, k, **kw)
            check(same_fit(torch, again, res)
                  and torch.equal(again.skipped, res.skipped)
                  and torch.equal(again.pruned, res.pruned),
                  f"{what}: two runs differ")
            seeds, seed_s, _ = counted(torch, ops, lambda: eng.seed_batched(
                pts, k, draws=draws, sampler=sampler))
            fit, fit_s, _ = counted(torch, ops, lambda: eng.fit_batched(
                pts, seeds.centroids, max_iters=cfg.max_iters))
            check(same_fit(torch, fit, res)
                  and torch.equal(fit.skipped, res.skipped),
                  f"{what}: not seed_batched then fit_batched")
            oseeds, oseed_s, _ = counted(
                torch, ops, lambda: ungated.seed_batched(
                    pts, k, draws=draws, sampler=sampler))
            check(same_seeds(torch, seeds, oseeds),
                  f"{what}: seeds not bitwise the bounds=False seeds")
            for b in (0, 1, bsz - 1):
                one = eng.seed(pts[b], k, draws=draws[b], sampler=sampler)
                check(same_seeds(torch, one, row(seeds, b))
                      and torch.equal(one.skipped, seeds.skipped[b])
                      and torch.equal(one.pruned, seeds.pruned[b]),
                      f"{what}: problem {b}'s seeds or seeding counters are "
                      "not the single gated seeding's")
                single = eng.fit(pts[b], one.centroids,
                                 max_iters=cfg.max_iters)
                check(same_fit(torch, single, row(res, b))
                      and torch.equal(single.skipped, res.skipped[b])
                      and torch.equal(single.pruned, res.pruned[b]),
                      f"{what}: problem {b} is not the single gated seed + "
                      "fit, counters included")
            run = dict(layout=layout, sampler=sampler, batch=bsz,
                       kmeans_batched_s=total_s,
                       ungated_kmeans_batched_s=off_s,
                       seed_ms=seed_s * 1e3, ungated_seed_ms=oseed_s * 1e3,
                       lloyd_ms_per_iter=fit_s * 1e3 / iters,
                       n_iters_max=iters, n_iters_min=int(res.n_iters.min()),
                       seed_skipped=int(seeds.skipped.sum()),
                       seed_pruned=int(seeds.pruned.sum()),
                       fit_skipped=int(res.skipped.sum()),
                       fit_pruned=int(res.pruned.sum()),
                       ms_per_problem=total_s * 1e3 / bsz, launches=got,
                       bitwise_ungated=True, repeat_bitwise=True,
                       rows_bitwise_single=True)
            if layout == "sorted":
                check(run["seed_skipped"] > 0,
                      f"{what}: the tile gate skipped nothing on sorted rows")
            runs.append(run)
            print(f"{what} at {cfg.name} (B={bsz}, n={n}, d={d}, k={k}): "
                  f"{total_s:.3f} s gated, {off_s:.3f} s ungated end to end "
                  f"(bitwise equal); seeding {run['seed_ms']:.1f} ms gated / "
                  f"{run['ungated_seed_ms']:.1f} ms ungated, Lloyd "
                  f"{run['lloyd_ms_per_iter']:.2f} ms/iter ({iters} "
                  f"iterations, min {run['n_iters_min']}); seeding skipped "
                  f"{run['seed_skipped']} tiles, pruned {run['seed_pruned']} "
                  f"rows; Lloyd skipped {run['fit_skipped']} tiles, pruned "
                  f"{run['fit_pruned']} rows; launches "
                  f"{ {n_: c for n_, c in got.items() if c} }")
    return cases, runs


def listed_round_cases(torch, kd, bounds, ops, sampling, pts, gen) -> dict:
    """The problem-list forms of K7 and K8 at the batched shape, over an
    unsorted list of every eighth problem, against a pending block of 8
    centroids (the refresh rejection seeding runs): each listed problem's
    carries bitwise the full-batch launch's, every other problem's
    untouched (K8's pruned counts 0 there), the listed rows within tolerance
    of the plain twin on those problems, two launches bitwise; an empty
    list launches nothing. Timed (CUDA events, in place) beside the full
    batch; the bound from the listed problems' bytes."""
    bsz, n, d = pts.shape
    dev = pts.device
    bn = ops.choose_block_n(n, d, 1)
    cache = bounds.RoundCache(*kd.seed_prologue_batched(pts, bn))
    rows = torch.randint(n, (bsz, 16, 1), generator=gen, device=dev)
    picks = torch.take_along_dim(pts, rows, dim=1)
    md = kd.distance_min_update_batched(
        pts, cache.norms, picks[:, 8:].contiguous(),
        torch.full((bsz, n), torch.inf, device=dev), block_n=bn)[0]
    cents = picks[:, :8].contiguous()
    parts = sampling.tile_partials(md, bn)
    tmax = bounds.tile_reduce_max(md, bn)
    act, dc, margin = bounds.seed_gate(cents, cache, tmax)
    perm = torch.randperm(bsz, generator=torch.Generator().manual_seed(0))
    lst = perm[: max(bsz // 8, 1)].to(torch.int32).to(dev)
    rows_l = lst.long()
    off = torch.ones(bsz, dtype=torch.bool, device=dev)
    off[rows_l] = False
    tol = d2_tol(torch, cache.norms, cents.reshape(-1, d))
    t = act.shape[-1]
    xb = pts.element_size()
    r = lst.numel()
    cases = {}
    for name, gated in (("K7", False), ("K8", True)):
        if gated:
            full = kd.distance_min_update_gated_batched(
                pts, cache.norms, cents, md, cache.center_d, dc, margin,
                parts, tmax, act, block_n=bn)

            def listed(carries, problems=lst):
                return kd.distance_min_update_gated_batched(
                    pts, cache.norms, cents, carries[0], cache.center_d, dc,
                    margin, carries[1], carries[2], act, block_n=bn,
                    problems=problems)
            old = (md, parts, tmax)
        else:
            full = kd.distance_min_update_batched(pts, cache.norms, cents,
                                                  md, block_n=bn)

            def listed(carries, problems=lst):
                return kd.distance_min_update_batched(
                    pts, cache.norms, cents, carries[0], block_n=bn,
                    problems=problems, partials=carries[1])
            old = (md, parts)
        carries = tuple(x.clone() for x in old)
        ops.reset_launches()
        out = listed(carries)
        twice = tuple(x.clone() for x in old)
        listed(twice)
        empty = tuple(x.clone() for x in old)
        listed(empty, lst[:0])
        counted = sum(ops.LAUNCHES.values())
        torch.cuda.synchronize()
        what = f"{name} over {r} of {bsz} problems"
        check(counted == 2, f"{what}: {counted} launches counted, want 2")
        check(all(torch.equal(a, b) for a, b in zip(carries, twice)),
              f"{what}: two launches differ")
        check(all(torch.equal(a, b) for a, b in zip(empty, old)),
              f"{what}: an empty list changed a carry")
        check(all(out[i] is carries[i] for i in range(len(carries))),
              f"{what}: not written in place")
        for got, want, before in zip(carries, full, old):
            check(bits_equal(torch, got[rows_l], want[rows_l])
                  and bits_equal(torch, got[off], before[off]),
                  f"{what}: the listed rows are not the full launch's, or "
                  "a problem off the list moved")
        if gated:
            check(torch.equal(out[3][rows_l], full[3][rows_l])
                  and not bool(out[3][off].any()),
                  f"{what}: pruned counts")
            sub = [x[rows_l] for x in (pts, cache.norms, cents, md,
                                       cache.center_d, dc, margin, parts,
                                       tmax, act)]
            twin_fn = kd.distance_min_update_gated_batched_torch
        else:
            sub = [x[rows_l] for x in (pts, cache.norms, cents, md)]
            twin_fn = kd.distance_min_update_batched_torch
        twin = twin_fn(*sub, block_n=bn)
        err = float((carries[0][rows_l] - twin[0]).abs().max())
        check(err <= tol, f"{what}: min_d2 err {err} > {tol}")
        check(bool(((carries[1][rows_l] - twin[1]).abs()
                    <= partial_tol(tol, bn, twin[1])).all()),
              f"{what}: partials outside tolerance")
        ms = gpu_ms(torch, lambda: listed(carries), reps=5)
        full_ms = gpu_ms(torch, (lambda: kd.distance_min_update_gated_batched(
            pts, cache.norms, cents, md, cache.center_d, dc, margin, parts,
            tmax, act, block_n=bn)) if gated else (
            lambda: kd.distance_min_update_batched(pts, cache.norms, cents,
                                                   md, block_n=bn)), reps=5)
        plain = gpu_ms(torch, lambda: twin_fn(*sub, block_n=bn), reps=1,
                       warmup=0)
        if gated:
            rows_act = int(bounds.expand_mask(act[rows_l], bn, n).sum())
            fresh = rows_act - int(out[3][rows_l].sum())
            bms, by = round_bound_ms(
                torch, pts, xb * (fresh * d + r * 8 * d)
                + 4 * (3 * rows_act + fresh + 7 * r * t),
                fresh * 8 * 2 * d, fresh * 8 * 3 + rows_act * 6)
        else:
            bms, by = round_bound_ms(
                torch, pts, r * (xb * (n * d + 8 * d) + 4 * (3 * n + 2 * t)),
                r * n * 8 * 2 * d, r * n * 8 * 3)
        cases[name] = dict(batch=bsz, listed=r, n=n, d=d, m=8, block_n=bn,
                           max_abs_err=err, tol=tol, ms=ms, full_ms=full_ms,
                           plain_ms=plain, bound_ms=bms, bound_by=by)
        print(f"{name} listed: {r} of {bsz} problems (unsorted), m=8: the "
              f"listed carries bitwise the full launch, the rest untouched, "
              f"err {err:.3g} (tol {tol:.3g}); {ms:.4f} ms (the full batch "
              f"{full_ms:.4f} ms), plain {plain:.4f} ms, bound {bms:.4f} ms "
              f"({by})")
    return cases


def batched_rejection_kernel_cases(torch, kd, bounds, ops, sampling, pts,
                                   gen, attempts=8, p=8) -> dict:
    """The batched K11 (every problem's ``attempts`` drawn rows, one warp a
    row) and K12 (the tile envelope of every problem) at the batched shape,
    against (B, p, d) pending blocks with counts 0..p (every eighth problem
    at 0): bitwise their twins, a second launch, and the single launch on
    problems 0, 1 and B−1 (K12 at count 0: +inf caps, ph = partials, no
    tight tile). Timed (CUDA events) beside the twins; bounds from bytes
    and operations."""
    bsz, n, d = pts.shape
    dev = pts.device
    bn = ops.choose_block_n(n, d, 1)
    _, centers, radii, _ = kd.seed_prologue_batched(pts, bn)
    t = centers.shape[1]
    idx = torch.randint(n, (bsz, attempts), generator=gen, device=dev)
    pend = torch.take_along_dim(pts, torch.randint(
        n, (bsz, p, 1), generator=gen, device=dev), dim=1).contiguous()
    cnt = (torch.arange(bsz, device=dev) % (p + 1)).to(torch.int32)
    cnt[::8] = 0
    tile_w = sampling.tile_partials(torch.ones(n, device=dev), bn)
    parts = kd.tile_cap_torch(centers, radii, pend[:, :1], torch.ones(
        bsz, dtype=torch.int32, device=dev)) * tile_w
    got11 = kd.row_min_d2(pts, idx, pend, cnt)
    env = kd.tile_envelope(centers, radii, pend, cnt, parts, tile_w)
    check(bits_equal(torch, got11, kd.row_min_d2(pts, idx, pend, cnt))
          and bits_equal(torch, got11, kd.row_min_d2_torch(pts, idx, pend,
                                                           cnt)),
          "batched K11: not bitwise its twin or a second launch")
    check(all(bits_equal(torch, a, b) for a, b in zip(
        env, kd.tile_envelope(centers, radii, pend, cnt, parts, tile_w)))
          and all(bits_equal(torch, a, b) for a, b in zip(
              env, kd.tile_envelope_torch(centers, radii, pend, cnt, parts,
                                          tile_w))),
          "batched K12: not bitwise its twin or a second launch")
    for b in (0, 1, bsz - 1):
        check(bits_equal(torch, got11[b], kd.row_min_d2(
            pts[b], idx[b], pend[b], cnt[b])),
              f"batched K11: problem {b} is not the single launch")
        one = kd.tile_envelope(centers[b], radii[b], pend[b], cnt[b],
                               parts[b], tile_w)
        check(all(bits_equal(torch, u[b], v) for u, v in zip(env, one)),
              f"batched K12: problem {b} is not the single launch")
    check(bool(torch.isinf(env[0][0]).all()) and torch.equal(env[1][0],
                                                              parts[0])
          and not bool(env[2][0].any()) and int(env[3][0]) == 0,
          "batched K12: a problem at count 0 is not the +inf envelope")
    key = ("tile_envelope", torch.cuda.current_device(),
           torch.cuda.current_stream().cuda_stream)
    check(int(ops.arrivals(key, 2 * bsz).abs().sum()) == 0,
          "batched K12: arrival counters not back at 0")
    ms11, plain11 = timed(torch, lambda: kd.row_min_d2(pts, idx, pend, cnt),
                          lambda: kd.row_min_d2_torch(pts, idx, pend, cnt))
    ms12, plain12 = timed(
        torch, lambda: kd.tile_envelope(centers, radii, pend, cnt, parts,
                                        tile_w),
        lambda: kd.tile_envelope_torch(centers, radii, pend, cnt, parts,
                                       tile_w))
    live = int(cnt.clamp(max=p).sum())
    b11, by11 = bound_ms(bsz * (4 * (attempts * (d + 1) + p * d) + 8
                                * attempts + 4), attempts * live * 3 * d)
    b12, by12 = bound_ms(bsz * (4 * (t * (d + 1) + p * d + 3 * t) + 9 * t
                                + 8), t * (live * 3 * d + 6 * bsz))
    out = {"K11": dict(batch=bsz, n=n, d=d, p=p, a=attempts, ms=ms11,
                       plain_ms=plain11, bound_ms=b11, bound_by=by11,
                       max_abs_err=0.0),
           "K12": dict(batch=bsz, n=n, d=d, p=p, tiles=t, ms=ms12,
                       plain_ms=plain12, bound_ms=b12, bound_by=by12,
                       zero_counts=int((cnt == 0).sum()), max_abs_err=0.0)}
    for name, c in out.items():
        print(f"{name} batched: B={bsz} d={d} P={p}"
              + (f" A={attempts}" if name == "K11" else f" tiles={t}")
              + f", {out['K12']['zero_counts']} problems at count 0: bitwise "
              f"the twin, a second launch and the single launch on problems "
              f"0, 1, B-1; {c['ms']:.4f} ms, plain {c['plain_ms']:.4f} ms, "
              f"bound {c['bound_ms']:.6f} ms ({c['bound_by']})")
    return out


def schedule_of(accepts, k: int, p: int) -> dict:
    """A batched rejection seeding's launches from its (B, k) accepts: the
    listed refresh launches (one a round where some problem's block filled,
    one a round where some problem's attempts all rejected, and the
    settle), the rounds starting with some live pending centroid (the
    batched K12's, under hier with the tile balls), and the problem-
    refreshes summed over rounds."""
    bsz = len(accepts)
    counts = [p - 1] * bsz
    launches = live = total = 0
    for m in range(1, k):
        counts = [c + 1 for c in counts]
        due = [b for b in range(bsz) if counts[b] >= p]
        for b in due:
            counts[b] = 0
        live += any(counts)
        failed = [b for b in range(bsz) if not accepts[b][m]]
        for b in failed:
            counts[b] = 0
        launches += bool(due) + bool(failed)
        total += len(due) + len(failed)
    return dict(launches=launches + 1, live_rounds=live,
                problem_refreshes=total + bsz)


def count_syncs(torch, fn) -> int:
    """Host syncs ``fn()`` makes: the operations torch's sync debug mode
    reports as synchronizing (reads of device values, pageable copies)."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode(1)
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in caught)


def batched_rejection_phase(torch, ops, kd, bounds, sampling, ClusterEngine,
                            CudaBackend, Draws, layouts, cfg, dev, launches,
                            gen, p=8) -> tuple[dict, list]:
    """Phase 6 (rejection): the problem-list forms of K7 and K8 and the
    batched K11 and K12 against their twins, then batched rejection
    seeding (``kmeans_batched(sampler="rejection")``, the reference's
    defaults: refresh_block 8, hier, 8 attempts), gated and ungated, on the
    first ``(name, points)`` of ``layouts``: counted (the listed refresh,
    K11 and K12 launches the seeding's own accepts call for; the batched K1
    once per phase and K10b/K10a once per iteration), each problem's
    refreshes (recorded from the listed launches) the count its single
    seeding makes, rows 0, 1 and B−1 bitwise their single seedings
    (counters included), two runs bitwise, ``kmeans_batched`` bitwise
    ``seed_batched`` then ``fit_batched``; host syncs counted; seconds,
    device busy time and idle share beside the batched cdf and tiled
    seedings; the fit's inertia over the cdf fit's. Then every problem of
    the other layouts bitwise its single gated seeding."""
    pts = layouts[0][1]
    bsz, n, d = pts.shape
    k = cfg.k
    cases = {f"{name} listed": [c] for name, c in listed_round_cases(
        torch, kd, bounds, ops, sampling, pts, gen).items()}
    cases.update({f"{name} batched": [c] for name, c in
                  batched_rejection_kernel_cases(
                      torch, kd, bounds, ops, sampling, pts, gen).items()})
    torch.cuda.empty_cache()
    seen = []

    class Recording(CudaBackend):
        """The card backend, recording each listed round's problems."""

        def seed_round_listed(self, *args, problems, **kw):
            seen.append(problems.clone())
            return super().seed_round_listed(*args, problems=problems, **kw)

    fields = ("centroids", "indices", "min_d2", "skipped", "pruned",
              "proposals", "accepts", "tightened", "supers")

    def same(a, b, b_=None):
        return all((getattr(a, f) is None and getattr(b, f) is None)
                   or bits_equal(torch, getattr(a, f) if b_ is None
                                 else getattr(a, f)[b_], getattr(b, f))
                   for f in fields)

    draws = Draws.sample_batched(bsz, n, k, device=dev, max_attempts=8,
                                 generator=torch.Generator().manual_seed(0))
    cdf_fit = ClusterEngine(device="cuda").kmeans_batched(
        pts, k, draws=draws, sampler="cdf", max_iters=cfg.max_iters)
    runs = []
    for gated in (True, False):
        t_mode = time.perf_counter()
        tag = "gated" if gated else "ungated"
        what = f"{tag} kmeans_batched[rejection]"
        eng = ClusterEngine(device="cuda", bounds=gated)
        kw = dict(draws=draws, sampler="rejection")
        res, total_s, got = counted(torch, ops, lambda: eng.kmeans_batched(
            pts, k, max_iters=cfg.max_iters, **kw))
        for name in launches:
            launches[name] += got[name]
        # the seeding again, its listed rounds' problems recorded
        seen.clear()
        seeds, seed_s, sgot = counted(torch, ops, lambda: ClusterEngine(
            Recording(), device="cuda", bounds=gated).seed_batched(
                pts, k, **kw))
        acc = seeds.accepts.tolist()
        sched = schedule_of(acc, k, p)
        listed = ("distance_min_update_gated_batched" if gated
                  else "distance_min_update_batched")
        want = {name: 0 for name in sgot}
        want.update({listed: sched["launches"], "row_min_d2": k - 1,
                     "tile_cap": sched["live_rounds"] if gated else 0,
                     "seed_prologue_batched": int(gated)})
        check(sgot == want, f"{what}: seeding launches "
              f"{ {n_: c for n_, c in sgot.items() if c} }, want "
              f"{ {n_: c for n_, c in want.items() if c} }")
        iters = int(res.n_iters.max())
        want.update({"seed_prologue_batched": 2 * int(gated),
                     ("lloyd_assign_gated_batched" if gated
                      else "lloyd_assign_tiled_batched"): iters})
        check(got == want, f"{what}: launches "
              f"{ {n_: c for n_, c in got.items() if c} }, want "
              f"{ {n_: c for n_, c in want.items() if c} }")
        check(tuple(res.centroids.shape) == (bsz, k, d)
              and bool(torch.isfinite(res.centroids).all())
              and bool(torch.isfinite(res.inertia).all())
              and int(res.assignment.min()) >= 0
              and int(res.assignment.max()) < k
              and int(seeds.indices.min()) >= 0
              and int(seeds.indices.max()) < n
              and bool((seeds.proposals[:, 0] == 0).all())
              and bool((seeds.proposals[:, 1:] >= 1).all())
              and bool((seeds.proposals[:, 1:] <= 8).all()),
              f"{what}: output or rejection counters malformed")
        fit = eng.fit_batched(pts, seeds.centroids, max_iters=cfg.max_iters)
        check(same_fit(torch, fit, res),
              f"{what}: not seed_batched then fit_batched")
        per = torch.bincount(torch.cat(seen).long(),
                             minlength=bsz).tolist()
        check(len(seen) == sched["launches"]
              and per == [refreshes(a, k, p) for a in acc],
              f"{what}: a problem's refreshes are not the count its "
              "accepts call for")
        again = []
        syncs = count_syncs(torch, lambda: again.append(eng.seed_batched(
            pts, k, **kw)))
        check(same(again[0], seeds), f"{what}: two seedings differ")
        del again
        t_single = time.perf_counter()
        for b in (0, 1, bsz - 1):
            ops.reset_launches()
            one = eng.seed(pts[b], k, draws=draws[b], sampler="rejection")
            single = ops.LAUNCHES["distance_min_update_gated" if gated
                                  else "distance_min_update"]
            check(same(seeds, one, b) and single == per[b],
                  f"{what}: problem {b} is not its single rejection "
                  f"seeding (counters included), or its refreshes "
                  f"({per[b]}) not the single seeding's ({single})")
        single_s = (time.perf_counter() - t_single) / 3
        single_syncs = count_syncs(torch, lambda: eng.seed(
            pts[0], k, draws=draws[0], sampler="rejection"))
        times = {}
        for s_ in ("rejection", "cdf", "tiled"):
            def fn(s_=s_):
                return eng.seed_batched(pts, k, draws=draws, sampler=s_)
            if s_ == "rejection":
                host_s = seed_s
            else:
                fn()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                host_s = time.perf_counter() - t0
            prof = profile_call(torch, fn, cpu=False)
            times[s_] = dict(s=host_s, busy_ms=prof["busy_ms"],
                             idle_share=prof["idle_share"],
                             profiled_wall_ms=prof["wall_ms"],
                             top=dict(list(prof["kernels"].items())[:6]))
        ratio = float(res.inertia.double().sum()
                      / cdf_fit.inertia.double().sum())
        per_problem = (res.inertia / cdf_fit.inertia).median().item()
        run = dict(gated=gated, batch=bsz, n=n, d=d, k=k,
                   kmeans_batched_s=total_s, seed_s=seed_s,
                   n_iters_max=iters, launches=got, seed_launches=sgot,
                   listed_launches=sched["launches"],
                   k12_rounds=sched["live_rounds"],
                   problem_refreshes=sum(per),
                   refreshes_min=min(per), refreshes_max=max(per),
                   exact_fallbacks=int((seeds.accepts[:, 1:] == 0).sum()),
                   host_syncs=syncs, syncs_per_round=syncs / (k - 1),
                   single_s=single_s, single_syncs=single_syncs,
                   times=times, inertia_over_cdf=ratio,
                   inertia_over_cdf_median=per_problem,
                   rows_bitwise_single=True, repeat_bitwise=True)
        runs.append(run)
        print(f"{what} at {cfg.name} (B={bsz}, n={n}, d={d}, k={k}, "
              f"refresh_block {p}, hier): {total_s:.3f} s end to end, "
              f"seeding {seed_s:.3f} s counted; launches a seeding: "
              f"{listed} {sched['launches']}, K11 {k - 1}, K12 "
              f"{want['tile_cap']}; problem-refreshes {sum(per)} (per "
              f"problem {min(per)}-{max(per)}, each its single seeding's; "
              f"{run['exact_fallbacks']} exact fallbacks); host syncs "
              f"{syncs} ({run['syncs_per_round']:.3f} a round; a single "
              f"seeding {single_syncs} in {single_s:.3f} s); fit inertia "
              f"over the cdf seeds' fit {ratio:.6f} (median per problem "
              f"{per_problem:.6f}); {time.perf_counter() - t_mode:.1f} s "
              "of checks")
        for s_, tm in times.items():
            print(f"  {tag} seed_batched[{s_}]: {tm['s']:.4f} s host clock, "
                  f"device busy {tm['busy_ms']:.2f} ms, idle share "
                  f"{tm['idle_share']:.3f} (profiled wall "
                  f"{tm['profiled_wall_ms']:.1f} ms); "
                  + ", ".join(f"{nm[:40]} {v['ms']:.2f} ms x{v['count']}"
                              for nm, v in list(tm["top"].items())[:4]))
    eng = ClusterEngine(device="cuda")
    for layout, lp in layouts[1:]:
        b2 = lp.shape[0]
        dr = Draws.sample_batched(b2, n, k, device=dev, max_attempts=8,
                                  generator=torch.Generator().manual_seed(1))
        res = eng.seed_batched(lp, k, draws=dr, sampler="rejection")
        for b in range(b2):
            one = eng.seed(lp[b], k, draws=dr[b], sampler="rejection")
            check(same(res, one, b), f"gated seed_batched[rejection, "
                  f"{layout}]: problem {b} is not its single seeding")
        syncs = count_syncs(torch, lambda: eng.seed_batched(
            lp, k, draws=dr, sampler="rejection"))
        runs.append(dict(layout=layout, batch=b2, host_syncs=syncs,
                         seed_skipped=int(res.skipped.sum()),
                         tightened=int(res.tightened.sum()),
                         rows_bitwise_single=True))
        print(f"gated seed_batched[rejection, {layout}] ({b2} problems): "
              f"every problem bitwise its single seeding; skipped "
              f"{runs[-1]['seed_skipped']} tiles, tightened "
              f"{runs[-1]['tightened']}; host syncs {syncs}")
    return cases, runs


def untiled_times(torch, launch, template, args, kw, reps) -> dict:
    """K4's or K9's route beside the template entry: each launch's median
    time (CUDA events), and the route's device time by kernel, a launch's
    mean over ``reps`` launches traced by torch.profiler (pass A or the row
    pass, pass B and the all-tile reduce; the template's two kernels where
    the route is the template)."""
    out = {"ms": gpu_ms(torch, lambda: launch(*args, **kw), reps=reps),
           "template_ms": gpu_ms(torch, lambda: template(*args, **kw),
                                 reps=min(reps, 5))}
    prof = profile_call(torch, lambda: [launch(*args, **kw)
                                        for _ in range(reps)])
    out["parts_ms"] = {}
    for name, v in prof["kernels"].items():
        m = re.search(r"((?:untiled_row|screen|reduce|super_reduce|"
                      r"chain_reduce|assign_tile|centroid_norms)_kernel)"
                      r"(<[^()]*>)?", name)
        if m:
            part = m.group(1) + (m.group(2) or "")
            out["parts_ms"][part] = v["ms"] / reps
    return out


def untiled_text(c: dict) -> str:
    parts = ", ".join(f"{name} {ms:.4f}" for name, ms in
                      c["parts_ms"].items())
    return (f"{c['route']}, bitwise the template entry; {c['ms']:.4f} ms "
            f"(template entry {c['template_ms']:.4f} ms; by kernel, "
            f"profiler: {parts})")


def k4_case(torch, la, ops, bounds, pts, norms, k, gen, w=None):
    """K4 on one shape, weighted or not: two launches bitwise, and bitwise
    the template entry (``lloyd_assign_template``) in all four outputs;
    against its plain twin (labels outside near-ties, D² within tolerance,
    sums and counts over its own labels as ``super_sums_ok`` holds them),
    labels and D² bitwise K3's on the same points and centroids; times
    (the route, the template entry, the route's kernels by the profiler),
    the screen's counters where it is screened, and the bound."""
    n, d = pts.shape
    bn = ops.choose_block_n(n, d, k)
    cents = pts[torch.randint(n, (k,), generator=gen,
                              device=pts.device)].contiguous()
    tag = f"K4 n={n} d={d} k={k}" + ("" if w is None else " weighted")
    out1 = la.lloyd_assign(pts, norms, cents, w, block_n=bn)
    out2 = la.lloyd_assign(pts, norms, cents, w, block_n=bn)
    stats = screen_record(la, "lloyd_assign", pts, torch)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(out1, out2)),
          f"{tag}: two launches differ")
    same_bits(torch, f"{tag} vs the template entry", out1,
              la.lloyd_assign_template(pts, norms, cents, w, block_n=bn))
    lab, md, sums, counts = out1
    ref = la.lloyd_assign_torch(pts, norms, cents, w)
    tol = d2_tol(torch, norms, cents)
    n_diff, bad = label_diffs(torch, la.tile_d2(pts, cents, norms), lab,
                              ref[0], tol)
    check(bad == 0, f"{tag}: {bad} labels differ beyond near-ties")
    err_md = float((md - ref[1]).abs().max())
    check(err_md <= tol, f"{tag}: min_d2 err {err_md} > {tol}")
    check(super_sums_ok(torch, pts, lab, sums[None], counts[None], n, w=w),
          f"{tag}: sums or counts outside tolerance")
    k3 = la.lloyd_assign_tiled(pts, norms, cents, block_n=bn,
                               tps=bounds.tiles_per_super(-(-n // bn)))
    check(torch.equal(lab, k3[0]) and torch.equal(md, k3[1]),
          f"{tag}: labels or D² are not bitwise K3's")
    fp32_ms = widened(torch, tag, lambda p, c: la.lloyd_assign(
        p, norms, c, w, block_n=bn), pts, cents, out1)
    scr = la.screened(d, pts.dtype == torch.bfloat16)
    times = untiled_times(torch, la.lloyd_assign,
                          la.lloyd_assign_template, (pts, norms, cents, w),
                          dict(block_n=bn), 15)
    plain = gpu_ms(torch, lambda: la.lloyd_assign_torch(pts, norms, cents,
                                                        w), reps=5)
    nw = 0 if w is None else n
    xb = pts.element_size()
    work = (xb * (n * d + k * d) + 4 * (3 * n + nw + k * (d + 1)),
            n * k * 2 * d, n * k * 3 + n * (d + 1) + nw * d)
    bms, by = round_bound_ms(torch, pts, *work, tf32=scr)
    if scr:
        stats["fma_bound_ms"] = round_bound_ms(torch, pts, *work)[0]
    return dict(n=n, d=d, k=k, weighted=w is not None, block_n=bn,
                stream=stream_tag(torch, pts),
                route=("screened" if scr else "row pass" if d == 2
                       else "template"),
                label_diffs=n_diff, max_abs_err=err_md, tol=tol,
                plain_ms=plain, fp32_ms=fp32_ms, bound_ms=bms, bound_by=by,
                **times, **stats)


def k9_case(torch, la, kd, ops, pts, norms, k, gen):
    """K9 at the batched shape: two launches bitwise, and bitwise the
    template entry (``lloyd_assign_batched_template``) in all four outputs,
    so on every problem; against its plain twin (as K4), rows 0, 1 and B−1
    bitwise K4 on their problem; times (the route, the template entry, the
    route's kernels by the profiler), the screen's counters and the
    bound."""
    bsz, n, d = pts.shape
    bn = ops.choose_block_n(n, d, k)
    idx = torch.randint(n, (bsz, k, 1), generator=gen, device=pts.device)
    cents = torch.take_along_dim(pts, idx, dim=1).contiguous()
    out1 = la.lloyd_assign_batched(pts, norms, cents, block_n=bn)
    out2 = la.lloyd_assign_batched(pts, norms, cents, block_n=bn)
    stats = screen_record(la, "lloyd_assign_batched", pts, torch)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(out1, out2)),
          f"K9 k={k}: two launches differ")
    same_bits(torch, f"K9 k={k} vs the template entry (every problem)",
              out1, la.lloyd_assign_batched_template(pts, norms, cents,
                                                     block_n=bn))
    lab, md, sums, counts = out1
    ref = la.lloyd_assign_batched_torch(pts, norms, cents)
    tol = d2_tol(torch, norms, cents.reshape(-1, d))
    n_diff, bad = map(sum, zip(*(
        label_diffs(torch, kd.tile_d2(pts[b], cents[b], norms[b]), lab[b],
                    ref[0][b], tol) for b in range(bsz))))
    check(bad == 0, f"K9 k={k}: {bad} labels differ beyond near-ties")
    err_md = float((md - ref[1]).abs().max())
    check(err_md <= tol, f"K9 min_d2 err {err_md} > {tol}")
    s_of = torch.arange(bsz, device=pts.device).repeat_interleave(n)
    check(super_sums_ok(torch, pts.reshape(-1, d), lab.reshape(-1), sums,
                        counts, n, s_of=s_of),
          f"K9 k={k}: sums or counts outside tolerance")
    for b in (0, 1, bsz - 1):
        single = la.lloyd_assign(pts[b], norms[b], cents[b], block_n=bn)
        check(all(torch.equal(u[b], v) for u, v in zip(out1, single)),
              f"K9 k={k}: problem {b} is not bitwise K4 on its slice")
    fp32_ms = widened(torch, f"K9 k={k}", lambda p, c: (
        la.lloyd_assign_batched(p, norms, c, block_n=bn)), pts, cents, out1,
        reps=5)
    scr = la.screened(d, pts.dtype == torch.bfloat16)
    times = untiled_times(torch, la.lloyd_assign_batched,
                          la.lloyd_assign_batched_template,
                          (pts, norms, cents), dict(block_n=bn), 5)
    plain = gpu_ms(torch, lambda: la.lloyd_assign_batched_torch(
        pts, norms, cents), reps=1, warmup=0)
    xb = pts.element_size()
    work = (bsz * (xb * (n * d + k * d) + 4 * (3 * n + k * (d + 1))),
            bsz * n * k * 2 * d, bsz * (n * k * 3 + n * (d + 1)))
    bms, by = round_bound_ms(torch, pts, *work, tf32=scr)
    if scr:
        stats["fma_bound_ms"] = round_bound_ms(torch, pts, *work)[0]
    return dict(batch=bsz, n=n, d=d, k=k, block_n=bn,
                stream=stream_tag(torch, pts),
                route="screened" if scr else "template",
                label_diffs=n_diff, max_abs_err=err_md, tol=tol,
                plain_ms=plain, fp32_ms=fp32_ms, bound_ms=bms, bound_by=by,
                **times, **stats)


def weighted_phase(torch, ops, kd, la, bounds, ClusterEngine, Draws, paper,
                   paper_np, wts, kvq_pts, full, kvq, dev, launches, gen,
                   batch_rows=262_144):
    """Phase 7: K4 (weighted and not) and K9 against their plain twins; K9's
    path (``ops.lloyd_assign`` on the sweep's (B, n, d) points, the rows
    coded against the fitted codebooks); the weighted ``kmeans`` at
    ``full`` for cdf, tiled and rejection (hier, flat), counted (K1 once,
    K2 once per round or refresh, K11/K12 as phase 4, K4 once per
    iteration, no K3/K5/K6), bitwise a second run and, but for hier (whose
    envelope tightens only with the tile balls), the ``bounds=False`` run,
    and within 1e-4 of the plain twins' fit from the same seeds; then
    ``fit_minibatch`` over ``full`` streamed from the host array in batches
    of ``batch_rows`` rows, one pass, counted (K4 once per batch), bitwise
    a second run, with its time per batch, its host-to-device copies and
    device busy time from the profiler, and its inertia over all of
    ``full`` against the full-batch (unweighted) fit's from the same
    seeds."""
    k, n = full.k, full.n_points
    cases = {"K4": [], "K9": []}
    norms = bounds.point_norms(paper)
    for w in (None, wts):
        cases["K4"].append(k4_case(torch, la, ops, bounds, paper, norms, k,
                                   gen, w))
    wide = torch.rand((100_003, 128), generator=gen, device=dev)
    cases["K4"].append(k4_case(torch, la, ops, bounds, wide,
                               bounds.point_norms(wide), 64, gen))
    del wide
    # the bf16 stream: the weighted fit's round and the mini-batch one
    cases["K4 bf16"] = [k4_case(torch, la, ops, bounds, paper.bfloat16(),
                                norms, k, gen, w) for w in (wts, None)]
    for c in cases["K4 bf16"]:
        print_bf16("K4" + (" weighted" if c["weighted"] else ""), c)
        print(f"  K4 bf16 d={c['d']}: {untiled_text(c)}")
    for c in cases["K4"]:
        print(f"K4 n={c['n']} d={c['d']} k={c['k']}"
              + (" weighted" if c["weighted"] else "")
              + f": err {c['max_abs_err']:.3g} (tol {c['tol']:.3g}) label "
              f"diffs {c['label_diffs']}, labels and D² bitwise K3's; "
              f"{untiled_text(c)}, plain {c['plain_ms']:.4f} ms, bound "
              f"{c['bound_ms']:.4f} ms ({c['bound_by']})" + screen_text(c))
    knorms = bounds.point_norms(kvq_pts)
    cases["K9 bf16"] = [k9_case(torch, la, kd, ops, kvq_pts.bfloat16(),
                                knorms, kvq.k, gen)]
    print_bf16("K9", cases["K9 bf16"][0])
    print(f"  K9 bf16: {untiled_text(cases['K9 bf16'][0])}")
    c = k9_case(torch, la, kd, ops, kvq_pts, knorms, kvq.k, gen)
    cases["K9"].append(c)
    print(f"K9 B={c['batch']} n={c['n']} d={c['d']} k={c['k']} label diffs "
          f"{c['label_diffs']}: err {c['max_abs_err']:.3g} (tol "
          f"{c['tol']:.3g}), rows 0, 1, B-1 bitwise K4; {untiled_text(c)}, "
          f"plain {c['plain_ms']:.4f} ms, bound {c['bound_ms']:.4f} ms "
          f"({c['bound_by']})" + screen_text(c))
    # K9's path: code every row of the sweep against its fitted codebook
    eng = ClusterEngine(device="cuda")
    book = eng.kmeans_batched(kvq_pts, kvq.k, max_iters=kvq.max_iters,
                              generator=torch.Generator().manual_seed(0))
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    codes, cmd, _, ccounts = ops.lloyd_assign(kvq_pts, book.centroids)
    torch.cuda.synchronize()
    code_ms = (time.perf_counter() - t0) * 1e3
    got = dict(ops.LAUNCHES)
    check(got["lloyd_assign_batched"] == 1 and sum(got.values()) == 1,
          f"ops.lloyd_assign on (B, n, d): launches {got}")
    launches["lloyd_assign_batched"] += 1
    bn = ops.choose_block_n(kvq.n_points, kvq.dim, kvq.k)
    k10a = la.lloyd_assign_tiled_batched(
        kvq_pts, knorms, book.centroids.contiguous(), block_n=bn,
        tps=bounds.tiles_per_super(-(-kvq.n_points // bn)))
    check(torch.equal(codes, k10a[0]) and torch.equal(cmd, k10a[1])
          and bool((ccounts.sum(-1) == kvq.n_points).all()),
          "K9's codes are not K10a's labels, or its counts miss rows")
    del knorms, k10a, codes, cmd
    print(f"ops.lloyd_assign over the {kvq.name} sweep's codebooks: one K9 "
          f"launch, {code_ms:.2f} ms (host clock), codes bitwise K10a's "
          "labels")

    ungated = ClusterEngine(device="cuda", bounds=False)
    fused = ClusterEngine("fused", device="cuda", bounds=False)
    runs = []
    for sampler, prop in (("cdf", "hier"), ("tiled", "hier"),
                          ("rejection", "hier"), ("rejection", "flat")):
        rej = sampler == "rejection"
        what = f"weighted kmeans[{sampler}" + (f" {prop}]" if rej else "]")
        draws = Draws.sample(n, k, generator=torch.Generator().manual_seed(0),
                             device=dev, max_attempts=8 if rej else 0,
                             weighted=True)
        kw = dict(weights=wts, proposal=prop)
        seeds, _, _ = seed_run(torch, ops, eng, paper, k, draws,
                               sampler=sampler, **kw)
        seed_ms = median_seed_ms(torch, eng, paper, k, draws,
                                 sampler=sampler, **kw)
        res, total_s, got = kmeans_run(torch, ops, eng, paper, k, sampler,
                                       draws, full.max_iters, **kw)
        for name in launches:
            launches[name] += got[name]
        want = {name: 0 for name in got}
        want.update(seed_prologue=1, lloyd_assign=res.n_iters,
                    distance_min_update=k)
        if rej:
            want.update(distance_min_update=refreshes(
                seeds.accepts.tolist(), k, 8),
                row_min_d2=int((seeds.proposals > 0).sum()),
                tile_cap=live_rounds(seeds.accepts.tolist(), k, 8)
                if prop == "hier" else 0)
        check(got == want, f"{what}: launches {got}, want {want}")
        check(tuple(res.centroids.shape) == (k, full.dim)
              and bool(torch.isfinite(res.centroids).all())
              and bool(torch.isfinite(res.inertia))
              and int(res.assignment.min()) >= 0
              and int(res.assignment.max()) < k
              and res.skipped is None and res.recovered is None
              and int(seeds.recovered.sum()) == 0
              and bool((wts[seeds.indices] > 0).all()),
              f"{what}: output malformed")
        again, _, _ = kmeans_run(torch, ops, eng, paper, k, sampler, draws,
                                 full.max_iters, **kw)
        check(same_fit(torch, again, res), f"{what}: two runs differ")
        off_s = None
        if prop == "flat" or not rej:
            off, off_s, _ = kmeans_run(torch, ops, ungated, paper, k,
                                       sampler, draws, full.max_iters, **kw)
            check(same_fit(torch, off, res),
                  f"{what}: not bitwise the bounds=False kmeans")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit = eng.fit(paper, seeds.centroids, weights=wts,
                      max_iters=full.max_iters)
        torch.cuda.synchronize()
        lloyd_ms = (time.perf_counter() - t0) * 1e3 / max(fit.n_iters, 1)
        check(same_fit(torch, fit, res),
              f"{what}: not the seeding's seeds then a weighted fit")
        plain = fused.fit(paper, seeds.centroids, weights=wts,
                          max_iters=full.max_iters)
        # 1e-4: both fits take the same Lloyd steps; they differ only in
        # the fp32 summation order of the weighted sums and the inertia
        rel = abs(float(plain.inertia) - float(res.inertia)) / float(
            res.inertia)
        check(rel <= 1e-4, f"{what}: plain fit inertia differs by {rel:.3g}")
        run = dict(sampler=sampler, proposal=prop if rej else None,
                   n_iters=res.n_iters, inertia=float(res.inertia),
                   kmeans_s=total_s, ungated_kmeans_s=off_s,
                   seed_ms=seed_ms, lloyd_ms_per_iter=lloyd_ms,
                   inertia_rel_diff=rel, launches=got,
                   bitwise_ungated=off_s is not None, repeat_bitwise=True)
        if rej:
            run.update(proposals=int(seeds.proposals.sum()),
                       accepts=int(seeds.accepts.sum()),
                       tightened=int(seeds.tightened.sum()))
        runs.append(run)
        print(f"{what} at {full.name}: {total_s:.3f} s end to end"
              + ("" if off_s is None else
                 f", {off_s:.3f} s with bounds=False (bitwise equal)")
              + f"; seeding {seed_ms:.2f} ms, Lloyd {lloyd_ms:.3f} ms/iter; "
              f"n_iters {res.n_iters}, inertia {run['inertia']:.7g}, plain "
              f"fit rel diff {rel:.3g}; launches "
              f"{ {n_: c for n_, c in got.items() if c} }")

    # mini-batch Lloyd, streamed from the host array
    n_batches = -(-n // batch_rows)
    init = eng.seed(paper, k, generator=torch.Generator().manual_seed(0),
                    sampler="tiled").centroids

    def read(step):
        return paper_np[step * batch_rows:(step + 1) * batch_rows]

    def minibatch():
        return eng.fit_minibatch(init, read, n_batches=n_batches)

    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mb = minibatch()
    torch.cuda.synchronize()
    mb_s = time.perf_counter() - t0
    got = dict(ops.LAUNCHES)
    for name in launches:
        launches[name] += got[name]
    check(got["lloyd_assign"] == n_batches and sum(got.values()) == n_batches
          and mb.n_iters == n_batches,
          f"fit_minibatch: launches {got}, {mb.n_iters} batches, want "
          f"{n_batches} K4 launches")
    check(same_fit(torch, minibatch(), mb), "fit_minibatch: two runs differ")
    prof = profile_call(torch, minibatch)
    h2d = sum(v["ms"] for name, v in prof["kernels"].items()
              if "HtoD" in name)
    full_fit = eng.fit(paper, init, max_iters=full.max_iters)
    mb_inertia = float(la.lloyd_assign_torch(paper, norms,
                                             mb.centroids)[1].double().sum())
    ratio = mb_inertia / float(full_fit.inertia)
    mrun = dict(batches=n_batches, batch_rows=batch_rows, wall_s=mb_s,
                ms_per_batch=mb_s * 1e3 / n_batches,
                h2d_ms_per_batch=h2d / n_batches,
                busy_ms_per_batch=prof["busy_ms"] / n_batches,
                profiled_wall_ms=prof["wall_ms"],
                idle_share=prof["idle_share"], inertia_full=mb_inertia,
                full_batch_inertia=float(full_fit.inertia),
                full_batch_n_iters=full_fit.n_iters, inertia_ratio=ratio,
                launches=got, repeat_bitwise=True)
    print(f"fit_minibatch at {full.name}, {n_batches} batches of "
          f"{batch_rows} rows, one pass: {mrun['ms_per_batch']:.3f} ms per "
          f"batch (host clock), host-to-device copies "
          f"{mrun['h2d_ms_per_batch']:.4f} ms and device busy "
          f"{mrun['busy_ms_per_batch']:.4f} ms per batch (profiler, idle "
          f"share {prof['idle_share']:.3f}); inertia over all rows "
          f"{mb_inertia:.7g}, {ratio:.5f}× the full-batch fit's "
          f"({full_fit.n_iters} iterations); launches "
          f"{ {n_: c for n_, c in got.items() if c} }")
    return cases, dict(weighted_kmeans=runs, minibatch=mrun,
                       k9_path_ms=code_ms)


def scan_case(torch, name, fn, twin, args, kw, tol, nprobe, chunk):
    """One IVF scan kernel (K13 or K14) against its plain twin on ``args``
    (the first ``chunk`` queries' maps): rows equal wherever the twin's
    adjacent D² (k + 1 of them) lie more than 2·tol apart, dists within
    ``tol``, gate_skipped equal, and then dists and rows bitwise the
    twin's; gate off bitwise gate on; two launches the same bits."""
    one = fn(*args, gate=True, **kw)
    two = fn(*args, gate=True, **kw)
    check(all(torch.equal(a, b) for a, b in zip(one, two)),
          f"{name} nprobe={nprobe}: two launches differ")
    off = fn(*args, gate=False, **kw)
    check(torch.equal(one[0], off[0]) and torch.equal(one[1], off[1])
          and int(off[2].sum()) == 0,
          f"{name} nprobe={nprobe}: gate on is not bitwise gate off")
    plain = twin(*args, gate=True, **kw)
    wide = twin(*args, gate=True, **dict(kw, k=kw["k"] + 1))
    err = float((one[0] - plain[0]).abs().max())
    clear = (wide[0].diff(dim=1) > 2 * tol).all(dim=1)
    rows_ok = bool(((one[1] == plain[1]).all(dim=1) | ~clear).all())
    check(err <= tol and rows_ok and torch.equal(one[2], plain[2]),
          f"{name} nprobe={nprobe}: err {err:.3g} (tol {tol:.3g}), rows "
          f"{rows_ok}, gate_skipped equal {torch.equal(one[2], plain[2])}")
    # one arithmetic for kernel and twin: their bits must agree
    check(torch.equal(one[0], plain[0]) and torch.equal(one[1], plain[1]),
          f"{name} nprobe={nprobe}: not bitwise its twin")
    return dict(nprobe=nprobe, queries=chunk, max_abs_err=err, tol=tol,
                bitwise=True, clear_queries=int(clear.sum()),
                gate_skipped=int(one[2].sum()),
                probed_tiles=int(args[-1].sum()))


def k6_build_case(torch, la, ops, bounds, calls) -> list:
    """K6 at the IVF build's shape, on the arguments of the build's own
    launches (``calls``; the build's masks and carries): each launch again,
    bitwise the build's and, on the first, middle and last launch, the
    template entry's, all eight outputs (past the template's staging:
    bitwise K6 with pass B in 64-centroid chunks, and all eight outputs
    held to the plain twin as ``k6_held`` holds them); all-active K6 without a carried
    bound on the build's rows and first centroids bitwise K3; each launch
    timed (the sum is the build's K6 device time) beside the template
    entry's time on the middle one; the screen's counters. Each call is
    taken out of ``calls`` as it is replayed, so its tensors are freed."""
    res = []
    n_calls = len(calls)
    picks = {0, n_calls // 2, n_calls - 1}
    for i in range(n_calls):
        a, kw = calls.pop(0)
        pts, k = a[0], a[2].shape[0]
        n, d = pts.shape
        bn, tps = kw["block_n"], kw["tps"]
        what = f"K6 at the IVF build's launch {i} (n={n} d={d} k={k})"
        out1 = la.lloyd_assign_gated(*a, **kw)
        stats = screen_record(la, "lloyd_assign_gated", pts, torch)
        same_bits(torch, f"{what}: two launches", out1,
                  la.lloyd_assign_gated(*a, **kw))
        act = bounds.align_supers(a[13], tps)
        t = act.shape[0]
        c = dict(launch=i, n=n, d=d, k=k, block_n=bn, tps=tps,
                 active_tiles=int(act.sum()), tiles=t,
                 pruned=int(out1[7].sum()),
                 ms=gpu_ms(torch, lambda: la.lloyd_assign_gated(*a, **kw),
                           reps=5), **stats)
        # the template entry where its whole (k, d) staging fits; past it
        # (nlist 1,024) pass B in chunks of 64 centroids, bitwise, and all
        # eight outputs against the plain twin (``k6_held``)
        fits = k <= ops.template_max_k(d, bn, gated=True)
        if i in picks and fits:
            same_bits(torch, f"{what} vs the template entry", out1,
                      la.lloyd_assign_gated_template(*a, **kw))
            c["template_bitwise"] = True
        elif i in picks:
            same_bits(torch, f"{what} vs pass B in 64-centroid chunks", out1,
                      la.lloyd_assign_gated(*a, **kw, k_chunk=64))
            held = k6_held(torch, la, bounds, what, a, bn, tps, out1)
            c.update(k_chunk_bitwise=True, twin_held=True,
                     twin_label_diffs=held["label_diffs"],
                     max_abs_err=held["max_abs_err"])
        if i == n_calls // 2 and fits:
            c["template_ms"] = gpu_ms(
                torch, lambda: la.lloyd_assign_gated_template(*a, **kw),
                reps=3, warmup=1)
        if i == 0:
            s = -(-t // tps)
            dev = pts.device
            zt = torch.zeros(t, device=dev)
            on = la.lloyd_assign_gated(
                pts, a[1], a[2], torch.zeros(k, device=dev), zt, zt,
                torch.zeros(n, dtype=torch.int32, device=dev),
                torch.zeros(n, device=dev),
                torch.full((n,), -torch.inf, device=dev), zt, zt,
                torch.zeros((s, k, d), device=dev),
                torch.zeros((s, k), device=dev),
                torch.ones(t, dtype=torch.bool, device=dev), **kw)
            same_bits(torch, f"{what}: all-active without a bound vs K3",
                      (on[0], on[1], on[3], on[4], on[5], on[6]),
                      la.lloyd_assign_tiled(pts, a[1], a[2], **kw))
            c["all_active_bitwise_k3"] = True
        rows_act = int(bounds.expand_mask(act, bn, n).sum())
        c["bound_ms"], c["bound_by"], c["fma_bound_ms"] = k6_bound(
            torch, pts, k, rows_act, rows_act - c["pruned"], t,
            int(bounds.super_any(act, tps).sum()),
            la.screened(d, pts.dtype == torch.bfloat16))
        res.append(c)
        print(f"{what}: {c['active_tiles']}/{t} tiles active, {c['pruned']} "
              f"rows pruned; {c['ms']:.4f} ms"
              + (f" (template entry {c['template_ms']:.4f} ms)"
                 if "template_ms" in c else "")
              + f", bound {c['bound_ms']:.4f} ms ({c['bound_by']})"
              + ("; bitwise the template entry" if "template_bitwise" in c
                 else "; bitwise pass B in chunks, all eight outputs held "
                      "to the twin" if "k_chunk_bitwise" in c else "")
              + ("; all-active bitwise K3" if i == 0 else "")
              + screen_text(c))
        del a, kw, out1
    total = sum(c["ms"] for c in res)
    print(f"K6 at the IVF build: {len(res)} launches, {total:.4f} ms of "
          f"device time in all (medians of 5 each)")
    return res


def large_k_phase(torch, la, ops, bounds, dev, gen) -> dict:
    """Past the old staging caps: d = 128, k = 8,192 on 50,000 rows (fp32),
    0.01 from one of k well-separated centroids (no near-ties). Pass A
    stages 32 centroid chunks in turn, their norms with each; pass B takes
    k in two chunks (one block holds at most 6,688 centroids' sums at
    4,096-row tiles). K3, K6 (all active without a carried bound, then a
    round from that state with two centroids moved), K4 and K10a (two
    problems of 20,000 rows): each bitwise a second launch, labels and
    counts bitwise the plain twin's, D² within tolerance, sums as
    ``super_sums_ok`` holds them; K3 bitwise K10a problem by problem and
    K6's first round bitwise K3; each launch's median time (CUDA events)
    beside the twin's."""
    n, d, k = 50_000, 128, 8192
    c = torch.randn((k, d), generator=gen, device=dev)
    lab = torch.randint(k, (n,), generator=gen, device=dev)
    x = c[lab] + 0.01 * torch.randn((n, d), generator=gen, device=dev)
    norms = bounds.point_norms(x)
    bn = ops.choose_block_n(n, d, k)
    t = -(-n // bn)
    tps = bounds.tiles_per_super(t)
    s_ = -(-t // tps)
    tol = d2_tol(torch, norms, c)
    out = dict(n=n, d=d, k=k, block_n=bn, tps=tps,
               template_max_k=ops.template_max_k(d, bn))
    check(k > out["template_max_k"],
          "the large-k case is not past the template's cap")

    def held(name, call, twin, rows_per_super, sums_i, counts_i, lab_i=0,
             md_i=1):
        got = call()
        same_bits(torch, f"{name} (large k): two launches", got, call())
        want = twin()
        check(torch.equal(got[lab_i], want[lab_i])
              and torch.equal(got[counts_i], want[counts_i]),
              f"{name} (large k): labels or counts are not the twin's")
        err = float((got[md_i] - want[md_i]).abs().max())
        check(err <= tol, f"{name} (large k): D² err {err} > {tol}")
        if got[lab_i].dim() == 1:   # a batch's problems are held below
            sums, counts = got[sums_i], got[counts_i]
            if sums.dim() == 2:     # K4's (k, d): one super
                sums, counts = sums[None], counts[None]
            check(super_sums_ok(torch, x, got[lab_i], sums, counts,
                                rows_per_super),
                  f"{name} (large k): sums outside tolerance")
        prof = profile_call(torch, lambda: [call() for _ in range(3)])
        parts = {}
        for kname, v in prof["kernels"].items():
            m = re.search(r"(\w+_kernel)(<[^()]*>)?", kname)
            if m:
                parts[m.group(0)] = v["ms"] / 3
        out[name] = dict(max_abs_err=err,
                         ms=gpu_ms(torch, call, reps=5, warmup=1),
                         plain_ms=gpu_ms(torch, twin, reps=3, warmup=1),
                         parts_ms=parts)
        print(f"{name} n={n} d={d} k={k}: labels and counts bitwise the "
              f"twin's, D² err {err:.3g} (tol {tol:.3g}), two launches "
              f"bitwise; {out[name]['ms']:.4f} ms (by kernel, profiler: "
              + ", ".join(f"{p_} {ms:.4f}" for p_, ms in parts.items())
              + f"), plain {out[name]['plain_ms']:.4f} ms")
        return got

    k3 = held("K3", lambda: la.lloyd_assign_tiled(x, norms, c, block_n=bn,
                                                  tps=tps),
              lambda: la.lloyd_assign_tiled_torch(x, norms, c, block_n=bn,
                                                  tps=tps),
              bn * tps, sums_i=4, counts_i=5)
    out["K3"]["screen"] = screen_record(la, "lloyd_assign_tiled", x, torch)
    zt = torch.zeros(t, device=dev)
    args0 = (x, norms, c, torch.zeros(k, device=dev), zt, zt,
             torch.zeros(n, dtype=torch.int32, device=dev),
             torch.zeros(n, device=dev),
             torch.full((n,), -torch.inf, device=dev), zt, zt,
             torch.zeros((s_, k, d), device=dev),
             torch.zeros((s_, k), device=dev),
             torch.ones(t, dtype=torch.bool, device=dev))
    first = la.lloyd_assign_gated(*args0, block_n=bn, tps=tps)
    same_bits(torch, "K6 (large k): all active without a bound vs K3",
              (first[0], first[1], first[3], first[4], first[5], first[6]),
              k3)
    st = bounds.BoundState(first[3], tile_gap=first[4], tile_sums=first[5],
                           tile_counts=first[6], assignment=first[0],
                           min_d2=first[1], point_lb=first[2], lb_debt=zt)
    c1 = c.clone()
    c1[[0, k - 1]] += 0.002
    delta = bounds.centroid_movement(c1, c)
    cache = bounds.prologue(x, bn)
    thresh, absorb = bounds.assign_point_scalars(delta, c1, st, cache)
    act = bounds.expand_active_supers(bounds.assign_active_tiles(
        delta, c1, st, cache, tps=tps), tps)
    gargs = (x, norms, c1, delta, thresh, absorb, st.assignment, st.min_d2,
             st.point_lb, st.partials, st.tile_gap, st.tile_sums,
             st.tile_counts, act)
    g = held("K6", lambda: la.lloyd_assign_gated(*gargs, block_n=bn,
                                                 tps=tps),
             lambda: la.lloyd_assign_gated_torch(*gargs, block_n=bn,
                                                 tps=tps),
             bn * tps, sums_i=5, counts_i=6)
    out["K6"]["pruned"] = int(g[7].sum())
    del first, g, st, cache
    held("K4", lambda: la.lloyd_assign(x, norms, c, block_n=bn),
         lambda: la.lloyd_assign_torch(x, norms, c), n, sums_i=2,
         counts_i=3)
    m = 20_000
    xb = torch.stack([x[:m], x[m:2 * m]])
    nb = torch.stack([norms[:m], norms[m:2 * m]])
    cb = torch.stack([c, c.flip(0)]).contiguous()
    bnb = ops.choose_block_n(m, d, k)
    tpb = bounds.tiles_per_super(-(-m // bnb))
    k10a = held("K10a", lambda: la.lloyd_assign_tiled_batched(
        xb, nb, cb, block_n=bnb, tps=tpb),
        lambda: la.lloyd_assign_tiled_batched_torch(xb, nb, cb, block_n=bnb,
                                                    tps=tpb),
        bnb * tpb, sums_i=4, counts_i=5)
    every_problem(torch, "K10a (large k)", k10a,
                  lambda b: la.lloyd_assign_tiled(xb[b], nb[b], cb[b],
                                                  block_n=bnb, tps=tpb), 2)
    for b in range(2):
        check(super_sums_ok(torch, xb[b], k10a[0][b], k10a[4][b],
                            k10a[5][b], bnb * tpb),
              f"K10a (large k): problem {b}'s sums outside tolerance")
    return out


def lattice(torch, gen, dev, n: int, d: int, k: int):
    """k distinct centroids on the integer lattice (at least 1 apart, so no
    near-ties at any k) and n rows 0.01 from one of them, drawn on the
    card."""
    side = max(2, math.ceil((4 * k) ** (1.0 / d)))
    c = torch.empty((0, d), device=dev)
    while c.shape[0] < k:
        more = torch.randint(side, (2 * k, d), generator=gen, device=dev)
        c = torch.unique(torch.cat([c, more.float()]), dim=0)
    c = c[torch.randperm(c.shape[0], generator=gen, device=dev)[:k]]
    c = (c - side / 2).contiguous()
    lab = torch.randint(k, (n,), generator=gen, device=dev)
    return c[lab] + 0.01 * torch.randn((n, d), generator=gen, device=dev), c


def refused_phase(torch, ops, kd, la, bounds, ClusterEngine, Draws, dev,
                  gen) -> dict:
    """The (round, width, k) shapes the template's whole-(k, d) staging
    refused, each through the engine on the card and counted, and each
    round's kernel at the engine's shape held to its plain twin (labels and
    counts bitwise on lattice data, D² within ``d2_tol``, sums as
    ``super_sums_ok`` holds them): a weighted ``fit`` at d = 5, k = 4,096,
    n = 100,000 (K4); ``kmeans_batched`` at d = 4, k = 4,200, B = 2 x
    n = 20,000, gated and ungated, bitwise each other (K10b, K10a; their
    seeding K8 and K7 at k = 4,200) and ``ops.lloyd_assign`` on the same
    points (K9); ``kmeans(bounds=False)`` at fp32 d = 200, k = 300 (K3),
    weighted (K4), and at bf16 d = 300 (K3); the backend's seeding round
    folding 1,024 centroids at d = 64 (K2: the guard heal's fold), resident
    bitwise not. Each assignment round's new route is also run at the old
    cap (the largest k the template staged) on the same points, bitwise
    its template entry there, and timed beside it. At d = 60,000 a gated
    ``kmeans`` (K1's wide route) and a flat rejection seeding (K11), at
    d = 8,000 a hier one with ``refresh_block`` 8 (K12's (8, 8,000)
    block), each counted and held to the ungated card engine (bitwise, but
    hier) and to the CPU engine's run from the same draws."""
    out: dict = {}

    def beside(what, k, route, templates, rows=lambda got, b: got):
        """the route at the old cap k bitwise its template entry (one
        launch a problem, ``rows`` picking problem b's outputs), and both
        timed"""
        got = route()
        for b, tmpl in enumerate(templates):
            same_bits(torch, f"{what} k={k}: problem {b} vs the template "
                      f"entry", rows(got, b), tmpl())
        del got
        ms = gpu_ms(torch, route)
        template_ms = gpu_ms(torch, lambda: [tmpl() for tmpl in templates])
        ms2 = gpu_ms(torch, route)
        out.setdefault("at_the_old_cap", {})[what] = dict(
            k=k, ms=ms, ms_again=ms2, template_ms=template_ms)
        print(f"{what} at the old cap k={k}: bitwise the template entry; "
              f"{ms:.4f} ms (again {ms2:.4f}), template entry "
              f"{template_ms:.4f} ms")

    def counted(what, want, fn):
        ops.reset_launches()
        res = fn()
        torch.cuda.synchronize()
        got = {name: v for name, v in ops.LAUNCHES.items() if v}
        check(all(got.get(name, 0) >= 1 for name in want),
              f"{what}: launches {got}, want {want} each at least once")
        out.setdefault("launches", {})[what] = got
        return res

    def held(what, got, want, x, tol, bn=None, w=None):
        """labels (0), D² (1) and, untiled, sums (2) / counts (3) or tiled
        sums (4) / counts (5) against the twin"""
        check(torch.equal(got[0], want[0]),
              f"{what}: labels are not the twin's")
        err = float((got[1] - want[1]).abs().max())
        check(err <= tol, f"{what}: D² err {err} > {tol}")
        tiled = len(got) == 6
        s_i, c_i = (4, 5) if tiled else (2, 3)
        check(torch.equal(got[c_i], want[c_i]),
              f"{what}: counts are not the twin's")
        if got[0].dim() == 1:
            sums, cnts = got[s_i], got[c_i]
            if not tiled:
                sums, cnts = sums[None], cnts[None]
            rps = x.shape[0] if not tiled else bn * bounds.tiles_per_super(
                -(-x.shape[0] // bn))
            check(super_sums_ok(torch, x.float(), got[0], sums, cnts, rps,
                                w=w), f"{what}: sums outside tolerance")
        out[what] = dict(max_abs_err=err, tol=tol)
        print(f"{what}: labels and counts bitwise the twin's, D² err "
              f"{err:.3g} (tol {tol:.3g})")

    def plain_seeds(what, got, want, nr, rejection=True):
        """a card seeding against the CPU engine's from the same draws:
        indices (and the rejection counters) equal, min_d2 within the D²
        tolerance"""
        diff = (got.indices.cpu() != want.indices).nonzero()
        check(diff.numel() == 0, f"{what}: seeds are not the CPU engine's "
              f"(first at seed {int(diff[0, 0]) if diff.numel() else -1}: "
              f"{got.indices.tolist()} against {want.indices.tolist()})")
        for f in ("proposals", "accepts") if rejection else ():
            check(torch.equal(getattr(got, f).cpu(), getattr(want, f)),
                  f"{what}: {f} are not the CPU engine's")
        tol = d2_tol(torch, nr, got.centroids)
        err = float((got.min_d2.cpu() - want.min_d2).abs().max())
        check(err <= tol, f"{what}: min_d2 err {err} > {tol} against the "
              "CPU engine")
        out[what + " vs the CPU engine"] = dict(max_abs_err=err, tol=tol)
        print(f"{what}: seeds{' and counters' if rejection else ''} the CPU "
              f"engine's, min_d2 err {err:.3g} (tol {tol:.3g})")

    def plain_fit(what, got, want, x, nr):
        """a card fit against the CPU engine's from the same draws: labels
        and n_iters equal, centroids within n roundings of the largest
        coordinate (means of up to n rows in two orders), inertia within n
        rows of the D² tolerance"""
        check(torch.equal(got.assignment.cpu().long(), want.assignment.long())
              and int(got.n_iters) == int(want.n_iters),
              f"{what}: labels or n_iters are not the CPU engine's")
        n_ = x.shape[0]
        ctol = n_ * EPS32 * float(x.abs().max())
        cerr = float((got.centroids.cpu() - want.centroids).abs().max())
        itol = n_ * d2_tol(torch, nr, got.centroids)
        ierr = abs(float(got.inertia) - float(want.inertia))
        check(cerr <= ctol and ierr <= itol, f"{what}: centroids err {cerr} "
              f"(tol {ctol}) or inertia err {ierr} (tol {itol}) against the "
              "CPU engine")
        out[what + " vs the CPU engine"] = dict(
            centroids_err=cerr, centroids_tol=ctol, inertia_err=ierr,
            inertia_tol=itol)
        print(f"{what}: labels and n_iters the CPU engine's, centroids err "
              f"{cerr:.3g} (tol {ctol:.3g}), inertia err {ierr:.3g} (tol "
              f"{itol:.3g})")

    # K4: a weighted fit at d = 5, k = 4,096 (template cap 4,041)
    n, d, k = 100_000, 5, 4096
    x, c = lattice(torch, gen, dev, n, d, k)
    w = torch.randint(1, 4, (n,), generator=gen, device=dev).float()
    eng = ClusterEngine(device="cuda")
    res = counted("weighted fit d=5 k=4096", ["lloyd_assign"],
                  lambda: eng.fit(x, c, weights=w, max_iters=3))
    check(bool(torch.isfinite(res.centroids).all()),
          "weighted fit d=5: centroids not finite")
    nr = bounds.point_norms(x)
    bn = ops.choose_block_n(n, d, k)
    check(k > ops.template_max_k(d, bn), "K4 d=5: not past the old cap")
    held("K4 d=5 k=4096 weighted", la.lloyd_assign(x, nr, c, w, block_n=bn),
         la.lloyd_assign_torch(x, nr, c, w), x, d2_tol(torch, nr, c), w=w)
    most = ops.template_max_k(d, bn)
    cm = c[:most].contiguous()
    beside("K4 d=5 weighted", most,
           lambda: la.lloyd_assign(x, nr, cm, w, block_n=bn),
           [lambda: la.lloyd_assign_template(x, nr, cm, w, block_n=bn)])

    # K10a, K10b, K9 (and K7, K8 seeding): B = 2 problems at d = 4, k = 4,200
    bsz, n, d, k = 2, 20_000, 4, 4200
    pr = [lattice(torch, gen, dev, n, d, k) for _ in range(bsz)]
    xb = torch.stack([p[0] for p in pr])
    cb = torch.stack([p[1] for p in pr])
    draws = Draws.sample_batched(bsz, n, k, device=dev,
                                 generator=torch.Generator().manual_seed(1))
    rg = counted("kmeans_batched gated d=4 k=4200",
                 ["distance_min_update_gated_batched",
                  "lloyd_assign_gated_batched"],
                 lambda: eng.kmeans_batched(xb, k, draws=draws, max_iters=3))
    ung = ClusterEngine(device="cuda", bounds=False)
    ru = counted("kmeans_batched ungated d=4 k=4200",
                 ["distance_min_update_batched", "lloyd_assign_tiled_batched"],
                 lambda: ung.kmeans_batched(xb, k, draws=draws, max_iters=3))
    check(all(bits_equal(torch, a, b) for a, b in
              zip((rg.centroids, rg.assignment), (ru.centroids,
                                                  ru.assignment))),
          "kmeans_batched d=4 k=4200: gated is not bitwise ungated")
    nb = bounds.point_norms(xb)
    bn = ops.choose_block_n(n, d, k)
    tps = bounds.tiles_per_super(-(-n // bn))
    check(k > ops.template_max_k(d, bn, gated=True),
          "K10b d=4: not past the old cap")
    tol = d2_tol(torch, nb, cb.reshape(-1, d))
    held("K10a d=4 k=4200", la.lloyd_assign_tiled_batched(
        xb, nb, cb, block_n=bn, tps=tps), la.lloyd_assign_tiled_batched_torch(
        xb, nb, cb, block_n=bn, tps=tps), xb, tol)
    t = -(-n // bn)
    s_ = -(-t // tps)
    zt = torch.zeros((bsz, t), device=dev)
    gargs = (xb, nb, cb, torch.zeros((bsz, k), device=dev), zt, zt,
             torch.zeros((bsz, n), dtype=torch.int32, device=dev),
             torch.zeros((bsz, n), device=dev),
             torch.full((bsz, n), -torch.inf, device=dev), zt, zt,
             torch.zeros((bsz, s_, k, d), device=dev),
             torch.zeros((bsz, s_, k), device=dev),
             torch.ones((bsz, t), dtype=torch.bool, device=dev))
    g = la.lloyd_assign_gated_batched(*gargs, block_n=bn, tps=tps)
    gw = la.lloyd_assign_gated_batched_torch(*gargs, block_n=bn, tps=tps)
    held("K10b d=4 k=4200", (g[0], g[1], g[3], g[4], g[5], g[6]),
         (gw[0], gw[1], gw[3], gw[4], gw[5], gw[6]), xb, tol)
    k9 = counted("ops.lloyd_assign (2, 20000, 4) k=4200",
                 ["lloyd_assign_batched"],
                 lambda: ops.lloyd_assign(xb, cb, norms=nb))
    held("K9 d=4 k=4200", k9, la.lloyd_assign_batched_torch(xb, nb, cb), xb,
         tol)
    # at the old caps: K10a and K9 ungated, K10b gated (one template launch
    # a problem for the batched rounds)
    by_problem = lambda got, b: tuple(o[b] for o in got)   # noqa: E731
    most = ops.template_max_k(d, bn)
    cm = cb[:, :most].contiguous()
    beside("K10a d=4", most, lambda: la.lloyd_assign_tiled_batched(
        xb, nb, cm, block_n=bn, tps=tps),
        [lambda b=b: la.lloyd_assign_tiled_template(
            xb[b], nb[b], cm[b], block_n=bn, tps=tps) for b in range(bsz)],
        by_problem)
    beside("K9 d=4", most, lambda: la.lloyd_assign_batched(
        xb, nb, cm, block_n=bn),
        [lambda: la.lloyd_assign_batched_template(xb, nb, cm, block_n=bn)])
    most = ops.template_max_k(d, bn, gated=True)
    gm = (xb, nb, cb[:, :most].contiguous(),
          gargs[3][:, :most].contiguous(), *gargs[4:11],
          gargs[11][:, :, :most].contiguous(),
          gargs[12][:, :, :most].contiguous(), gargs[13])
    beside("K10b d=4", most, lambda: la.lloyd_assign_gated_batched(
        *gm, block_n=bn, tps=tps),
        [lambda b=b: la.lloyd_assign_gated_template(
            *(a[b] for a in gm), block_n=bn, tps=tps) for b in range(bsz)],
        by_problem)
    del gm
    del xb, cb, nb, gargs, g, gw, rg, ru

    # K3 and K4 past the screened widths: fp32 d = 200 and bf16 d = 300,
    # k = 300 (template caps 274 and 186 at their 128-row tiles)
    n, k = 20_000, 300
    for d, prec in ((200, "fp32"), (300, "bf16")):
        x, c = lattice(torch, gen, dev, n, d, k)
        e = ClusterEngine(device="cuda", bounds=False, precision=prec)
        sfx = "_bf16" if prec == "bf16" else ""
        res = counted(f"kmeans(bounds=False) {prec} d={d} k={k}",
                      ["distance_min_update" + sfx, "lloyd_assign_tiled" + sfx],
                      lambda: e.kmeans(x, k, max_iters=3,
                                       generator=torch.Generator()
                                       .manual_seed(2)))
        check(bool(torch.isfinite(res.centroids).all()),
              f"kmeans d={d}: centroids not finite")
        nr = bounds.point_norms(x)
        bn = ops.choose_block_n(n, d, k)
        tps = bounds.tiles_per_super(-(-n // bn))
        check(k > ops.template_max_k(d, bn), f"K3 d={d}: not past the cap")
        xs, cs = (x, c) if prec == "fp32" else (x.bfloat16(), c.bfloat16())
        tol = d2_tol(torch, nr, cs.float())
        held(f"K3 {prec} d={d} k={k}", la.lloyd_assign_tiled(
            xs, nr, cs, block_n=bn, tps=tps), la.lloyd_assign_tiled_torch(
            xs, nr, cs, block_n=bn, tps=tps), xs, tol, bn=bn)
        most = ops.template_max_k(d, bn)
        cm = cs[:most].contiguous()
        beside(f"K3 {prec} d={d}", most, lambda: la.lloyd_assign_tiled(
            xs, nr, cm, block_n=bn, tps=tps),
            [lambda: la.lloyd_assign_tiled_template(xs, nr, cm, block_n=bn,
                                                    tps=tps)])
        if prec == "fp32":
            w = torch.randint(1, 4, (n,), generator=gen, device=dev).float()
            res = counted(f"weighted kmeans(bounds=False) d={d} k={k}",
                          ["distance_min_update", "lloyd_assign"],
                          lambda: e.kmeans(x, k, weights=w, max_iters=3,
                                           generator=torch.Generator()
                                           .manual_seed(3)))
            check(bool(torch.isfinite(res.centroids).all()),
                  f"weighted kmeans d={d}: centroids not finite")
            held(f"K4 d={d} k={k} weighted", la.lloyd_assign(
                x, nr, c, w, block_n=bn), la.lloyd_assign_torch(x, nr, c, w),
                x, tol, w=w)
            beside(f"K4 d={d} weighted", most, lambda: la.lloyd_assign(
                x, nr, cm, w, block_n=bn),
                [lambda: la.lloyd_assign_template(x, nr, cm, w,
                                                  block_n=bn)])

    # K2: the guard heal's fold of all k = 1,024 centroids at d = 64 in one
    # round of the backend (a resident block of 65,536 floats)
    n, d, k = 100_000, 64, 1024
    x, c = lattice(torch, gen, dev, n, d, k)
    cache = eng.backend.prologue(x, k)
    tile = eng.backend.seed_tile(n, d, k)
    inf = torch.full((n,), torch.inf, device=dev)
    rnd = counted("seed_round folding 1024 centroids d=64",
                  ["distance_min_update"],
                  lambda: eng.backend.seed_round(x, c, inf, cache=cache))
    md, parts = kd.distance_min_update_torch(x, cache.norms, c, inf,
                                             block_n=tile)
    tol = d2_tol(torch, cache.norms, c)
    err = float((rnd.min_d2 - md).abs().max())
    check(err <= tol, f"K2 fold m=1024 d=64: D² err {err} > {tol}")
    check(bool(((rnd.partials - parts).abs()
                <= partial_tol(tol, tile, parts)).all()),
          "K2 fold m=1024 d=64: partials outside tolerance")
    same_bits(torch, "K2 fold m=1024 d=64: resident vs not",
              kd.distance_min_update(x, cache.norms, c, inf, block_n=tile),
              kd.distance_min_update(x, cache.norms, c, inf, block_n=tile,
                                     resident=False))
    out["K2 fold m=1024 d=64"] = dict(max_abs_err=err, tol=tol)
    print(f"K2 fold m={k} d={d}: D² err {err:.3g} (tol {tol:.3g}), "
          f"partials within tolerance, resident bitwise not")
    del x, c, cache, inf, rnd, md, parts
    torch.cuda.empty_cache()

    # K1 and K11 at d = 60,000 (the template K1 stages its center beside
    # 256 floats, 57,856 at most; K11 staged its row, 58,112 at most): a
    # gated kmeans (K1 on the wide route; K5 and K6 reading the centroids
    # from device memory, where not one stages) and a flat rejection
    # seeding, counted, each held to its plain paths: bitwise the ungated
    # card engine, and the CPU engine's (the plain twins) from the same
    # draws; K1 at the engine's tiles held to its twin, the template entry
    # refusing; K6 and K3 at that width held to their twins; K11 on a
    # round's 8 attempts bitwise its twin
    from repro_torch.core.guards import KernelFailureError
    cpu = ClusterEngine(device="cpu")
    n, d, k = 1000, 60_000, 4
    x, c = lattice(torch, gen, dev, n, d, k)
    xc = x.cpu()

    def km(e, pts):
        return e.kmeans(pts, k, max_iters=3,
                        generator=torch.Generator().manual_seed(4))

    res = counted("gated kmeans d=60000 k=4", ["seed_prologue",
                                               "distance_min_update_gated",
                                               "lloyd_assign_gated"],
                  lambda: km(eng, x))
    check(bool(torch.isfinite(res.centroids).all()),
          "kmeans d=60000: centroids not finite")
    check(same_fit(torch, res, km(ung, x)),
          "kmeans d=60000: gated is not bitwise ungated")
    nr = bounds.point_norms(x)
    plain_fit("gated kmeans d=60000 k=4", res, km(cpu, xc), x, nr)
    plain_seeds("gated cdf seeding d=60000 k=4",
                eng.seed(x, k, generator=torch.Generator().manual_seed(4)),
                cpu.seed(xc, k, generator=torch.Generator().manual_seed(4)),
                nr, rejection=False)
    bn = ops.choose_block_n(n, d, k)
    tps = bounds.tiles_per_super(-(-n // bn))
    t = -(-n // bn)
    zt = torch.zeros(t, device=dev)
    gargs = (x, nr, c, torch.zeros(k, device=dev), zt, zt,
             torch.zeros(n, dtype=torch.int32, device=dev),
             torch.zeros(n, device=dev),
             torch.full((n,), -torch.inf, device=dev), zt, zt,
             torch.zeros((-(-t // tps), k, d), device=dev),
             torch.zeros((-(-t // tps), k), device=dev),
             torch.ones(t, dtype=torch.bool, device=dev))
    g = la.lloyd_assign_gated(*gargs, block_n=bn, tps=tps)
    gw = la.lloyd_assign_gated_torch(*gargs, block_n=bn, tps=tps)
    tol = d2_tol(torch, nr, c)
    held("K6 d=60000 k=4", (g[0], g[1], g[3], g[4], g[5], g[6]),
         (gw[0], gw[1], gw[3], gw[4], gw[5], gw[6]), x, tol, bn=bn)
    held("K3 d=60000 k=4", la.lloyd_assign_tiled(x, nr, c, block_n=bn,
                                                 tps=tps),
         la.lloyd_assign_tiled_torch(x, nr, c, block_n=bn, tps=tps), x, tol,
         bn=bn)
    del g, gw, gargs
    bn = eng.backend.seed_tile(n, d, k)
    check(kd.prologue_route(d, bn) == 0, "K1 d=60000: not the wide route")
    try:
        kd.seed_prologue_template(x, bn)
        torch.cuda.synchronize()
        refused = False
    except KernelFailureError:
        refused = True
    check(refused, "K1 d=60000: the template entry did not refuse")
    got = kd.seed_prologue(x, bn)
    check(all(bits_equal(torch, a, b) for a, b in
              zip(got, kd.seed_prologue(x, bn))), "K1 d=60000: two launches "
          "differ")
    check(torch.equal(got[0], bounds.point_norms(x)),
          "K1 d=60000: norms are not bitwise bounds.point_norms")
    want = kd.seed_prologue_torch(x, bn)
    scale = float(x.abs().max())
    err = float((got[1] - want[1]).abs().max())
    check(err <= bn * EPS32 * scale, f"K1 d=60000: centers err {err}")
    for g_, w_, what in zip(got[2:], want[2:], ("radii", "center_d")):
        check(bool(((g_ - w_).abs() <= d * EPS32 * w_.abs() + 1e-6).all()),
              f"K1 d=60000: {what} past d roundings of the twin")
    ms = gpu_ms(torch, lambda: kd.seed_prologue(x, bn))
    out["K1 d=60000"] = dict(block_n=bn, route="wide", max_abs_err=err,
                             ms=ms)
    print(f"K1 d={d} block_n={bn} (wide route): the template entry refuses; "
          f"norms bitwise, centers err {err:.3g}, radii and center_d within "
          f"d roundings of the twin; {ms:.4f} ms")
    # the flat seeding on 8 clusters, one a seed: past the clusters, seeds
    # would be drawn among within-cluster D² of about 12 that the card's
    # and the CPU's matmul forms give a few units apart (D² tolerance 864)
    del x, xc, c, got, want, res
    x, _ = lattice(torch, gen, dev, n, d, 8)
    xc = x.cpu()
    nr = bounds.point_norms(x)
    draws = Draws.sample(n, 8, generator=torch.Generator().manual_seed(5),
                         device=dev, max_attempts=8)
    kw = dict(sampler="rejection", proposal="flat", refresh_block=8)
    rej = counted("flat rejection seeding d=60000 k=8", ["row_min_d2"],
                  lambda: eng.seed(x, 8, draws=draws, **kw))
    off = ung.seed(x, 8, draws=draws, **kw)
    check(same_seeds(torch, rej, off)
          and torch.equal(rej.proposals, off.proposals)
          and torch.equal(rej.accepts, off.accepts),
          "flat rejection d=60000: gated is not bitwise ungated")
    plain_seeds("flat rejection seeding d=60000 k=8", rej,
                cpu.seed(xc, 8, draws=draws.to("cpu"), **kw), nr)
    check(out["launches"]["flat rejection seeding d=60000 k=8"]["row_min_d2"]
          == int((rej.proposals > 0).sum()),
          "flat rejection d=60000: not one K11 launch a round")
    check(len(set(rej.indices.tolist())) == 8
          and bool(torch.isfinite(rej.min_d2).all()),
          "flat rejection d=60000: seeds malformed")
    idx = torch.randint(n, (8,), generator=gen, device=dev)
    pend = rej.centroids.contiguous()
    for cnt in (0, 1, 8):
        same_bits(torch, f"K11 d=60000 count={cnt}",
                  (kd.row_min_d2(x, idx, pend, cnt),),
                  (kd.row_min_d2_torch(x, idx, pend, cnt),))
    print(f"flat rejection seeding d={d} k=8: {len(set(rej.indices.tolist()))}"
          f" distinct seeds, K11 launches "
          f"{out['launches']['flat rejection seeding d=60000 k=8']['row_min_d2']}"
          f" (one a round); K11 on 8 rows bitwise the twin at count 0, 1, 8")
    del x, xc, pend, nr, off
    torch.cuda.empty_cache()

    # K12 past its staging: hier rejection seeding at d = 8,000 with
    # refresh_block 8 (a (8, 8,000) pending block, 64,000 floats past the
    # old 58,112), counted; K12 on that block bitwise its twin
    n, d, k = 20_000, 8000, 16
    x, _ = lattice(torch, gen, dev, n, d, k)
    draws = Draws.sample(n, k, generator=torch.Generator().manual_seed(6),
                         device=dev, max_attempts=8)
    kw = dict(sampler="rejection", proposal="hier", refresh_block=8)
    rej = counted("hier rejection seeding d=8000 k=16",
                  ["seed_prologue", "tile_cap", "row_min_d2"],
                  lambda: eng.seed(x, k, draws=draws, **kw))
    check(len(set(rej.indices.tolist())) == k
          and bool(torch.isfinite(rej.min_d2).all()),
          "hier rejection d=8000: seeds malformed")
    plain_seeds("hier rejection seeding d=8000 k=16", rej,
                cpu.seed(x.cpu(), k, draws=draws.to("cpu"), **kw),
                bounds.point_norms(x))
    check(4 * 8 * d > ops.SMEM_LIMIT, "K12 d=8000: not past the old cap")
    _, centers, radii, _ = kd.seed_prologue(x, eng.backend.seed_tile(n, d, 1))
    pend = rej.centroids[:8].contiguous()
    for cnt in (0, 1, 8):
        same_bits(torch, f"K12 (8, {d}) count={cnt}",
                  (kd.tile_cap(centers, radii, pend, cnt),),
                  (kd.tile_cap_torch(centers, radii, pend, cnt),))
    out["K12 (8, 8000)"] = dict(
        ms=gpu_ms(torch, lambda: kd.tile_cap(centers, radii, pend, 8)))
    print(f"hier rejection seeding d={d} k={k}, refresh_block 8: {k} distinct "
          f"seeds, launches "
          f"{out['launches']['hier rejection seeding d=8000 k=16']}; K12 on "
          f"the (8, {d}) block bitwise the twin at count 0, 1, 8, "
          f"{out['K12 (8, 8000)']['ms']:.4f} ms")
    return out


def ivf_phase(torch, ops, bounds, telemetry, ClusterEngine, Draws, cfg, paper,
              full, dev, launches, profile, kv_shape, data):
    """Phase 8: IVF serving at ``cfg`` on the ``data`` case ("latent" or
    "isotropic"), KV-cache PQ of one cache of ``kv_shape`` (layers, kv
    heads, head_dim, tokens) and ``order=`` at ``full`` (see the module
    docstring); with ``profile``, the build and one search per mode
    traced. Returns (cases, report, the dense cache, its PQ form)."""
    from repro_torch.data import blobs_batched
    from repro_torch.data.ordering import inverse_permutation, morton_order
    from repro_torch.kernels import ivf_scan as ks
    from repro_torch.kernels import lloyd_assign as la
    from repro_torch.serve import IvfIndex, kvquant
    from repro_torch.serve import ivf as ivf_mod
    from repro_torch.testing import IVF_OFFSET_FAULTS, corrupt_list_offsets

    out, cases = {"data": data}, {"K13": [], "K14": []}
    n, d, nq, k = cfg.n_points, cfg.dim, cfg.n_queries, cfg.k
    t8 = time.perf_counter()

    def lap(what):
        print(f"  [phase 8 +{time.perf_counter() - t8:.1f} s] {what}")
    # The data are an assumption, not a measurement of SIFT: rows of
    # SIFT's width whose variance lies in few directions ("latent"): 1,024
    # blobs (spread 0.05) in a 16-dimensional latent cube, mapped to d
    # dimensions by one Gaussian matrix, plus isotropic noise of 0.01. The
    # latent width, blob count, spread and noise are chosen, with no
    # published source. "isotropic" draws the 1,024 blobs in all d
    # dimensions instead (k-means then leaves a few hub lists near the
    # cube's centre that every query probes).
    g = torch.Generator(device=dev).manual_seed(2)
    if data == "latent":
        latent = blobs_batched(1, n + nq, 16, 1024, generator=g)[0]
        lift = torch.randn((16, d), generator=g, device=dev) / 4.0
        allp = latent @ lift
        allp += 0.01 * torch.randn(allp.shape, generator=g, device=dev)
        del latent
    else:
        allp = blobs_batched(1, n + nq, d, 1024, generator=g)[0]
    base, queries = allp[:n].contiguous(), allp[n:].contiguous()
    del allp
    eng = ClusterEngine(device="cuda")
    # the build's K6 launches are recorded (their arguments) for the K6
    # case below
    k6_calls = []
    k6 = la.lloyd_assign_gated

    def recorded(*a, **kw):
        k6_calls.append((a, kw))
        return k6(*a, **kw)
    la.lloyd_assign_gated = recorded
    try:
        idx, build_s, got = counted(torch, ops, lambda: IvfIndex.build(
            base, cfg.nlist, engine=eng, layout="label",
            pq_nsub=cfg.pq_nsub, max_iters=cfg.max_iters,
            generator=torch.Generator().manual_seed(0)))
    finally:
        la.lloyd_assign_gated = k6
    out.update(build_s=build_s, block_n=idx.block_n, n_tiles=idx.n_tiles,
               build_launches={k_: c for k_, c in got.items() if c})
    check(len(k6_calls) == got["lloyd_assign_gated"] > 0,
          f"the build's K6 calls: {len(k6_calls)} recorded, "
          f"{got['lloyd_assign_gated']} counted")
    if profile:
        p = profile_call(torch, lambda: IvfIndex.build(
            base, cfg.nlist, engine=eng, layout="label", pq_nsub=cfg.pq_nsub,
            max_iters=cfg.max_iters,
            generator=torch.Generator().manual_seed(0)))
        out["profile_build"] = p
        print_profile("ivf build", p)
    print(f"IVF build n={n} d={d} nlist={cfg.nlist} pq_nsub={cfg.pq_nsub} "
          f"(max_iters {cfg.max_iters}): {build_s:.3f} s, block_n "
          f"{idx.block_n}, {idx.n_tiles} tiles, list sizes "
          f"{int(idx.counts.min())}-{int(idx.counts.max())}; launches "
          f"{out['build_launches']}")
    del base
    cases["K6 ivf"] = k6_build_case(torch, la, ops, bounds, k6_calls)
    del k6_calls
    lap("K6 at the build's shape")

    def maps(q, nprobe):
        probed, qdots = ivf_mod._route(
            q, idx.centroids, idx.centroid_norms, idx.super_centers,
            idx.super_radii, idx.super_sizes, nprobe=nprobe)
        tiles = (probed.float() @ idx.list_tiles.float()) > 0.0
        ids, n_active = bounds.compact_ids(tiles)
        return qdots, ids, n_active

    pq = idx.pq

    def k13_args(q, nprobe):
        _, ids, n_active = maps(q, nprobe)
        return (q, idx.points, idx.norms, idx.centers, idx.radii, ids,
                n_active)

    def k14_args(q, nprobe):
        qdots, ids, n_active = maps(q, nprobe)
        return (q, ivf_mod._adc_lut(q, pq.codebook), qdots, pq.codes,
                idx.labels, pq.u, pq.centers, pq.radii, ids, n_active)

    kw = dict(k=k, block_n=idx.block_n)
    tol13 = d2_tol(torch, idx.norms, queries)
    tol14 = d2_tol(torch, pq.u, queries)
    chunk = 256
    for nprobe in (cfg.nprobe, cfg.nlist):
        q = queries[:chunk]
        for name, fn, twin, args, tol in (
                ("K13", ks.ivf_scan, ks.ivf_scan_torch, k13_args(q, nprobe),
                 tol13),
                ("K14", ks.ivf_adc_scan, ks.ivf_adc_scan_torch,
                 k14_args(q, nprobe), tol14)):
            c = scan_case(torch, name, fn, twin, args, kw, tol, nprobe, chunk)
            c["n"] = n
            cases[name].append(c)
            print(f"{name} nprobe={nprobe} ({chunk} queries): err "
                  f"{c['max_abs_err']:.3g} (tol {c['tol']:.3g}), bitwise the "
                  f"twin: {c['bitwise']}, {c['gate_skipped']} of "
                  f"{c['probed_tiles']} probed tiles skipped; gate on == "
                  f"off, two launches bitwise")
    torch.cuda.empty_cache()

    lap("twins checked")
    # exactness: full probe is the oracle; ADC is decode-then-exact
    q64 = queries[:64]
    r = idx.search(q64, k, nprobe=cfg.nlist)
    ei, ev = idx.exhaustive(q64, k)
    check(torch.equal(r.indices, ei) and torch.equal(r.dists, ev),
          "search(nprobe=nlist) is not exhaustive bitwise")
    xhat = (kvquant.decode(pq.codes, pq.codebook)
            + idx.centroids[idx.labels.long()])
    a = idx.search(q64, k, nprobe=cfg.nlist, mode="adc")
    ad, ar = ks.ivf_bruteforce_topk(q64, xhat, bounds.point_norms(xhat), k=k)
    adc_err = float((a.dists - ad).abs().max())
    adc_tol = d2_tol(torch, bounds.point_norms(xhat), q64)
    check(adc_err <= adc_tol, f"ADC differs from decode-then-exact by "
          f"{adc_err:.3g} (tol {adc_tol:.3g})")
    del xhat
    out.update(full_probe_bitwise=True, adc_vs_decode_err=adc_err,
               adc_vs_decode_tol=adc_tol)

    # the whole query set: counters, gating, the offset faults
    ops.reset_launches()
    res = idx.search(queries, k, nprobe=cfg.nprobe)
    check(ops.LAUNCHES["ivf_scan"] == 1, "search did not launch K13 once")
    launches["ivf_scan"] += 1
    telemetry.check_ivf_counters(res.probed_lists, res.probed_tiles,
                                 res.gate_skipped, n_queries=nq,
                                 nlist=idx.nlist, n_tiles=idx.n_tiles)
    skipped = int(res.gate_skipped.sum())
    check(skipped > 0, "the gate skipped nothing on the sorted layout")
    for kind in IVF_OFFSET_FAULTS:
        try:
            corrupt_list_offsets(idx, kind=kind).search(queries[:4], k)
        except ivf_mod.CorruptedStateError:
            continue
        raise AssertionError(f"offset fault {kind} did not raise")
    out.update(probed_tiles=int(res.probed_tiles.sum()),
               gate_skipped=skipped, faults_raise=list(IVF_OFFSET_FAULTS))
    print(f"search of {nq} queries at nprobe={cfg.nprobe}: counters hold, "
          f"{skipped} of {out['probed_tiles']} probed tiles skipped; the "
          f"offset faults {IVF_OFFSET_FAULTS} raise CorruptedStateError")

    lap("full-set checks")
    # kernel timing at the full query set, beside the chunked twins
    for name, fn, twin, args, per_query, row_bytes in (
            ("K13", ks.ivf_scan, ks.ivf_scan_torch,
             k13_args(queries, cfg.nprobe), (0, 5, 6), 4 * d + 4),
            ("K14", ks.ivf_adc_scan, ks.ivf_adc_scan_torch,
             k14_args(queries, cfg.nprobe), (0, 1, 2, 8, 9),
             cfg.pq_nsub + 8)):
        ms = gpu_ms(torch, lambda: fn(*args, **kw), reps=3, warmup=1)
        if name == "K13":   # the tile top-k part with its glue alone
            part_ms = gpu_ms(torch, lambda: ks._launch_topk(
                *args[:5], ks._pair_maps(*args[5:]), k, idx.block_n, True),
                reps=3, warmup=1)
        else:   # K14's part (a) with its glue alone
            part_ms = gpu_ms(torch, lambda: ks._launch_adc_topk(
                *args, ks._pair_start(args[-1]), k, idx.block_n, True),
                reps=3, warmup=1)
        got_full = fn(*args, **kw)
        twin_out = []

        def chunked(twin=twin, args=args, per_query=per_query):
            twin_out.clear()
            for i in range(0, nq, 2048):
                twin_out.append(twin(*(a[i:i + 2048] if j in per_query
                                       else a for j, a in enumerate(args)),
                                     **kw))
        plain_ms = gpu_ms(torch, chunked, reps=1, warmup=0)
        check(all(torch.equal(a, torch.cat([o[i] for o in twin_out]))
                  for i, a in enumerate(got_full)),
              f"{name} Q={nq}: dists, rows or gate_skipped not bitwise the "
              f"chunked twin's")
        # the least the scan must do. Bytes: every probed row once (the
        # queries share them: the union of their probed tiles), each
        # query's tile list, query, LUT and routing dots, the tile balls,
        # the outputs. Operations: each query scores every row of the
        # tiles it probed and the gate let through (a skipped tile holds
        # at most block_n rows, so this count is never above the run's).
        ids_, act = args[-2].long(), args[-1].long()
        tiles = torch.arange(idx.n_tiles, device=dev)
        tile_rows = (n - tiles * idx.block_n).clamp(0, idx.block_n)
        used = tiles[None, :] < act[:, None]
        scored = float((tile_rows[ids_] * used).sum()) \
            - float(got_full[2].sum()) * idx.block_n
        touched = torch.zeros(idx.n_tiles, dtype=torch.bool, device=dev)
        touched[ids_[used]] = True
        once = float(tile_rows[touched].sum())
        del ids_, used
        n_bytes = (once * row_bytes + 4 * (float(act.sum()) + nq)
                   + nq * (4 * d + 8 * k + 4)
                   + idx.n_tiles * 4 * (d + 1))
        if name == "K14":
            n_bytes += args[1].numel() * 4 + args[2].numel() * 4
        flops = scored * (2 * d if name == "K13" else cfg.pq_nsub + 4)
        bms, by = bound_ms(n_bytes, flops)
        if name == "K14":
            # the LUT gathers: n_sub a scored row, 32 to one warp-wide
            # shared-memory load, one load an SM a clock at the card's
            # highest SM clock
            props = torch.cuda.get_device_properties(0)
            cases[name][0]["gather_bound_ms"] = (
                scored * cfg.pq_nsub / 32
                / (props.multi_processor_count * sm_clock_hz()) * 1e3)
        cases[name][0].update(ms=ms, plain_ms=plain_ms, bound_ms=bms,
                              bound_by=by, timed_queries=nq,
                              scored_rows=scored, rows_read_once=once,
                              bitwise_full_set=True)
        cases[name][0].update(tile_topk_ms=part_ms, pairs=float(act.sum()))
        print(f"{name} Q={nq} nprobe={cfg.nprobe}: {ms:.4f} ms"
              + f" (the tile top-k part with its glue {part_ms:.4f} ms, "
              f"{float(act.sum()):.6g} (query, tile) pairs)"
              + f", plain (chunks of 2048 queries) {plain_ms:.4f} ms, "
              f"bitwise the kernel; bound {bms:.4f} ms ({by}; {scored:.6g} "
              f"rows scored, {once:.6g} rows read once)"
              + (f"; the LUT gathers' bound "
                 f"{cases[name][0]['gather_bound_ms']:.4f} ms"
                 if name == "K14" else ""))
        del got_full, twin_out
    torch.cuda.empty_cache()

    lap("kernels timed")
    # end to end: search time and QPS, recall@10 against exhaustive
    truth = idx.exhaustive(queries[:1000], k)[0]
    e2e = []
    for mode in ("exact", "adc"):
        for nprobe in (cfg.nprobe, cfg.nlist):
            idx.search(queries[:256], k, nprobe=nprobe, mode=mode)   # warm
            name = "ivf_scan" if mode == "exact" else "ivf_adc_scan"
            r, sec, got = counted(torch, ops, lambda: idx.search(
                queries, k, nprobe=nprobe, mode=mode))
            check(got[name] == 1, f"search[{mode}] launches {got}")
            launches[name] += 1
            hits = (r.indices[:1000, :, None] == truth[:, None, :]).any(
                dim=2).sum()
            recall = float(hits) / (1000 * k)
            e2e.append(dict(mode=mode, nprobe=nprobe, search_ms=sec * 1e3,
                            qps=nq / sec, recall_at_10=recall))
            print(f"search[{mode}] nprobe={nprobe}: {sec * 1e3:.2f} ms for "
                  f"{nq} queries, {nq / sec:.1f} QPS, recall@{k} "
                  f"{recall:.4f} (1000 queries against exhaustive)")
    out["search"] = e2e
    if profile:
        out["profile"] = {}
        for mode in ("exact", "adc"):
            p = profile_call(torch, lambda: idx.search(
                queries, k, nprobe=cfg.nprobe, mode=mode))
            out["profile"][f"ivf search[{mode}], nprobe {cfg.nprobe}"] = p
            print_profile(f"ivf search[{mode}], nprobe {cfg.nprobe}", p)
    del idx, pq, queries, truth, res
    torch.cuda.empty_cache()

    lap("searches")
    # KV cache: one cache through compress_transformer_cache
    (layers, kvh, hd, seq), n_sub = kv_shape, 16
    g = torch.Generator(device=dev).manual_seed(3)
    cache = {name: torch.randn((layers, 1, seq, kvh, hd), generator=g,
                               device=dev) for name in ("k", "v")}
    cache["pos"] = torch.tensor(seq, device=dev)
    runs = []
    for _ in range(2):
        pqc, sec, got = counted(torch, ops, lambda: (
            kvquant.compress_transformer_cache(
                cache, n_sub=n_sub, generator=torch.Generator()
                .manual_seed(0))))
        runs.append((pqc, sec, got))
    first = runs[0][0]
    check(all(torch.equal(first[f], runs[1][0][f])
              for f in ("k_codes", "v_codes", "k_cb", "v_cb")),
          "compress_transformer_cache: two runs differ")
    sq = err = 0.0
    for name in ("k", "v"):
        for li in range(layers):
            for h in range(kvh):
                x = cache[name][li, :, :, h]
                rec = kvquant.decode(first[f"{name}_codes"][li, :, :, h],
                                     kvquant.PQCodebook(
                                         first[f"{name}_cb"][li, h]))
                err += float(((rec - x).double() ** 2).sum())
                sq += float((x.double() ** 2).sum())
    raw = sum(cache[nm].numel() * cache[nm].element_size()
              for nm in ("k", "v"))
    comp = sum(first[f].numel() * first[f].element_size()
               for f in ("k_codes", "v_codes", "k_cb", "v_cb"))
    got = runs[0][2]
    out["kv_cache"] = dict(seconds=[r[1] for r in runs], rel_error=err / sq,
                           compression=raw / comp, bitwise_repeat=True,
                           launches={k_: c for k_, c in got.items() if c})
    print(f"compress_transformer_cache ({layers} layers, {kvh} kv heads, "
          f"head_dim {hd}, {seq} tokens, n_sub {n_sub}, fp32): "
          f"{runs[0][1]:.3f} / {runs[1][1]:.3f} s, two runs bitwise; "
          f"relative reconstruction error {err / sq:.5f}, compression "
          f"{raw / comp:.2f}x; launches {out['kv_cache']['launches']}")
    del runs   # the dense cache and its PQ form go on to phase 9
    torch.cuda.empty_cache()

    lap("KV cache")
    # order= at the paper's size
    draws = Draws.sample(full.n_points, full.k, device=dev,
                         generator=torch.Generator().manual_seed(0))
    km = [counted(torch, ops, lambda: eng.kmeans(
        paper, full.k, draws=draws, max_iters=full.max_iters,
        order="morton")) for _ in range(2)]
    res = km[0][0]
    perm = morton_order(paper)[0]
    direct = eng.kmeans(paper[perm.long()], full.k, draws=draws,
                        max_iters=full.max_iters)
    inv = inverse_permutation(perm).long()
    check(res.reorder is not None and torch.equal(res.reorder, perm)
          and torch.equal(res.assignment, direct.assignment[inv])
          and same_fit(torch, res, km[1][0])
          and torch.equal(res.reorder, km[1][0].reorder),
          "kmeans(order='morton'): not the reordered fit mapped back, or "
          "two runs differ")
    lap("kmeans(order='morton')")
    out["kmeans_morton"] = dict(
        seconds=[r[1] for r in km], n_iters=res.n_iters,
        fit_skipped=int(res.skipped.sum()), fit_pruned=int(res.pruned.sum()))
    print(f"kmeans(order='morton') at the paper's size: "
          f"{km[0][1]:.3f} / {km[1][1]:.3f} s, assignment in the caller's "
          f"order (the reordered fit mapped back), reorder set, bitwise a "
          f"second run; Lloyd skipped {out['kmeans_morton']['fit_skipped']} "
          f"tiles, pruned {out['kmeans_morton']['fit_pruned']} rows")
    return cases, out, cache, first


def attention_phase(torch, ops, dense, pqc, dev, launches, profile):
    """Phase 9: gemma2-2b attention (``GEMMA2``) over phase 8's cache: one
    K16 decode step per ``cache_len`` over its PQ form ``pqc`` and K15
    prefill at the full context (see the module docstring); with
    ``profile``, one decode step traced."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import pq_decode as pqd
    sdpa = torch.nn.functional.scaled_dot_product_attention

    L, H, KH, hd = (GEMMA2[k] for k in ("layers", "heads", "kv_heads",
                                        "head_dim"))
    ctx, window, cap = GEMMA2["context"], GEMMA2["window"], GEMMA2["softcap"]
    n_sub = pqc["k_codes"].shape[-1]
    out, cases = {}, {"K15": [], "K16": []}
    g = torch.Generator(device=dev).manual_seed(4)
    t9 = time.perf_counter()

    def lap(what):
        print(f"  [phase 9 +{time.perf_counter() - t9:.1f} s] {what}")

    def layer(li):
        return [pqc[f][li] for f in ("k_codes", "v_codes", "k_cb", "v_cb")]

    # K16: one decode step, a query per layer, at Gemma 2's context (an int)
    # and one short of it (a ragged last chunk; a 0-d tensor on the card, as
    # a server keeps it); 2e-4 is the reference's tolerance
    # (tests/test_pq_decode.py:63)
    qs = torch.randn((L, 1, 1, H, hd), generator=g, device=dev)
    pqd.pq_decode_attention(qs[0], *layer(0), ctx)   # load the library
    for cache_len, arg in ((ctx, ctx), (ctx - 1, torch.tensor(
            ctx - 1, dtype=torch.int32, device=dev))):
        outs, step_s, got = counted(torch, ops, lambda: [
            pqd.pq_decode_attention(qs[li], *layer(li), arg)
            for li in range(L)])
        check(got["pq_decode_attention"] == L and sum(got.values()) == L,
              f"decode step at cache_len {cache_len}: launches {got}, want "
              f"{L} K16")
        launches["pq_decode_attention"] += L
        check(all(not c.any() for key, c in ops._ARRIVALS.items()
                  if key[0] == "pq_decode_attention"),
              f"decode step at cache_len {cache_len}: K16's arrival counters "
              "not back at 0")
        err = err_k15 = err_tpl = sq = num = 0.0
        for li in range(L):
            o = outs[li]
            check(o.shape == (1, 1, H, hd) and bool(torch.isfinite(o).all()),
                  f"K16 layer {li}: output malformed")
            check(torch.equal(o, pqd.pq_decode_attention(
                qs[li], *layer(li), arg)),
                f"K16 layer {li}: two launches differ")
            twin = pqd.pq_decode_attention_torch(qs[li], *layer(li), arg)
            err = max(err, float((o - twin).abs().max()))
            err_tpl = max(err_tpl, float((o - pqd.pq_decode_attention_template(
                qs[li], *layer(li), arg)).abs().max()))
            kc, vc, kcb, vcb = layer(li)
            rec = fa.flash_attention(
                qs[li], pqd.reconstruct(kc[:, :cache_len], kcb),
                pqd.reconstruct(vc[:, :cache_len], vcb), causal=False)
            err_k15 = max(err_k15, float((o - rec).abs().max()))
            full = fa.flash_attention(
                qs[li], dense["k"][li][:, :cache_len].contiguous(),
                dense["v"][li][:, :cache_len].contiguous(), causal=False)
            num += float(((o - full).double() ** 2).sum())
            sq += float((full.double() ** 2).sum())
        check(err <= 2e-4 and err_k15 <= 2e-4 and err_tpl <= 2e-4,
              f"K16 at cache_len {cache_len}: |K16 - twin| {err:.3g}, "
              f"|K16 - K15 over the reconstruction| {err_k15:.3g}, |K16 - "
              f"template entry| {err_tpl:.3g} (tol 2e-4)")
        rel = math.sqrt(num / sq)
        cases["K16"].append(dict(n=ctx, cache_len=cache_len,
                                 step_ms=step_s * 1e3,
                                 max_abs_err=err, err_vs_k15=err_k15,
                                 err_vs_template=err_tpl,
                                 rel_err_vs_dense=rel, bitwise_repeat=True))
        print(f"K16 decode step, {L} layers at cache_len {cache_len}: "
              f"{step_s * 1e3:.3f} ms host clock, launches "
              f"{ {k: c for k, c in got.items() if c} }; |K16 - "
              f"twin| {err:.3g}, |K16 - K15 over the reconstructed cache| "
              f"{err_k15:.3g}, |K16 - template entry| {err_tpl:.3g} (tol "
              f"2e-4), two launches bitwise, arrival counters at 0; "
              f"relative error against K15 over the uncompressed cache "
              f"{rel:.5f}")
    # one layer's launch beside its bound: the codes of the valid positions
    # and both codebooks read once, q read and the output written; the LUT,
    # the scores' lookups and P.V
    c16 = cases["K16"][0]
    ms = gpu_ms(torch, lambda: pqd.pq_decode_attention(qs[0], *layer(0),
                                                       ctx))
    template_ms = gpu_ms(torch, lambda: pqd.pq_decode_attention_template(
        qs[0], *layer(0), ctx))
    one = torch.zeros(1, device=dev)
    floor_ms = gpu_ms(torch, lambda: one.add_(1.0))
    plain_ms = gpu_ms(torch, lambda: pqd.pq_decode_attention_torch(
        qs[0], *layer(0), ctx), reps=3, warmup=1)
    n_bytes = (2 * ctx * KH * n_sub + 2 * pqc["k_cb"][0].numel() * 4
               + 2 * H * hd * 4)
    flops = 2 * H * 256 * hd + H * ctx * n_sub + 2 * H * ctx * hd
    bms, by = bound_ms(n_bytes, flops)
    per_call = device_launches(
        torch, lambda: pqd.pq_decode_attention(qs[0], *layer(0), ctx))
    check(per_call == {"pq_lut_kernel": 1.0, "decode_kernel": 1.0},
          f"K16: a call should launch pq_lut_kernel and decode_kernel once "
          f"each; the profiler recorded {per_call} a call")
    # the whole step on the device: 26 launches queued behind a sleep
    step = {what: gpu_ms(torch, lambda: [fn(qs[li], *layer(li), ctx)
                                         for li in range(L)], reps=5)
            for what, fn in (("K16", pqd.pq_decode_attention),
                             ("template", pqd.pq_decode_attention_template))}
    c16.update(ms=ms, template_ms=template_ms, launch_floor_ms=floor_ms,
               plain_ms=plain_ms, bound_ms=bms, bound_by=by,
               library_ms=None, device_launches_per_call=per_call,
               step_device_ms=step["K16"],
               template_step_device_ms=step["template"])
    print(f"K16 one layer at cache_len {ctx}: {ms:.4f} ms, template entry "
          f"{template_ms:.4f} ms, launch floor (a one-element add) "
          f"{floor_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.6f} ms "
          f"({by}; {n_bytes} bytes, {flops} flops); device launches a K16 "
          f"call (torch.profiler) {per_call}; the {L}-layer step by CUDA events "
          f"{step['K16']:.4f} ms, template entry {step['template']:.4f} ms")
    lap("decode")

    # K15 prefill over the full context: a global (causal) and a local
    # (window) layer, fp32 and bf16, counted; then each against its twin
    # and a second launch
    q32 = torch.randn((1, ctx, H, hd), generator=g, device=dev)
    k32, v32 = (torch.randn((1, ctx, KH, hd), generator=g, device=dev)
                for _ in range(2))
    runs = [(kind, w, dt) for kind, w in (("global", 0), ("local", window))
            for dt in (torch.float32, torch.bfloat16)]
    inputs = {dt: tuple(x.to(dt) for x in (q32, k32, v32))
              for dt in (torch.float32, torch.bfloat16)}
    prefill, pre_s, got = counted(torch, ops, lambda: [
        fa.flash_attention(*inputs[dt], window=w, cap=cap)
        for _, w, dt in runs])
    check(got["flash_attention"] == 2 and got["flash_attention_bf16"] == 2
          and sum(got.values()) == len(runs),
          f"prefill: launches {got}, want K15 2 fp32 and 2 bf16")
    for name in ("flash_attention", "flash_attention_bf16"):
        launches[name] += got[name]
    for (kind, w, dt), o in zip(runs, prefill):
        kw = dict(window=w, cap=cap)
        check(o.shape == q32.shape and o.dtype == dt
              and bool(torch.isfinite(o).all()),
              f"K15 {kind} {dt}: output malformed")
        check(torch.equal(o, fa.flash_attention(*inputs[dt], **kw)),
              f"K15 {kind} {dt}: two launches differ")
        twin = fa.flash_attention_torch(*inputs[dt], **kw).float()
        diff = (o.float() - twin).abs()
        err = float(diff.max())
        # fp32: two summation orders of the same fp32 work; bf16: both round
        # fp32 results once, so one bf16 ulp (2^-7 relative) apart at most
        ok = diff <= (2e-5 if dt == torch.float32
                      else 1e-5 + 8e-3 * twin.abs())
        check(bool(ok.all()),
              f"K15 {kind} {dt}: |kernel - twin| {err:.3g} past tolerance")
        del twin, diff, ok
        ms = gpu_ms(torch, lambda: fa.flash_attention(*inputs[dt], **kw),
                    reps=3, warmup=1)
        # pairs a query row attends: causal, within the window when local
        per_row = [min(i + 1, w) if w else i + 1 for i in range(ctx)]
        pairs = H * sum(per_row)
        itemsize = 4 if dt == torch.float32 else 2
        n_bytes = itemsize * (2 * ctx * H * hd + 2 * ctx * KH * hd)
        # fp32: the fastest arithmetic that holds 2e-5 is 3xTF32 (one TF32
        # product misses it), three TF32 products for each fp32 one at
        # TF32's rate; the fp32 rate's figure is printed beside it
        if dt == torch.float32:
            bms, by = bound_ms(n_bytes, 3 * 4 * hd * pairs, TF32_FLOP_PER_S)
        else:
            bms, by = bound_ms(n_bytes, 4 * hd * pairs, BF16_FLOP_PER_S)
        c = dict(n=ctx, layer=kind, window=w, dtype=str(dt).split(".")[-1],
                 cap=cap, max_abs_err=err, ms=ms, bound_ms=bms, bound_by=by,
                 pairs=pairs, bitwise_repeat=True, library_ms=None)
        runs_at = ""
        if dt == torch.float32:
            c["bound_fp32_ms"] = bound_ms(n_bytes, 4 * hd * pairs)[0]
            runs_at = (f", the 3xTF32 products at TF32's rate; at fp32's "
                       f"rate {c['bound_fp32_ms']:.4f} ms")
        if kind == "global":
            c["plain_ms"] = gpu_ms(torch, lambda: fa.flash_attention_torch(
                *inputs[dt], **kw), reps=1, warmup=0)
        cases["K15"].append(c)
        print(f"K15 prefill {kind} {c['dtype']} (Sq = Skv = {ctx}, window "
              f"{w}, cap {cap}): {ms:.4f} ms, bound {bms:.4f} ms ({by}; "
              f"{pairs} pairs){runs_at}, |kernel - twin| {err:.3g}, two "
              f"launches bitwise" + (f"; plain {c['plain_ms']:.4f} ms"
                                     if "plain_ms" in c else ""))
    lap("prefill")
    # the yardstick, cap 0 only (SDPA has no softcap): K15 at cap 0 beside
    # one SDPA call on the global layer
    for dt, c in ((torch.float32, cases["K15"][0]),
                  (torch.bfloat16, cases["K15"][1])):
        qq, kk, vv = inputs[dt]
        mine = fa.flash_attention(qq, kk, vv, cap=0.0)
        lib = sdpa(qq.transpose(1, 2), kk.transpose(1, 2), vv.transpose(1, 2),
                   is_causal=True, enable_gqa=True).transpose(1, 2)
        diff = float((mine.float() - lib.float()).abs().max())
        c["ms_cap0"] = gpu_ms(torch, lambda: fa.flash_attention(
            qq, kk, vv, cap=0.0), reps=3, warmup=1)
        c["library_ms"] = gpu_ms(torch, lambda: sdpa(
            qq.transpose(1, 2), kk.transpose(1, 2), vv.transpose(1, 2),
            is_causal=True, enable_gqa=True), reps=3, warmup=1)
        c["library_max_abs_diff"] = diff
        if dt == torch.float32:
            check(diff <= 1e-4, f"SDPA computes another function: |K15 - "
                  f"SDPA| {diff:.3g} at cap 0")
        bounds_ = (f"; bounds {c['bound_ms']:.4f} ms for the 3xTF32 "
                   f"products, {c['bound_fp32_ms']:.4f} ms at fp32's rate"
                   if dt == torch.float32 else "")
        print(f"cap 0, global, {c['dtype']}: K15 {c['ms_cap0']:.4f} ms, "
              f"scaled_dot_product_attention {c['library_ms']:.4f} ms, "
              f"|K15 - SDPA| {diff:.3g}{bounds_}")
        del mine, lib
    lap("library")
    # the prefill's four launches: host wall against their device time
    busy = sum(c["ms"] for c in cases["K15"])
    out["prefill"] = dict(wall_ms=pre_s * 1e3, device_ms=busy,
                          idle_share=1 - busy / (pre_s * 1e3))
    print(f"prefill, {len(runs)} launches: {pre_s * 1e3:.3f} ms host clock, "
          f"{busy:.3f} ms of kernel time (CUDA events), idle share "
          f"{out['prefill']['idle_share']:.3f}")
    if profile:
        name = f"K16 decode step ({L} layers)"

        def step():
            return [pqd.pq_decode_attention(qs[li], *layer(li), ctx)
                    for li in range(L)]
        step()
        out["profile"] = {name: profile_call(torch, step)}
        print_profile(name, out["profile"][name])
    del prefill, inputs
    torch.cuda.empty_cache()
    return cases, out


def semdedup_data(torch, gen, n: int, d: int, n_dups: int):
    """SemDeDup's rows, made on the card from ``gen``: n embeddings of
    width d from 1,024 topics (a row is its topic's center plus noise of
    the same scale, so two rows of one topic sit at cosine ~0.5 and no
    natural pair nears 0.95), then ``n_dups`` rows past the first tenth
    overwritten by a near copy (noise 0.05 a coordinate, cosine ~0.9994)
    of a row before them. Returns (rows, the copies' rows, their
    sources' rows)."""
    dev = gen.device
    centers = torch.randn((1024, d), generator=gen, device=dev)
    topic = torch.randint(1024, (n,), generator=gen, device=dev)
    x = centers[topic] + torch.randn((n, d), generator=gen, device=dev)
    dups = torch.randperm(n - n // 10, generator=gen,
                          device=dev)[:n_dups] + n // 10
    src = (torch.rand(n_dups, generator=gen, device=dev) * dups).long()
    x[dups] = x[src] + 0.05 * torch.randn((n_dups, d), generator=gen,
                                          device=dev)
    return x.contiguous(), dups, src


def dedup_by_cluster(torch, x, assignment, threshold: float):
    """The plain SemDeDup check, independent of the port's: the rows
    sorted by cluster (stably, so each cluster keeps its row order), then
    each cluster's own cosine block, a row dropped when an earlier row of
    its cluster is above ``threshold``. Returns (keep mask, each row's
    largest cosine to an earlier row of its cluster)."""
    xn = x / (torch.sqrt((x * x).sum(dim=1, keepdim=True)) + 1e-8)
    order = torch.argsort(assignment, stable=True)
    best = torch.full((x.shape[0],), -torch.inf, device=x.device)
    start = 0
    for size in torch.bincount(assignment.long()).tolist():
        rows = order[start:start + size]
        start += size
        if size > 1:
            sim = xn[rows] @ xn[rows].T
            earlier = torch.ones_like(sim, dtype=torch.bool).tril(-1)
            best[rows] = torch.where(earlier, sim, -torch.inf).amax(dim=1)
    return ~(best > threshold), best


def events_ms(torch, fn) -> float:
    """One call's device time by CUDA events (launches not queued behind
    a sleep: the host's issue time is inside)."""
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b)


def semdedup_part(torch, ops, kd, la, bounds, eng, fused, gen, run, cases,
                  sn: int, sd: int, sk: int, n_dups: int, thr: float) -> dict:
    """Phase 10's SemDeDup: ``semdedup`` on ``sn`` rows of width ``sd``
    with ``n_dups`` planted copies at k = ``sk`` through ``run`` (counted),
    its keep mask against the per-cluster plain pass, its clustering
    against the fused twin's, the planted copies' fate, K5 and K6 at its
    shapes appended to ``cases``, and its (2048, n) products beside their
    bound. Returns the part's report."""
    from repro_torch.core import point_d2
    from repro_torch.core.quality import balance
    from repro_torch.data import semdedup

    emb, dups, src = semdedup_data(torch, torch.Generator(device=eng.device)
                                   .manual_seed(15), sn, sd, n_dups)
    dd, dd_s, got = run("semdedup", lambda: semdedup(
        emb, k=sk, threshold=thr,
        generator=torch.Generator().manual_seed(15)))
    check(got.get("seed_prologue") == 1
          and got.get("distance_min_update_gated") == sk
          and got.get("lloyd_assign_gated", 0) >= 1,
          f"semdedup: launches {got}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    keep, best = dedup_by_cluster(torch, emb, dd.assignment, thr)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    diff = (keep != dd.keep_mask).nonzero().reshape(-1)
    check(bool(((best[diff] - thr).abs() <= 1e-5).all()),
          f"semdedup: {int(diff.numel())} rows differ from the per-cluster "
          f"pass beyond the threshold's rounding")
    check(int(dd.n_kept) == int(dd.keep_mask.sum()), "semdedup: n_kept")
    # the clustering it checks within: its kmeans is the seeding then the
    # fit, bitwise; its labels are the plain assignment against the
    # centroids its last iteration read (a fit one iteration shorter ends
    # on them), outside near-ties; the fused twin's seeds from the same
    # draws (counted beside: a cdf draw may fall the other way on a D²
    # rounding), and the twin's fit from the kernels' own seeds within
    # 1e-4 in inertia (the same Lloyd steps in another fp32 summation
    # order; labels on near-ties part the two runs, so theirs are counted)
    xn = emb / (torch.sqrt((emb * emb).sum(dim=1, keepdim=True)) + 1e-8)
    norms = bounds.point_norms(xn)
    sgen = lambda: torch.Generator().manual_seed(15)  # noqa: E731
    seed_ms = events_ms(torch, lambda: eng.seed(xn, sk, generator=sgen()))
    sseeds = eng.seed(xn, sk, generator=sgen())
    sfit = eng.fit(xn, sseeds.centroids, max_iters=25)
    check(torch.equal(sfit.assignment, dd.assignment),
          "semdedup: its labels are not its seeding then its fit")
    last = int(sfit.n_iters)
    read = (sseeds.centroids if last == 1 else
            eng.fit(xn, sseeds.centroids, max_iters=last - 1).centroids)
    near, bad = label_diffs(torch, la.tile_d2(xn, read, norms),
                            sfit.assignment,
                            la.lloyd_assign_torch(xn, norms, read)[0],
                            d2_tol(torch, norms, read))
    check(bad == 0, f"semdedup: {bad} labels differ from the plain "
          f"assignment beyond near-ties")
    seeds_same = int((fused.seed(xn, sk, generator=sgen()).indices
                      == sseeds.indices).sum())
    tfit = fused.fit(xn, sseeds.centroids, max_iters=25)
    rel = abs(float(tfit.inertia) - float(sfit.inertia)) / float(
        sfit.inertia)
    moved = int((tfit.assignment != sfit.assignment).sum())
    check(rel <= 1e-4, f"semdedup: the fit's inertia differs from the "
          f"fused twin's from its seeds by {rel:.3g}")
    fit_prof = profile_call(torch, lambda: eng.fit(
        xn, sseeds.centroids, max_iters=25), cpu=False)
    print_profile("semdedup's fit", fit_prof)
    # a copy in its source's cluster must go; one the clustering put in
    # another cluster escapes the within-cluster check, by design, and the
    # escapes stay a small share (a random split into sk clusters lets
    # ~(sk-1)/sk of them through)
    together = dd.assignment[dups] == dd.assignment[src]
    check(not bool(dd.keep_mask[dups[together]].any()),
          f"semdedup: {int(dd.keep_mask[dups[together]].sum())} planted "
          f"copies kept beside their source")
    escaped = int((~together).sum())
    twin_escaped = int((tfit.assignment[dups]
                        != tfit.assignment[src]).sum())
    check(escaped <= n_dups // 20,
          f"semdedup: {escaped} of {n_dups} planted copies clustered apart "
          f"from their source")
    kept_copies = int(dd.keep_mask[dups].sum())
    # K5 and K6 at the shapes SemDeDup gives them: K5 at m = 1 on a
    # seeding state, K6 from the fit's first state (every tile, the gate's)
    scache = bounds.prologue(xn, ops.choose_block_n(sn, sd, 50))
    cases["K5"].append(k5_case(
        torch, kd, bounds, ops, xn, scache, point_d2(xn, xn[dups[0]]),
        xn[src[:1]].contiguous(), "gate", True))
    del scache
    scache = bounds.prologue(xn, ops.choose_block_n(sn, sd, sk))
    cases["K6"].extend(k6_case(torch, la, bounds, ops, xn, scache, sk, gen,
                               masks=("all", "gate")))
    del scache
    for c in (cases["K5"][-1], *cases["K6"][-2:]):
        print(f"  {'K5' if 'm' in c else 'K6'} at SemDeDup's shape n={c['n']}"
              f" d={c['d']}" + (f" m={c['m']}" if "m" in c
                                else f" k={c['k']} mask={c['mask']}")
              + f": err {c['max_abs_err']:.3g} (tol {c['tol']:.3g}), "
              f"{c['ms']:.4f} ms, plain {c['plain_ms']:.4f} ms, bound "
              f"{c['bound_ms']:.4f} ms ({c['bound_by']})")
    # the check's (2048, n) products alone, as semdedup runs them

    def products():
        for s_ in range(0, sn, 2048):
            xn[s_:s_ + 2048] @ xn.T

    prod_ms = events_ms(torch, products)
    prod_bound, prod_by = bound_ms(4 * (sn * sd + sn * sn),
                                   2.0 * sn * sn * sd)
    out = dict(
        n=sn, d=sd, k=sk, planted=n_dups, kept=int(dd.n_kept), s=dd_s,
        plain_s=plain_s, seed_events_ms=seed_ms,
        fit_busy_ms=fit_prof["busy_ms"], fit_idle_share=fit_prof["idle_share"],
        fit_top_kernels=dict(list(fit_prof["kernels"].items())[:4]),
        n_iters=last, labels_near_ties=near, twin_seeds_equal=seeds_same,
        twin_inertia_rel=rel, twin_labels_differ=moved, escaped=escaped,
        twin_escaped=twin_escaped, kept_copies=kept_copies,
        launches=got, product_ms=prod_ms, product_bound_ms=prod_bound,
        product_bound_by=prod_by, on_threshold=int(diff.numel()),
        balance=float(balance(dd.assignment, sk)))
    print(f"semdedup ({sn} x {sd}, k = {sk}, threshold {thr}, {n_dups} "
          f"planted): kept {int(dd.n_kept)}; every copy in its source's "
          f"cluster dropped, {escaped} copies in another cluster than their "
          f"source (the twin's fit: {twin_escaped}; {kept_copies} copies "
          f"kept); {int(diff.numel())} rows on the threshold's rounding "
          f"against the per-cluster pass ({plain_s:.3f} s); {dd_s:.3f} s "
          f"host, launches {got}; its seeding {seed_ms:.1f} ms by CUDA "
          f"events, {seeds_same}/{sk} seeds the fused twin's; its fit "
          f"({last} iterations; its labels the plain assignment's but "
          f"{near} on near-ties) device busy "
          f"{fit_prof['busy_ms']:.1f} ms, idle share "
          f"{fit_prof['idle_share']:.3f}, the twin's fit from its seeds: "
          f"inertia rel diff {rel:.3g}, {moved} labels differ; the (2048, "
          f"n) products {prod_ms:.2f} ms by CUDA events, bound "
          f"{prod_bound:.2f} ms ({prod_by}, fp32 at "
          f"{FP32_FLOP_PER_S / 1e12:.0f} TFLOP/s); cluster balance "
          f"{out['balance']:.3f}")
    return out


def init_phase(torch, ops, kd, la, bounds, sampling, ClusterEngine, Draws,
               paper, kvq_pts, full, kvq, dev, launches, gen):
    """Phase 10 (init): the Gumbel sampler at ``FULL`` (gated, ungated,
    the fused twin) and at the codebook sweep (batched), k-means|| at
    ``FULL`` against the fused twin, the three inits' kmeans, serial mode
    against global mode, and SemDeDup at one card's size. Returns (the
    kernel cases at k-means||'s and SemDeDup's shapes, the phase's
    report)."""
    from repro_torch.core import (ParallelDraws, kmeans_parallel,
                                  kmeans_parallel_init, point_d2)

    t10 = time.perf_counter()

    def lap(what):
        print(f"  [phase 10 +{time.perf_counter() - t10:.1f} s] {what}")

    def run(what, fn, want=None):
        # counters zeroed just before and read just after; the launches go
        # to the record's counts
        res, s, got = counted(torch, ops, fn)
        for name in launches:
            launches[name] += got[name]
        if want is not None:
            counted_as(what, got, want)
        return res, s, {nm: c for nm, c in got.items() if c}

    k, n = full.k, paper.shape[0]
    eng = ClusterEngine(device="cuda")
    ungated = ClusterEngine(device="cuda", bounds=False)
    fused = ClusterEngine("fused", device="cuda", bounds=False)
    norms = bounds.point_norms(paper)
    report: dict = {}
    cases = {"K1": [], "K2": [], "K4": [], "K5": [], "K6": []}

    # -- the Gumbel sampler at FULL: gated, ungated, the fused twin ---------
    lap("gumbel seeding at FULL")

    def gdraws(seed, gumbel=True):
        return Draws.sample(n, k, gumbel=gumbel, device=dev,
                            generator=torch.Generator().manual_seed(seed))

    draws = gdraws(10)
    g_on, g_on_s, _ = run("gumbel seed (gated)", lambda: eng.seed(
        paper, k, draws=draws, sampler="gumbel"),
        {"seed_prologue": 1, "distance_min_update_gated": k})
    g_off, g_off_s, _ = run("gumbel seed (ungated)", lambda: ungated.seed(
        paper, k, draws=draws, sampler="gumbel"),
        {"distance_min_update": k})
    check(same_seeds(torch, g_on, g_off),
          "gumbel seeding: gated is not bitwise ungated")
    check(same_seeds(torch, g_on, eng.seed(paper, k, draws=draws,
                                           sampler="gumbel")),
          "gumbel seeding: two runs differ")
    twin = fused.seed(paper, k, draws=draws, sampler="gumbel")
    tol = d2_tol(torch, norms, g_on.centroids)
    g_err = float((g_on.min_d2 - twin.min_d2).abs().max())
    check(torch.equal(g_on.indices, twin.indices) and g_err <= tol,
          f"gumbel seeding: not the fused twin's seeds, or D² err {g_err} "
          f"> {tol}")
    # a round's sampler on the device, beside the tiled and cdf draws
    bn1 = ops.choose_block_n(n, full.dim, 1)
    md, fb = g_on.min_d2, draws.fallback[:1]
    parts = sampling.tile_partials(md, bn1)
    noise = draws.gumbel_round(2, n, dev)
    dev_ms = {
        "noise": gpu_ms(torch, lambda: draws.gumbel_round(2, n, dev),
                        reps=9),
        "gumbel draw": gpu_ms(torch, lambda: sampling.gumbel_categorical(
            noise, fb, md), reps=9),
        "tiled draw": gpu_ms(torch, lambda: sampling.categorical_tiled(
            draws.u[0], fb, md, parts, block_n=bn1), reps=9),
        "cdf draw": gpu_ms(torch, lambda: sampling.categorical_cdf(
            draws.u[0], fb, md), reps=9)}
    host = {s: median_seed_ms(torch, eng, paper, k,
                              gdraws(10, s == "gumbel"), sampler=s)
            for s in ("gumbel", "tiled", "cdf")}
    ev = events_ms(torch, lambda: eng.seed(paper, k, draws=draws,
                                           sampler="gumbel"))
    prof = profile_call(torch, lambda: eng.seed(paper, k, draws=draws,
                                                sampler="gumbel"), cpu=False)
    print_profile("gumbel seed (gated, FULL)", prof)
    report["gumbel_full"] = dict(
        busy_ms=prof["busy_ms"], idle_share=prof["idle_share"],
        top_kernels=dict(list(prof["kernels"].items())[:6]),
        gated_ms=g_on_s * 1e3, ungated_ms=g_off_s * 1e3,
        median_host_ms=host, events_ms=ev, device_ms=dev_ms,
        twin_d2_err=g_err, tol=tol, skipped=int(g_on.skipped.sum()),
        pruned=int(g_on.pruned.sum()))
    print(f"gumbel seed at FULL: gated {g_on_s * 1e3:.2f} ms, ungated "
          f"{g_off_s * 1e3:.2f} ms host, bitwise equal (median of 3: gumbel "
          f"{host['gumbel']:.2f}, tiled {host['tiled']:.2f}, cdf "
          f"{host['cdf']:.2f} ms); {ev:.2f} ms by CUDA events; the fused "
          f"twin's seeds, D² err {g_err:.3g} (tol {tol:.3g}); a round on "
          f"the device: noise {dev_ms['noise']:.4f} ms + draw "
          f"{dev_ms['gumbel draw']:.4f} ms, the tiled draw "
          f"{dev_ms['tiled draw']:.4f} ms, cdf's {dev_ms['cdf draw']:.4f} ms")
    del twin, noise, parts

    # -- batched Gumbel at the codebook sweep -------------------------------
    lap("batched gumbel seeding at kvquant")
    bsz = kvq_pts.shape[0]
    bdraws = Draws.sample_batched(bsz, kvq.n_points, kvq.k, gumbel=True,
                                  generator=torch.Generator().manual_seed(11))
    bres, b_s, _ = run("batched gumbel seed", lambda: eng.seed_batched(
        kvq_pts, kvq.k, draws=bdraws, sampler="gumbel"),
        {"seed_prologue_batched": 1,
         "distance_min_update_gated_batched": kvq.k})
    for b in (0, 1, bsz - 1):
        one = eng.seed(kvq_pts[b], kvq.k, draws=bdraws[b], sampler="gumbel")
        check(all(bits_equal(torch, getattr(bres, f)[b], getattr(one, f))
                  for f in ("indices", "centroids", "min_d2", "skipped",
                            "pruned")),
              f"batched gumbel seeding: problem {b} is not the single run")
    tiled_s = counted(torch, ops, lambda: eng.seed_batched(
        kvq_pts, kvq.k, draws=bdraws, sampler="tiled"))[1]
    report["gumbel_batched"] = dict(s=b_s, tiled_s=tiled_s)
    print(f"batched gumbel seed at kvquant ({bsz} problems): {b_s:.3f} s "
          f"host, the tiled sampler's {tiled_s:.3f} s; rows 0, 1 and B-1 "
          f"bitwise the single runs")
    del bres, bdraws

    # -- k-means|| at FULL --------------------------------------------------
    lap("k-means|| at FULL")
    rounds, l = 5, 2 * k
    n_cand = rounds * l + 1
    pdraws = ParallelDraws.sample(n, k, rounds=rounds, device=dev,
                                  generator=torch.Generator().manual_seed(12))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    kp, kp_s, _ = run("kmeans_parallel_init", lambda: kmeans_parallel_init(
        paper, k, draws=pdraws),
        {"seed_prologue": 2, "distance_min_update_gated": rounds,
         "lloyd_assign": 2, "distance_min_update": k})
    peak = torch.cuda.max_memory_allocated() - base
    check(peak < n * n_cand * 4,
          f"k-means||: {peak} bytes at its peak, an (n, n_cand) matrix's "
          f"{n * n_cand * 4}")
    check(same_seeds(torch, kp, kmeans_parallel_init(paper, k,
                                                     draws=pdraws)),
          "k-means||: two runs differ")
    kp_twin = kmeans_parallel_init(paper, k, draws=pdraws, backend="fused")
    cand = kmeans_parallel.oversample_candidates(paper, k, draws=pdraws)
    cand_twin = kmeans_parallel.oversample_candidates(paper, k, draws=pdraws,
                                                      backend="fused")
    check(torch.equal(cand.indices, cand_twin.indices),
          "k-means||: the candidates are not the fused twin's")
    cands = paper[cand.indices].contiguous()
    lab = la.lloyd_assign(paper, norms, cands, block_n=ops.choose_block_n(
        n, full.dim, n_cand))[0]
    lab_twin = la.lloyd_assign_torch(paper, norms, cands)[0]
    # a row the twin labels otherwise must be a near-tie: both picks' D²
    # (diff-square, fp64) within the tolerance
    ctol = d2_tol(torch, norms, cands)
    moved = (lab != lab_twin).nonzero().reshape(-1)
    x64 = paper[moved].double()
    gap = (((x64 - cands[lab[moved].long()].double()) ** 2).sum(1)
           - ((x64 - cands[lab_twin[moved].long()].double()) ** 2).sum(1))
    check(bool((gap.abs() <= ctol).all()),
          f"k-means||: {int((gap.abs() > ctol).sum())} candidate labels "
          f"differ from the twin's beyond near-ties")
    check(torch.equal(cand.weights, torch.bincount(
        lab.long(), minlength=n_cand).float()),
        "k-means||: the weights are not the counts of K4's labels")
    w_diff = int((cand.weights != cand_twin.weights).sum())
    # the twin's reduce on the kernels' candidates and weights (a label on
    # a near-tie moves a weight by one, and the reduce's draws with it)
    same_w = kmeans_parallel.reduce_candidates(paper, cand, k, draws=pdraws,
                                               backend="fused")
    check(torch.equal(kp.indices, same_w.indices),
          "k-means||: the seeds are not the fused twin's reduce's on the "
          "same candidates and weights")
    twin_seeds = int((kp.indices == kp_twin.indices).sum())
    kp_err = float((kp.min_d2 - same_w.min_d2).abs().max())
    ktol = d2_tol(torch, norms, kp.centroids)
    check(kp_err <= ktol, f"k-means||: final D² err {kp_err} > {ktol}")
    kp_ev = events_ms(torch, lambda: kmeans_parallel_init(paper, k,
                                                          draws=pdraws))
    twin_s = counted(torch, ops, lambda: kmeans_parallel_init(
        paper, k, draws=pdraws, backend="fused"))[1]
    topl_ms = gpu_ms(torch, lambda: sampling.gumbel_topk(
        pdraws.noise[0], sampling.safe_log(kp.min_d2), l), reps=5)
    prof = profile_call(torch, lambda: kmeans_parallel_init(
        paper, k, draws=pdraws), cpu=False)
    print_profile("kmeans_parallel_init (FULL)", prof)
    report["kmeans_parallel"] = dict(
        busy_ms=prof["busy_ms"], idle_share=prof["idle_share"],
        top_kernels=dict(list(prof["kernels"].items())[:6]),
        host_ms=kp_s * 1e3, events_ms=kp_ev, twin_host_ms=twin_s * 1e3,
        peak_bytes=peak, matrix_bytes=n * n_cand * 4, d2_err=kp_err,
        tol=ktol, labels_moved=int(moved.numel()), weights_differ=w_diff,
        zero_weights=int((cand.weights == 0).sum()), topl_ms=topl_ms,
        twin_seeds_equal=twin_seeds)
    print(f"kmeans_parallel_init at FULL (l = {l}, {rounds} rounds, "
          f"{n_cand} candidates): {kp_s * 1e3:.2f} ms host, {kp_ev:.2f} ms "
          f"by CUDA events, peak {peak / 2**20:.1f} MiB (an (n, n_cand) "
          f"matrix: {n * n_cand * 4 / 2**20:.0f} MiB); the fused twin "
          f"{twin_s * 1e3:.2f} ms: the same candidates, "
          f"{int(moved.numel())} labels on near-ties, {w_diff} weights "
          f"differing, {twin_seeds}/{k} seeds equal; its reduce on these "
          f"candidates and weights: the same seeds, final D² err "
          f"{kp_err:.3g} (tol {ktol:.3g}); a round's top-l {topl_ms:.4f} ms "
          f"on the device")
    # the kernels at the shapes k-means|| gives them: K5 at m = l on the
    # m = l prologue's tiles, K4 against the candidates, the reduce's K1
    # and K2 on the candidate rows
    cache = eng.backend.prologue(paper, m=l)
    md0 = point_d2(paper, paper[pdraws.first[0]])
    cases["K5"].append(k5_case(torch, kd, bounds, ops, paper, cache, md0,
                               paper[cand.indices[1:1 + l]].contiguous(),
                               "gate", True))
    cases["K4"].append(k4_case(torch, la, ops, bounds, paper, norms, n_cand,
                               gen))
    cases["K1"].append(k1_case(torch, kd, bounds, cands))
    cases["K2"].append(k2_case(torch, kd, ops, cands,
                               bounds.point_norms(cands), 1, True, gen))
    for name, c in cases.items():
        if not c:
            continue
        c = c[-1]
        print(f"  {name} at k-means||'s shape n={c['n']} d={c['d']}"
              + "".join(f" {key}={c[key]}" for key in ("m", "k") if key in c)
              + f": err {c['max_abs_err']:.3g} (tol {c['tol']:.3g}), "
              f"{c['ms']:.4f} ms, plain {c['plain_ms']:.4f} ms, bound "
              f"{c['bound_ms']:.4f} ms ({c['bound_by']})")
    del cache, md0, cand, cand_twin, kp_twin, same_w, lab, lab_twin

    # -- kmeans(init=) for the three inits at FULL ---------------------------
    lap("kmeans(init=) at FULL")
    inits = {}
    for init, idraws in (("kmeans++", gdraws(13, False)),
                         ("kmeans||", pdraws),
                         ("random", torch.randperm(
                             n, generator=torch.Generator().manual_seed(13)
                         )[:k])):
        res, s, got = run(f"kmeans(init={init!r})", lambda: eng.kmeans(
            paper, k, init=init, draws=idraws, max_iters=full.max_iters))
        check(tuple(res.centroids.shape) == (k, full.dim)
              and bool(torch.isfinite(res.centroids).all())
              and bool(torch.isfinite(res.inertia))
              and int(res.assignment.min()) >= 0
              and int(res.assignment.max()) < k,
              f"kmeans(init={init!r}): output malformed")
        check(same_fit(torch, res, eng.kmeans(paper, k, init=init,
                                              draws=idraws,
                                              max_iters=full.max_iters)),
              f"kmeans(init={init!r}): two runs differ")
        inits[init] = dict(s=s, inertia=float(res.inertia),
                           n_iters=int(res.n_iters), launches=got)
    report["inits"] = inits
    print("kmeans at FULL by init (inertia; n_iters; host s; launches): "
          + "; ".join(f"{i} {v['inertia']:.6g}; {v['n_iters']}; "
                      f"{v['s']:.3f} s; {v['launches']}"
                      for i, v in inits.items()))

    # -- the reference backend's serial mode == its global mode -------------
    lap("serial and global modes at FULL")
    sdraws = gdraws(14, False)
    modes = {}
    for mode in ("serial", "global"):
        e = ClusterEngine(mode, device="cuda")
        res, s, got = counted(torch, ops, lambda: e.seed(paper, k,
                                                         draws=sdraws))
        check(not any(got.values()), f"{mode} mode launched a kernel")
        modes[mode] = (res, s * 1e3)
    check(same_seeds(torch, modes["serial"][0], modes["global"][0]),
          "serial mode is not bitwise global mode on the card")
    report["modes_ms"] = {m: v[1] for m, v in modes.items()}
    print(f"reference backend at FULL: serial {modes['serial'][1]:.2f} ms, "
          f"global {modes['global'][1]:.2f} ms host; the same seeds and D² "
          f"bitwise")
    del modes

    # -- SemDeDup at one card's size -----------------------------------------
    lap("semdedup")
    report["semdedup"] = semdedup_part(
        torch, ops, kd, la, bounds, eng, fused, gen, run, cases,
        200_000, 512, 256, 2_000, 0.95)
    torch.cuda.empty_cache()
    report["seconds"] = time.perf_counter() - t10
    return cases, report


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="also write every measurement here")
    ap.add_argument("--profile", action="store_true",
                    help="also trace seeding and Lloyd at the paper's shape "
                         "with torch.profiler: device time by kernel and "
                         "the device's idle share")
    ap.add_argument("--ivf-data", choices=("latent", "isotropic"),
                    default="latent",
                    help="phase 8's data: blobs in a 16-dimensional latent "
                         "space lifted to d (default), or blobs in all d "
                         "dimensions")
    args = ap.parse_args()
    t_start = time.perf_counter()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import numpy as np
    from repro_torch.core import (ClusterEngine, CudaBackend, Draws, bounds,
                                  sampling, telemetry)
    from repro_torch.configs import FULL, IVF_SIFT1M as IVF
    from repro_torch.configs import KVQUANT_GEMMA2_2B as KVQ
    from repro_torch.data import blobs, blobs_batched
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import kmeans_distance as kd
    from repro_torch.kernels import lloyd_assign as la

    torch.backends.cuda.matmul.allow_tf32 = False   # plain twins in fp32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    report = {"card": card}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    paper_np, labels = blobs(FULL.n_points, FULL.dim, FULL.k, seed=0)
    paper = torch.from_numpy(paper_np).to(dev)
    paper_sorted = torch.from_numpy(
        paper_np[np.argsort(labels, kind="stable")]).to(dev)
    k = FULL.k

    print(f"[{time.perf_counter() - t_start:.1f} s] phase 0")
    # 0. the samplers' prefix sums, run to run: the cdf sampler's over n,
    #    and the tiled sampler's over the n_tiles partials and one window
    bn_full = ops.choose_block_n(FULL.n_points, FULL.dim, FULL.k)
    report["scan_determinism"] = {}
    for size, reps in ((FULL.n_points, 10), (-(-FULL.n_points // bn_full), 50),
                       (bn_full, 50)):
        w = torch.rand(size, generator=gen, device=dev)
        det = scan_determinism(torch, sampling, w, reps)
        report["scan_determinism"][size] = det
        print(f"prefix sums over {size} floats, {reps} runs each: "
              f"torch.cumsum gave {det['torch.cumsum']} distinct results "
              f"({det['torch.cumsum us']:.1f} us per synchronised call), "
              f"sampling.prefix_sum {det['prefix_sum']} "
              f"({det['prefix_sum us']:.1f} us)")
        check(det["prefix_sum"] == 1,
              f"prefix_sum over {size} floats is not deterministic")
    del w
    # ... and batched: row b of a (B, n) scan must be the 1-D scan's bits
    census = scan_row_census(torch, sampling, dev, KVQ.batch, KVQ.n_points)
    report["scan_row_census"] = census
    print(f"one row scanned among 1, 8, 64 and 6656 rows: "
          f"{census['torch.cumsum dim 1']} bit pattern(s) from torch.cumsum "
          f"along dim 1 (width 4096), {census['sampling row scan']} from "
          f"the samplers' row scan (width {sampling.SCAN_BLOCK}); "
          f"prefix_sum rows 0, 1, B-1 of ({KVQ.batch}, {KVQ.n_points}) "
          f"bitwise the 1-D calls: {census['prefix_sum rows bitwise']}")
    check(census["sampling row scan"] == 1
          and census["prefix_sum rows bitwise"],
          "batched prefix sums are not the single ones row by row")

    print(f"[{time.perf_counter() - t_start:.1f} s] phase 1")
    # 1. build
    t0 = time.perf_counter()
    logs = _build.build_all()
    report["build_s"] = time.perf_counter() - t0
    print(f"build: {report['build_s']:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "ptxas info" in line and ("Used" in line or "Compiling" in line
                                         or "Performance Loss" in line):
                print(f"  {name}: {line.strip()}")
    # K15's kernels: no spill, registers at entry for setmaxnreg (two
    # consumer warpgroups raised to 232 from the producer's 40), and on the
    # tensor cores fed by TMA; checked before any launch
    from repro_torch.kernels import flash_attention as fa
    report["k15_build"] = k15_build(_build, logs["flash_attention"])
    check(sum(fn.startswith("flash_tf32") for fn in report["k15_build"])
          == 3 and len(report["k15_build"]) == 6,
          f"K15 instances in the SASS: {sorted(report['k15_build'])}")
    for fn, c in sorted(report["k15_build"].items()):
        check("registers" in c and "spill_bytes" in c,
              f"K15 {fn}: no registers or spills in the ptxas log")
        ptxas = (f"{c['registers']} registers at entry, "
                 f"{c['spill_bytes']} spill bytes")
        if fn.startswith("flash_tf32"):
            c["smem_bytes"] = fa.tf32_smem_bytes(int(fn[-2]))
            ptxas += f", {c['smem_bytes']} bytes of dynamic shared memory"
        print(f"K15 {fn}: {ptxas}; SASS: {c['HGMMA']} HGMMA, "
              f"{c['UTMALDG']} UTMALDG")
        check(c["HGMMA"] > 0 and c["UTMALDG"] > 0,
              f"K15 {fn}: no HGMMA or UTMALDG in its SASS")
        check(c["spill_bytes"] == 0, f"K15 {fn} spills")
        check(c["registers"] >= 168,
              f"K15 {fn}: {c['registers']} registers at entry, too few "
              f"for setmaxnreg to raise two warpgroups to 232")
    # the screened K3/K6/K10a/K10b/K4/K9: no spill, pass A on the tensor
    # cores (K6's d = 128 instances, the IVF build's, among them), and its
    # ungated d = 16 instances for k <= 256 within four CTAs' registers
    report["screen_build"] = screen_build(_build, logs["lloyd_assign"])
    check(len(report["screen_build"]) == 44,
          f"screen kernels in the SASS: {sorted(report['screen_build'])}")
    check(all(f"screen_kernel<{t}, 128, gated{c}>" in report["screen_build"]
              for t in ("fp32", "bf16") for c in ("", ", chunked")),
          "no d = 128 instance of K6's pass A")
    for t in ("fp32", "bf16"):
        regs = report["screen_build"][f"screen_kernel<{t}, 16>"]["registers"]
        check(regs <= 128, f"screen_kernel<{t}, 16>: {regs} registers, more "
                           "than four CTAs an SM hold")
    for fn, c in sorted(report["screen_build"].items()):
        check("registers" in c and "spill_bytes" in c,
              f"{fn}: no registers or spills in the ptxas log")
        print(f"screen {fn}: {c['registers']} registers, {c['spill_bytes']} "
              f"spill bytes; SASS: {c['HGMMA']} HGMMA")
        check(c["spill_bytes"] == 0, f"{fn} spills")
        check(c["HGMMA"] > 0 or fn.startswith("reduce"),
              f"{fn}: no HGMMA in its SASS")
    # the row passes, K5/K8, the super reduces and K14's part (a): no
    # spill
    report["split_build"] = split_build(_build, logs)
    check(len(report["split_build"]) == 68,
          f"row, seeding and ADC kernels in the SASS: "
          f"{sorted(report['split_build'])}")
    for fn, c in sorted(report["split_build"].items()):
        check("registers" in c and "spill_bytes" in c,
              f"{fn}: no registers or spills in the ptxas log")
        print(f"{fn}: {c['registers']} registers, {c['spill_bytes']} spill "
              f"bytes")
        check(c["spill_bytes"] == 0, f"{fn} spills")
    # K1's routes and the template entry, K11 and K12: no spill
    report["k1_build"] = k1_build(_build, logs)
    check(len(report["k1_build"]) == 17,
          f"K1, K11 and K12 kernels in the SASS: "
          f"{sorted(report['k1_build'])}")
    for fn, c in sorted(report["k1_build"].items()):
        check("registers" in c and "spill_bytes" in c,
              f"{fn}: no registers or spills in the ptxas log")
        print(f"{fn}: {c['registers']} registers, {c['spill_bytes']} spill "
              f"bytes")
        check(c["spill_bytes"] == 0, f"{fn} spills")
    # K16's decode and table kernels and its template entry's: no spill
    report["k16_build"] = k16_build(_build, logs["pq_decode"])
    check(len(report["k16_build"]) == 11,
          f"K16 kernels in the SASS: {sorted(report['k16_build'])}")
    for fn, c in sorted(report["k16_build"].items()):
        check("registers" in c and "spill_bytes" in c,
              f"{fn}: no registers or spills in the ptxas log")
        print(f"{fn}: {c['registers']} registers, {c['spill_bytes']} spill "
              f"bytes")
        check(c["spill_bytes"] == 0, f"{fn} spills")

    print(f"[{time.perf_counter() - t_start:.1f} s] phase 2")
    # 2. kernels against their plain twins
    wide = torch.rand((100_003, 128), generator=gen, device=dev)
    cases = {"K1": [], "K2": [], "K3": [], "K5": [], "K6": [], "K11": [],
             "K12": [], "K2 bf16": [], "K3 bf16": [], "K5 bf16": [],
             "K6 bf16": [], "K5 on K2's work": []}
    for pts, k_wide in ((paper, FULL.k), (wide, 64)):
        n, d = pts.shape
        norms = bounds.point_norms(pts)
        c = k1_case(torch, kd, bounds, pts)
        cases["K1"].append(c)
        print(k1_text(c))
        for m in (1, 8):
            for resident in (True, False):
                c = k2_case(torch, kd, ops, pts, norms, m, resident, gen)
                cases["K2"].append(c)
                print(f"K2 n={c['n']} d={c['d']} m={m} resident={resident}: "
                      f"err {c['max_abs_err']:.3g} (tol {c['tol']:.3g}) "
                      f"{c['ms']:.4f} ms, plain {c['plain_ms']:.4f} ms, "
                      f"bound {c['bound_ms']:.4f} ms ({c['bound_by']})")
        for kk in (k_wide, 1):
            c = k3_case(torch, la, ops, bounds, pts, norms, kk, gen)
            cases["K3"].append(c)
            print(f"K3 n={c['n']} d={c['d']} k={kk} tps={c['tps']}: "
                  f"err {c['max_abs_err']:.3g} (tol {c['tol']:.3g}) "
                  f"label diffs {c['label_diffs']}; {untiled_text(c)}, "
                  f"plain {c['plain_ms']:.4f} ms, bound {c['bound_ms']:.4f} "
                  f"ms ({c['bound_by']})" + screen_text(c))
        # the bf16 stream (precision="bf16"): the points rounded to bf16,
        # their norms the fp32 points'; K2 at m = 1, resident and not, K3
        pts16 = pts.bfloat16()
        for resident in (True, False):
            cases["K2 bf16"].append(k2_case(torch, kd, ops, pts16, norms, 1,
                                            resident, gen))
            print_bf16("K2", cases["K2 bf16"][-1])
        for kk in (k_wide, 1):
            cases["K3 bf16"].append(k3_case(torch, la, ops, bounds, pts16,
                                            norms, kk, gen))
            print_bf16("K3", cases["K3 bf16"][-1])
            print(f"  K3 bf16: {untiled_text(cases['K3 bf16'][-1])}")
        # the gated seeding round on a mid-seeding state: D² to 8 earlier
        # seeds; at the paper's shape on the label-sorted copy
        gpts = paper_sorted if pts is paper else pts
        bn = ops.choose_block_n(n, d, 50)
        cache = bounds.prologue(gpts, bn)
        rows = torch.randint(n, (16,), generator=gen, device=dev)
        md_in, _ = kd.distance_min_update_torch(
            gpts, cache.norms, gpts[rows[8:]].contiguous(),
            torch.full((n,), torch.inf, device=dev), block_n=bn)
        for m in (1, 8):
            cents = gpts[rows[:m]].contiguous()
            for resident in (True, False):
                for mask in ("gate", "all", "half", "none"):
                    c = k5_case(torch, kd, bounds, ops, gpts, cache, md_in,
                                cents, mask, resident)
                    cases["K5"].append(c)
                    print(f"K5 n={n} d={d} m={m} resident={resident} "
                          f"mask={mask}: {c['active_tiles']}/{c['tiles']} "
                          f"tiles active, {c['pruned']} rows pruned, err "
                          f"{c['max_abs_err']:.3g} (tol {c['tol']:.3g}), "
                          f"bitwise the template entry; {c['ms']:.4f} ms "
                          f"(again {c['ms_again']:.4f}; in place "
                          f"{c['inplace_ms']:.4f}; template entry "
                          f"{c['template_ms']:.4f} ms), plain "
                          f"{c['plain_ms']:.4f} ms, bound "
                          f"{c['bound_ms']:.4f} ms ({c['bound_by']})")
        # bf16: m = 1, the gate's mask and all active (bitwise bf16 K2),
        # resident, and the gate's mask not resident
        for resident, mask in ((True, "gate"), (True, "all"),
                               (False, "gate")):
            cases["K5 bf16"].append(k5_case(
                torch, kd, bounds, ops, gpts.bfloat16(), cache, md_in,
                gpts[rows[:1]].bfloat16(), mask, resident))
            print_bf16("K5", cases["K5 bf16"][-1])
            print(f"  K5 bf16 bitwise the template entry; template entry "
                  f"{cases['K5 bf16'][-1]['template_ms']:.4f} ms")
        # K5's row loop on K2's work at FULL (m = 1, both streams)
        for p_ in ((gpts, gpts.bfloat16()) if pts is paper else ()):
            cases["K5 on K2's work"].append(row_loop_beside_k2(
                torch, kd, bounds, p_, cache, p_[rows[:1]].contiguous(),
                bn))
        del md_in
        for kk in (k_wide, 1):
            cache = bounds.prologue(pts, ops.choose_block_n(n, d, kk))
            for c in k6_case(torch, la, bounds, ops, pts, cache, kk, gen):
                cases["K6"].append(c)
                print(f"K6 n={n} d={d} k={kk} mask={c['mask']} "
                      f"({c['route']} route): "
                      f"{c['active_tiles']}/{c['tiles']} tiles active, "
                      f"{c['pruned']} rows pruned, err "
                      f"{c['max_abs_err']:.3g} (tol {c['tol']:.3g}) label "
                      f"diffs {c['label_diffs']}, bitwise the template "
                      f"entry; {c['ms']:.4f} ms (template entry "
                      f"{c['template_ms']:.4f} ms), plain "
                      f"{c['plain_ms']:.4f} ms, bound {c['bound_ms']:.4f} ms "
                      f"({c['bound_by']})" + screen_text(c))
            # bf16: the centroid carry fp32, the kernel's centroids bf16
            for c in k6_case(torch, la, bounds, ops, pts16, cache, kk, gen):
                cases["K6 bf16"].append(c)
                print_bf16("K6", c)
                print(f"  K6 bf16 ({c['route']} route) bitwise the template "
                      f"entry; template entry {c['template_ms']:.4f} ms")
        del cache, pts16
        # the rejection kernels: K12 over K1's balls at the seeding tiles
        _, centers, radii, _ = kd.seed_prologue(pts, ops.choose_block_n(n, d,
                                                                        50))
        for name, c in zip(("K11", "K12"), rejection_kernel_cases(
                torch, kd, pts, centers, radii, gen)):
            cases[name].append(c)
            print(f"{name} n={n} d={d} P={c['p']}"
                  + (f" tiles={c['tiles']}" if name == "K12"
                     else f" A={c['a']}")
                  + f": bitwise the plain version at count 0, 1, P; "
                  f"{c['ms']:.4f} ms"
                  + (f" (one row {c['one_row_ms']:.4f} ms)" if name == "K11"
                     else f" the tile envelope ({c['tight']} tight at P; "
                     f"the caps alone {c['tile_cap_ms']:.4f} ms)")
                  + f", plain {c['plain_ms']:.4f} ms, bound "
                  f"{c['bound_ms']:.6f} ms ({c['bound_by']})")
        del centers, radii
    # K5 on rows too wide for 32 staged a block, read from device memory by
    # the wide path's threads: fp32 d = 1,024 and bf16 d = 2,048 on
    # 100,003 label-sorted rows (eight blobs), m = 1 and 8, the gate's
    # mask, resident and not, each bitwise and timed beside its template
    # entry
    cases["K5 wide"] = []
    nw = 100_003
    for dw, dtype in ((1024, torch.float32), (2048, torch.bfloat16)):
        centers = 3 * torch.randn((8, dw), generator=gen, device=dev)
        lab = torch.randint(8, (nw,), generator=gen, device=dev).sort().values
        xw = centers[lab] + torch.randn((nw, dw), generator=gen, device=dev)
        cache = bounds.prologue(xw, ops.choose_block_n(nw, dw, 50))
        rows = torch.randint(nw, (16,), generator=gen, device=dev)
        md_in, _ = kd.distance_min_update_torch(
            xw, cache.norms, xw[rows[8:]].contiguous(),
            torch.full((nw,), torch.inf, device=dev),
            block_n=ops.choose_block_n(nw, dw, 50))
        for m in (1, 8):
            for resident in (True, False):
                c = k5_case(torch, kd, bounds, ops, xw.to(dtype), cache,
                            md_in, xw[rows[:m]].to(dtype), "gate", resident)
                cases["K5 wide"].append(c)
                print(f"K5 {c['stream']} n={nw} d={dw} m={m} "
                      f"resident={resident} mask=gate: "
                      f"{c['active_tiles']}/{c['tiles']} tiles active, err "
                      f"{c['max_abs_err']:.3g} (tol {c['tol']:.3g}), "
                      f"bitwise the template entry; {c['ms']:.4f} ms "
                      f"(again {c['ms_again']:.4f}; in place "
                      f"{c['inplace_ms']:.4f}; template entry "
                      f"{c['template_ms']:.4f} ms), plain "
                      f"{c['plain_ms']:.4f} ms, bound {c['bound_ms']:.4f} "
                      f"ms ({c['bound_by']})")
        del xw, cache, md_in, centers, lab
    # K1 at the IVF build's shape (IVF_SIFT1M's 1M rows of d = 128 in
    # 4,096-row tiles of 2 MB: the lone route stages each tile's first rows
    # and reads the rest from device memory)
    xi = torch.rand((IVF.n_points, IVF.dim), generator=gen, device=dev)
    cases["K1"].append(k1_case(torch, kd, bounds, xi, ops.choose_block_n(
        IVF.n_points, IVF.dim, IVF.nlist)))
    print(k1_text(cases["K1"][-1]))
    del xi
    report["cases"] = cases
    del wide
    torch.cuda.empty_cache()

    print(f"[{time.perf_counter() - t_start:.1f} s] phase 2 (large k)")
    # 2 (large k). K3, K6, K4 and K10a past the old staging caps
    report["large_k"] = large_k_phase(torch, la, ops, bounds, dev, gen)
    torch.cuda.empty_cache()

    print(f"[{time.perf_counter() - t_start:.1f} s] phase 2 (refused)")
    # 2 (refused). the shapes the template's staging refused, through the
    # engine
    report["refused"] = refused_phase(torch, ops, kd, la, bounds,
                                      ClusterEngine, Draws, dev, gen)
    torch.cuda.empty_cache()

    print(f"[{time.perf_counter() - t_start:.1f} s] phase 3")
    # 3. the main path: gated (the default) on shuffled and sorted blobs,
    #    then the ungated path, each counted on its own
    eng = ClusterEngine(device="cuda")
    ungated = ClusterEngine(device="cuda", bounds=False)
    fused = ClusterEngine("fused", device="cuda", bounds=False)
    launches = {name: 0 for name in ops.LAUNCHES}
    runs = []
    for layout, pts in (("shuffled", paper), ("sorted", paper_sorted)):
        for sampler in ("cdf", "tiled"):
            draws = Draws.sample(pts.shape[0], k,
                                 generator=torch.Generator().manual_seed(0),
                                 device=dev)
            res, total_s, got = kmeans_run(torch, ops, eng, pts, k, sampler,
                                           draws)
            for name in launches:
                launches[name] += got[name]
            what = f"gated kmeans[{sampler}, {layout}]"
            check(got["seed_prologue"] == 1
                  and got["distance_min_update_gated"] == k
                  and got["lloyd_assign_gated"] == res.n_iters
                  and got["distance_min_update"] == 0
                  and got["lloyd_assign_tiled"] == 0,
                  f"{what}: launches {got}, want K1 1, K5 {k}, K6 "
                  f"{res.n_iters}, K2/K3 0")
            check(tuple(res.centroids.shape) == (k, FULL.dim)
                  and bool(torch.isfinite(res.centroids).all())
                  and bool(torch.isfinite(res.inertia))
                  and int(res.assignment.min()) >= 0
                  and int(res.assignment.max()) < k,
                  f"{what}: output malformed")
            off, off_s, off_got = kmeans_run(torch, ops, ungated, pts, k,
                                             sampler, draws)
            check(off_got["distance_min_update"] == k
                  and off_got["lloyd_assign_tiled"] == off.n_iters
                  and off_got["seed_prologue"] == 0
                  and off_got["distance_min_update_gated"] == 0
                  and off_got["lloyd_assign_gated"] == 0,
                  f"ungated kmeans[{sampler}, {layout}]: launches {off_got}")
            for name in ("distance_min_update", "lloyd_assign_tiled"):
                launches[name] += off_got[name]
            check(same_fit(torch, res, off),
                  f"{what}: not bitwise the bounds=False kmeans")
            seeds, fit, seed_ms, lloyd_ms = phase_ms(torch, eng, pts, k,
                                                     sampler, draws)
            oseeds, ofit, oseed_ms, olloyd_ms = phase_ms(
                torch, ungated, pts, k, sampler, draws)
            check(torch.equal(seeds.indices, oseeds.indices)
                  and torch.equal(seeds.min_d2, oseeds.min_d2)
                  and same_fit(torch, fit, ofit) and same_fit(torch, fit, res),
                  f"{what}: seed/fit not bitwise the ungated ones")
            check(int(seeds.recovered.sum()) == 0
                  and int(fit.recovered.sum()) == 0,
                  f"{what}: a guard healed a round")
            run = dict(layout=layout, sampler=sampler, n_iters=res.n_iters,
                       inertia=float(res.inertia), kmeans_s=total_s,
                       ungated_kmeans_s=off_s, seed_ms=seed_ms,
                       lloyd_ms_per_iter=lloyd_ms, ungated_seed_ms=oseed_ms,
                       ungated_lloyd_ms_per_iter=olloyd_ms, launches=got,
                       seed_skipped=int(seeds.skipped.sum()),
                       seed_pruned=int(seeds.pruned.sum()),
                       fit_skipped=int(res.skipped.sum()),
                       fit_pruned=int(res.pruned.sum()),
                       bitwise_ungated=True)
            if layout == "sorted":
                check(run["seed_skipped"] + run["fit_skipped"] > 0,
                      f"{what}: nothing skipped on sorted blobs")
            again, _, _ = kmeans_run(torch, ops, eng, pts, k, sampler, draws)
            check(same_fit(torch, again, res), f"{what}: two runs differ")
            run["repeat_bitwise"] = True
            if layout == "shuffled":
                # the plain twins from the same draws, ungated
                fseeds = fused.seed(pts, k, draws=draws, sampler=sampler)
                fres = fused.kmeans(pts, k, draws=draws, sampler=sampler,
                                    max_iters=FULL.max_iters)
                same = int((fseeds.indices == seeds.indices).sum())
                rel = abs(float(fres.inertia) - float(res.inertia)) / float(
                    res.inertia)
                if same < k:
                    # diverged seeds make a different fit: compare the
                    # Lloyd phase from the kernels' own seeds instead
                    fres = fused.fit(pts, seeds.centroids,
                                     max_iters=FULL.max_iters)
                    rel = abs(float(fres.inertia) - float(fit.inertia)) \
                        / float(fit.inertia)
                # 1e-4: both fits take the same Lloyd steps; they differ
                # only in the fp32 summation order of partials and sums
                check(rel <= 1e-4,
                      f"{sampler}: fused inertia differs by {rel:.3g}")
                run.update(fused_seed_matches=same, inertia_rel_diff=rel)
            runs.append(run)
            print(f"kmeans[{sampler}, {layout}]: gated {total_s:.3f} s, "
                  f"ungated {off_s:.3f} s end to end (bitwise equal); "
                  f"seeding {seed_ms:.2f} ms gated / {oseed_ms:.2f} ms "
                  f"ungated, Lloyd {lloyd_ms:.3f} / {olloyd_ms:.3f} ms/iter; "
                  f"n_iters {res.n_iters}, inertia {run['inertia']:.6g}; "
                  f"seeding skipped {run['seed_skipped']} tiles, pruned "
                  f"{run['seed_pruned']} rows; Lloyd skipped "
                  f"{run['fit_skipped']} tiles, pruned {run['fit_pruned']} "
                  f"rows; launches {got}"
                  + (f"; fused: {run['fused_seed_matches']}/{k} seeds "
                     f"match, inertia rel diff {run['inertia_rel_diff']:.3g}"
                     if layout == "shuffled" else ""))
    report["main_path"] = runs
    print(f"[{time.perf_counter() - t_start:.1f} s] phase 3 (bf16)")
    report["main_path_bf16"] = bf16_main_path(torch, ops, ClusterEngine,
                                              Draws, paper, FULL, dev,
                                              launches)

    print(f"[{time.perf_counter() - t_start:.1f} s] phase 3 (robustness)")
    # 3 (robustness). the fault matrix, checkpointed seed and fit, and the
    #    pipeline faults at the paper's shape, label-sorted
    report["robustness"] = robustness_phase(
        torch, ops, kd, bounds, sampling, ClusterEngine, Draws, paper_sorted,
        FULL, dev, launches)
    torch.cuda.empty_cache()

    print(f"[{time.perf_counter() - t_start:.1f} s] phase 4")
    # 4. rejection seeding at the paper's size: both layouts, both proposals
    rej_runs = rejection_phase(
        torch, ops, kd, bounds, telemetry, Draws, eng, ungated,
        (("shuffled", paper), ("sorted", paper_sorted)), k, dev, launches)
    report["rejection"] = rej_runs

    print(f"[{time.perf_counter() - t_start:.1f} s] phase 5")
    # 5. batched problems: the PQ codebook sweep, bounds off
    del paper_sorted
    torch.cuda.empty_cache()
    kvq_pts = blobs_batched(KVQ.batch, KVQ.n_points, KVQ.dim, KVQ.k,
                            generator=torch.Generator(device=dev)
                            .manual_seed(0))
    bcases, brun = batched_phase(torch, ops, kd, la, bounds, ClusterEngine,
                                 Draws, kvq_pts, KVQ, dev, launches, gen)
    cases.update(bcases)
    report["batched"] = brun

    print(f"[{time.perf_counter() - t_start:.1f} s] phase 6")
    # 6. gated batched problems (bounds on, the default): the same sweep,
    #    and 16 problems of 4 blobs each with rows sorted by blob, so each
    #    tile holds one blob and the tile gate skips
    kvq_sorted = blobs_batched(16, KVQ.n_points, KVQ.dim, 4, sort=True,
                               generator=torch.Generator(device=dev)
                               .manual_seed(1))
    gcases, grun = gated_batched_phase(
        torch, ops, kd, la, bounds, ClusterEngine, Draws,
        (("shuffled", kvq_pts), ("sorted", kvq_sorted)), KVQ, dev, launches,
        gen)
    cases.update(gcases)
    report["gated_batched"] = grun
    print(f"[{time.perf_counter() - t_start:.1f} s] phase 6 (rejection)")
    # 6 (rejection). batched rejection seeding at the sweep: the listed K7
    #    and K8, the batched K11 and K12, then kmeans_batched
    rcases, rrun = batched_rejection_phase(
        torch, ops, kd, bounds, sampling, ClusterEngine, CudaBackend, Draws,
        (("shuffled", kvq_pts), ("sorted", kvq_sorted)), KVQ, dev, launches,
        gen)
    cases.update(rcases)
    report["batched_rejection"] = rrun
    del kvq_sorted
    torch.cuda.empty_cache()
    print(f"[{time.perf_counter() - t_start:.1f} s] phase 6 (screen)")
    # 6 (screen). K10a/K10b's screened route on adversarial problems, and
    #    K10b at the IVF build's PQ sweep shape
    report["screen"], ivf_case = screen_phase(
        torch, ops, kd, la, bounds, blobs_batched, dev, gen)
    cases["K10b ivf"] = [ivf_case]

    print(f"[{time.perf_counter() - t_start:.1f} s] phase 7")
    # 7. weighted and mini-batch Lloyd at the paper's shape (K4), and K9 at
    #    the codebook sweep's; the weights are integer multiplicities 1-8
    wts = torch.randint(1, 9, (FULL.n_points,), generator=gen,
                        device=dev).float()
    wcases, wrun = weighted_phase(torch, ops, kd, la, bounds, ClusterEngine,
                                  Draws, paper, paper_np, wts, kvq_pts, FULL,
                                  KVQ, dev, launches, gen)
    cases.update(wcases)
    report["weighted"] = wrun
    print(f"[{time.perf_counter() - t_start:.1f} s] phase 7 (bf16)")
    report["bf16_entry_points"] = bf16_entry_points(
        torch, ops, bounds, ClusterEngine, Draws, paper, paper_np, wts,
        kvq_pts, FULL, KVQ, dev, launches)

    print(f"[{time.perf_counter() - t_start:.1f} s] phase 8")
    # 8. IVF serving and KV-cache PQ at IVF_SIFT1M's shape, and order= at
    #    the paper's
    # (the KV cache is gemma2_2b's: 26 layers, 4 kv heads, head_dim 256, at
    #  the codebook sweep's 16,384 tokens)
    icases, irun, kv_dense, kv_pq = ivf_phase(
        torch, ops, bounds, telemetry, ClusterEngine, Draws, IVF, paper,
        FULL, dev, launches, args.profile,
        (GEMMA2["layers"], GEMMA2["kv_heads"], GEMMA2["head_dim"],
         KVQ.n_points), args.ivf_data)
    cases.update(icases)
    report["ivf"] = irun

    print(f"[{time.perf_counter() - t_start:.1f} s] phase 9")
    # 9. gemma2-2b attention: a decode step over phase 8's PQ cache (K16)
    #    and prefill over the full context (K15)
    acases, arun = attention_phase(torch, ops, kv_dense, kv_pq, dev,
                                   launches, args.profile)
    del kv_dense, kv_pq
    cases.update(acases)
    report["attention"] = arun

    print(f"[{time.perf_counter() - t_start:.1f} s] phase 10 (init)")
    # 10 (init). the other training paths: the gumbel sampler, k-means||,
    #     the three inits, serial mode and SemDeDup
    icases, report["init"] = init_phase(
        torch, ops, kd, la, bounds, sampling, ClusterEngine, Draws, paper,
        kvq_pts, FULL, KVQ, dev, launches, gen)
    for name, got in icases.items():
        cases.setdefault(name, []).extend(got)
    report["launches"] = launches
    report["seconds"] = time.perf_counter() - t_start
    print(f"[{report['seconds']:.1f} s] phases 0-10 done")

    if args.profile:
        report["profile"] = {}
        paper_sorted = torch.from_numpy(
            paper_np[np.argsort(labels, kind="stable")]).to(dev)
        bseeds = ungated.seed_batched(
            kvq_pts, KVQ.k, generator=torch.Generator().manual_seed(0))
        phases = {f"batched seed[{s}]": (
            lambda s=s: ungated.seed_batched(
                kvq_pts, KVQ.k, sampler=s,
                generator=torch.Generator().manual_seed(0)))
            for s in ("cdf", "tiled")}
        phases["batched fit"] = (lambda: ungated.fit_batched(
            kvq_pts, bseeds.centroids, max_iters=KVQ.max_iters))
        for s in ("cdf", "tiled"):
            phases[f"gated batched seed[{s}]"] = (
                lambda s=s: eng.seed_batched(
                    kvq_pts, KVQ.k, sampler=s,
                    generator=torch.Generator().manual_seed(0)))
        phases["gated batched fit"] = (lambda: eng.fit_batched(
            kvq_pts, bseeds.centroids, max_iters=KVQ.max_iters))
        for tag, e, pts in (("ungated", ungated, paper),
                            ("gated", eng, paper),
                            ("gated sorted", eng, paper_sorted)):
            seeds = e.seed(pts, k, generator=torch.Generator().manual_seed(0))
            for s in ("cdf", "tiled"):
                phases[f"{tag} seed[{s}]"] = (
                    lambda s=s, e=e, pts=pts: e.seed(
                        pts, k, generator=torch.Generator().manual_seed(0),
                        sampler=s))
            for prop in ("hier", "flat"):
                phases[f"{tag} seed[rejection {prop}]"] = (
                    lambda prop=prop, e=e, pts=pts: e.seed(
                        pts, k, generator=torch.Generator().manual_seed(0),
                        sampler="rejection", proposal=prop))
            phases[f"{tag} fit"] = (lambda e=e, pts=pts, c=seeds.centroids:
                                    e.fit(pts, c, max_iters=FULL.max_iters))
        wdraws = Draws.sample(FULL.n_points, k, weighted=True, device=dev,
                              generator=torch.Generator().manual_seed(0))
        wseeds = eng.seed(paper, k, weights=wts, draws=wdraws)
        for s in ("cdf", "tiled"):
            phases[f"weighted seed[{s}]"] = (
                lambda s=s: eng.seed(paper, k, weights=wts, draws=wdraws,
                                     sampler=s))
        phases["weighted fit"] = (lambda: eng.fit(
            paper, wseeds.centroids, weights=wts, max_iters=FULL.max_iters))
        phases["fit_minibatch (16 batches)"] = (lambda: eng.fit_minibatch(
            wseeds.centroids, lambda i: paper_np[i * 262_144:
                                                 (i + 1) * 262_144],
            n_batches=-(-FULL.n_points // 262_144)))
        # the bf16 stream: one cast of the points per call, none per round
        e16 = ClusterEngine(device="cuda", precision="bf16")
        s16 = e16.seed(paper, k, generator=torch.Generator().manual_seed(0))
        phases["bf16 gated seed[cdf]"] = (lambda: e16.seed(
            paper, k, generator=torch.Generator().manual_seed(0)))
        phases["bf16 gated fit"] = (lambda: e16.fit(
            paper, s16.centroids, max_iters=FULL.max_iters))
        for name, fn in phases.items():
            fn()                                   # warm
            p = profile_call(torch, fn)
            report["profile"][name] = p
            print_profile(name, p)

    def main_case(name, pick):
        return next(c for c in cases[name]
                    if c["n"] == FULL.n_points and pick(c))

    def entry(fn, src, replaces, case, errs):
        # the error over the cases at the shape the main path gives it
        return {"name": fn, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{src}",
                "replaces": replaces, "launches": launches[fn],
                "max_abs_err": max(c["max_abs_err"] for c in cases[errs]
                                   if c["n"] == case["n"]),
                "ms": case["ms"], "plain_ms": case["plain_ms"],
                "bound_ms": case["bound_ms"], "bound_by": case["bound_by"],
                "library_ms": None}

    record = {"kernels": [
        entry("seed_prologue", "seed_prologue.cu",
              "src/repro/kernels/kmeans_distance.py:405",
              main_case("K1", lambda c: True), "K1"),
        entry("distance_min_update", "kmeans_distance.cu",
              "src/repro/kernels/kmeans_distance.py:99",
              main_case("K2", lambda c: c["m"] == 1 and c["resident"]), "K2"),
        entry("lloyd_assign_tiled", "lloyd_assign.cu",
              "src/repro/kernels/lloyd_assign.py:324",
              main_case("K3", lambda c: c["k"] == FULL.k), "K3"),
        entry("distance_min_update_gated", "kmeans_distance.cu",
              "src/repro/kernels/kmeans_distance.py:192",
              main_case("K5", lambda c: c["m"] == 1 and c["resident"]
                        and c["mask"] == "gate"), "K5"),
        entry("lloyd_assign_gated", "lloyd_assign.cu",
              "src/repro/kernels/lloyd_assign.py:416",
              main_case("K6", lambda c: c["k"] == FULL.k
                        and c["mask"] == "gate"), "K6"),
        entry("row_min_d2", "rejection.cu",
              "src/repro/kernels/kmeans_distance.py:293",
              main_case("K11", lambda c: True), "K11"),
        entry("tile_cap", "rejection.cu",
              "src/repro/kernels/kmeans_distance.py:351",
              main_case("K12", lambda c: True), "K12"),
        entry("distance_min_update_batched", "kmeans_distance.cu",
              "src/repro/kernels/kmeans_distance.py:466",
              next(c for c in cases["K7"] if c["m"] == 1), "K7"),
        entry("lloyd_assign_tiled_batched", "lloyd_assign.cu",
              "src/repro/kernels/lloyd_assign.py:530", cases["K10a"][0],
              "K10a"),
        entry("seed_prologue_batched", "seed_prologue.cu",
              "src/repro/kernels/kmeans_distance.py:405", cases["K1b"][0],
              "K1b"),
        entry("distance_min_update_gated_batched", "kmeans_distance.cu",
              "src/repro/kernels/kmeans_distance.py:540",
              next(c for c in cases["K8"]
                   if c["m"] == 1 and c["mask"] == "gate"), "K8"),
        entry("lloyd_assign_gated_batched", "lloyd_assign.cu",
              "src/repro/kernels/lloyd_assign.py:609",
              next(c for c in cases["K10b"] if c["mask"] == "gate"), "K10b"),
        entry("lloyd_assign", "lloyd_assign.cu",
              "src/repro/kernels/lloyd_assign.py:98",
              main_case("K4", lambda c: c["k"] == FULL.k and c["weighted"]),
              "K4"),
        entry("lloyd_assign_batched", "lloyd_assign.cu",
              "src/repro/kernels/lloyd_assign.py:184", cases["K9"][0], "K9"),
        entry("ivf_scan", "ivf_scan.cu", "src/repro/kernels/ivf_scan.py:122",
              cases["K13"][0], "K13"),
        entry("ivf_adc_scan", "ivf_scan.cu",
              "src/repro/kernels/ivf_scan.py:249", cases["K14"][0], "K14"),
        entry("pq_decode_attention", "pq_decode.cu",
              "src/repro/kernels/pq_decode.py:89", cases["K16"][0], "K16"),
        # the rounds' bf16 instances (precision="bf16"): the same template
        # on the bf16 stream, each in the shape and case its fp32 one is
        *(entry(f"{fn}_bf16", src, replaces, case, errs) for fn, src,
          replaces, case, errs in (
            ("distance_min_update", "kmeans_distance.cu",
             "src/repro/kernels/kmeans_distance.py:99",
             main_case("K2 bf16", lambda c: c["resident"]), "K2 bf16"),
            ("lloyd_assign_tiled", "lloyd_assign.cu",
             "src/repro/kernels/lloyd_assign.py:324",
             main_case("K3 bf16", lambda c: c["k"] == FULL.k), "K3 bf16"),
            ("distance_min_update_gated", "kmeans_distance.cu",
             "src/repro/kernels/kmeans_distance.py:192",
             main_case("K5 bf16", lambda c: c["resident"]
                       and c["mask"] == "gate"), "K5 bf16"),
            ("lloyd_assign_gated", "lloyd_assign.cu",
             "src/repro/kernels/lloyd_assign.py:416",
             main_case("K6 bf16", lambda c: c["k"] == FULL.k
                       and c["mask"] == "gate"), "K6 bf16"),
            ("distance_min_update_batched", "kmeans_distance.cu",
             "src/repro/kernels/kmeans_distance.py:466",
             cases["K7 bf16"][0], "K7 bf16"),
            ("lloyd_assign_tiled_batched", "lloyd_assign.cu",
             "src/repro/kernels/lloyd_assign.py:530",
             cases["K10a bf16"][0], "K10a bf16"),
            ("distance_min_update_gated_batched", "kmeans_distance.cu",
             "src/repro/kernels/kmeans_distance.py:540",
             next(c for c in cases["K8 bf16"] if c["mask"] == "gate"),
             "K8 bf16"),
            ("lloyd_assign_gated_batched", "lloyd_assign.cu",
             "src/repro/kernels/lloyd_assign.py:609",
             cases["K10b bf16"][0], "K10b bf16"),
            ("lloyd_assign", "lloyd_assign.cu",
             "src/repro/kernels/lloyd_assign.py:98",
             main_case("K4 bf16", lambda c: c["weighted"]), "K4 bf16"),
            ("lloyd_assign_batched", "lloyd_assign.cu",
             "src/repro/kernels/lloyd_assign.py:184", cases["K9 bf16"][0],
             "K9 bf16"))),
        # K15's two kernels, each with its error over its dtype's runs and
        # its yardstick, SDPA at cap 0 in the same dtype
        *(dict(entry(fn, "flash_attention.cu",
                     "src/repro/kernels/flash_attention.py:87",
                     cases["K15"][i], "K15"),
               max_abs_err=max(c["max_abs_err"] for c in cases["K15"]
                               if c["dtype"] == dt),
               library_ms=cases["K15"][i]["library_ms"])
          for fn, i, dt in (("flash_attention", 0, "float32"),
                            ("flash_attention_bf16", 1, "bfloat16"))),
    ]}
    check(all(e["launches"] > 0 for e in record["kernels"]),
          "kernels the run never launched: "
          + ", ".join(e["name"] for e in record["kernels"]
                      if not e["launches"]))
    report.update(record)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(report, indent=1))
    print(f"card: {card_line()}")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
